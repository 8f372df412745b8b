"""``bench/flops.py`` against a count by hand at a tiny size, and never
above the port's own count of the program it runs
(``dist/hlo_cost``, which counts every op and the recomputation)."""

import torch

from bench import flops, harness, program
from bench import weights as W
from bench.tests.tiny import tiny_config


def _cfg(name):
    return tiny_config(harness.load_json(
        harness.BENCH / "configs" / f"{name}.json"))


def test_dense_by_hand():
    cfg = _cfg("qwen2-0.5b")
    # d 64, h 4, kv 2, hd 32, ff 96, L 2, V 256
    attn = 64 * 128 + 2 * 64 * 64 + 128 * 64
    mlp = 3 * 64 * 96
    assert flops.layer_weights(cfg) == attn + mlp
    s = 5
    keys = 1 + 2 + 3 + 4 + 5
    fwd = 2 * (2 * (attn + mlp) * s + 4 * 4 * 32 * keys) + 2 * 64 * 256 * s
    assert flops.forward(cfg, s) == fwd
    assert flops.train_step(cfg, 3, s) == 3 * 3 * fwd
    assert flops.prefill(cfg, s) == fwd - 2 * 64 * 256 * (s - 1)
    assert flops.decode_token(cfg, 7) == 2 * (2 * (attn + mlp)
                                              + 4 * 4 * 32 * 7) + 2 * 64 * 256


def test_moe_and_window_by_hand():
    cfg = _cfg("mixtral-8x22b")
    cfg["sliding_window"] = 3
    attn = 64 * 128 + 2 * 64 * 64 + 128 * 64
    assert flops.layer_weights(cfg) == attn + 2 * 3 * 64 * 96 + 64 * 8
    assert [flops.context(cfg, i) for i in range(5)] == [1, 2, 3, 3, 3]


def test_never_above_the_programs_count():
    from repro_torch.dist.hlo_cost import analyze, record
    from repro_torch.models.decode import init_cache, prefill_cache
    from repro_torch.train.step import make_loss_fn, value_and_grad
    cfg = _cfg("qwen2-0.5b")
    dev = torch.device("cpu")
    weights = W.make(cfg, 0, dev)
    mc, ctx = program.model_config(cfg), program.run_ctx(cfg, dev)
    tokens = torch.randint(0, 256, (2, 16))
    batch = {"tokens": tokens, "labels": tokens}
    counted = analyze(record(value_and_grad, make_loss_fn(mc, ctx), weights,
                             batch))["flops"]
    assert flops.train_step(cfg, 2, 16) <= counted

    moe = _cfg("mixtral-8x22b")
    weights = W.make(moe, 0, dev)
    mc, ctx = program.model_config(moe), program.run_ctx(moe, dev)
    counted = analyze(record(prefill_cache, weights, tokens[:1],
                             init_cache(mc, 1, 32, ctx), mc, ctx))["flops"]
    assert flops.prefill(moe, 16) <= counted
