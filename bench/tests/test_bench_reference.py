"""The plain reference agrees with the port's plain path at the port's
``.reduced()`` sizes on the CPU: one compressed and one dense DDP step
(loss, the optimizer's momentum, the new parameters), and one prefill plus
decode steps of the MoE model (logits at every position)."""
import copy

import pytest
import torch

from bench import checks, harness, program
from bench import weights as W
from bench.reference.model import Decoder, tf32_round
from bench.reference.train import ddp_steps


def reduced(name: str) -> dict:
    """The configuration file of ``name`` at the port's ``.reduced()``
    sizes."""
    from repro_torch.configs import get_config
    cfg = copy.deepcopy(harness.load_json(
        harness.BENCH / "configs" / f"{name}.json"))
    r = get_config(name).reduced()
    size = {"hidden_size": r.d_model, "num_attention_heads": r.num_heads,
            "num_key_value_heads": r.num_kv_heads,
            "head_dim": r.resolved_head_dim, "intermediate_size": r.d_ff,
            "num_hidden_layers": r.num_layers, "vocab_size": r.vocab_size}
    cfg.update(size)
    if r.moe:
        cfg["num_local_experts"] = r.moe.num_experts
        cfg["program"]["moe"]["group_size"] = r.moe.group_size
    cfg["program"]["run_ctx"] = {"loss_chunk": 16, "chunk_q": 16,
                                 "chunk_k": 16}
    return cfg


def _batches(cfg, b=4, s=32, n=1, seed=0):
    g = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        rows = torch.randint(0, cfg["vocab_size"], (b, s + 1), generator=g)
        out.append((rows[:, :-1].contiguous(), rows[:, 1:].contiguous()))
    return out


@pytest.mark.parametrize("step", ["compressed", "dense"])
def test_one_ddp_step_matches_the_port(step):
    from repro_torch.optim import optimizers
    from repro_torch.train import ddp
    cfg = reduced("qwen2-0.5b")
    dev = torch.device("cpu")
    weights = W.make(cfg, 3, dev)
    program.check_params(cfg, weights)
    dense, comp, k, n = ddp.make_ddp_steps(
        program.model_config(cfg), program.run_ctx(cfg, dev),
        lambda g, s, p, lr: optimizers.sgdm_update(g, s, p, lr=lr,
                                                   momentum=0.9),
        lambda i: 0.05, 0.1, weights)
    tokens, labels = _batches(cfg)[0]
    fn = comp if step == "compressed" else dense
    p, s, m = fn(weights, optimizers.sgdm_init(weights),
                 {"tokens": tokens, "labels": labels}, torch.ones(1), 0)
    ref = ddp_steps(cfg, W.make(cfg, 3, dev), [(tokens, labels)], lr=0.05,
                    momentum=0.9, cr=0.1 if step == "compressed" else None,
                    n_steps=1)
    assert ref["k"] == (k if step == "compressed" else None)
    assert abs(float(m["loss"]) - ref["loss"][0]) <= 1e-5 * ref["loss"][0]
    got = checks.leaf_norms(s["mom"])
    assert checks.norm_gap(got, ref["first_grad"]) < 1e-5
    moved = checks.leaf_norms(_sub(p, W.make(cfg, 3, dev)))
    assert checks.norm_gap(moved, ref["change"]) < 1e-5


def _sub(a, b):
    return {k: _sub(a[k], b[k]) if isinstance(a[k], dict) else a[k] - b[k]
            for k in a}


def test_prefill_and_decode_with_moe_match_the_port():
    from repro_torch.models.decode import (decode_step, init_cache,
                                           prefill_cache)
    cfg = reduced("mixtral-8x22b")
    dev = torch.device("cpu")
    weights = W.make(cfg, 4, dev)
    mc, ctx = program.model_config(cfg), program.run_ctx(cfg, dev)
    prompt = torch.randint(0, cfg["vocab_size"], (1, 24),
                           generator=torch.Generator().manual_seed(1))
    logits, cache = prefill_cache(weights, prompt, init_cache(mc, 1, 40, ctx),
                                  mc, ctx)
    got, seq = [logits[0]], prompt
    for _ in range(6):
        nxt = got[-1].argmax()[None, None]
        seq = torch.cat([seq, nxt], dim=1)
        logits, cache = decode_step(weights, cache, nxt, mc, ctx)
        got.append(logits[0])
    ref = Decoder(cfg, W.make(cfg, 4, dev)).logits(seq)[0, 23:]
    torch.testing.assert_close(torch.stack(got), ref, rtol=0, atol=2e-4)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      1.0 + 2 ** -12, -3.14159265])
    y = tf32_round(x)
    assert y[0] == 1.0 and y[1] == 1.0          # a tie: to even
    assert y[2] == 1.0 + 4 * 2 ** -11           # a tie: to even, upward
    assert y[3] == 1.0
    assert (y.view(torch.int32) & 0x1FFF).eq(0).all()
    assert abs(float(y[4]) + 3.14159265) < 2 ** -10 * 4


def test_flipped_near_ties_take_the_next_expert():
    cfg = reduced("mixtral-8x22b")
    weights = W.make(cfg, 4, torch.device("cpu"))
    seq = torch.randint(0, cfg["vocab_size"], (1, 12),
                        generator=torch.Generator().manual_seed(2))
    k = cfg["num_experts_per_tok"]
    runs = {}
    for below in (None, 0.0, float("inf")):
        model = Decoder(cfg, weights, flip_below=below)
        model.hidden(seq)
        runs[below] = model
    plain, everywhere = runs[None], runs[float("inf")]
    # the first layer sees the same rows: the same logits, the k-th choice
    # replaced by the next one on every row
    assert torch.equal(plain.router_logits[0], everywhere.router_logits[0])
    order = torch.topk(plain.router_logits[0], k + 1, dim=-1).indices
    assert torch.equal(everywhere.routes[0][:, :-1], order[:, :k - 1])
    assert torch.equal(everywhere.routes[0][:, -1], order[:, -1])
    assert torch.equal(runs[0.0].routes[0], plain.routes[0])
