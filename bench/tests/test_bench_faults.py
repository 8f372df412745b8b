"""A run driven without the card at a tiny size, the timed path broken
underneath, comes out not correct; the same run unbroken comes out
correct.  Faults a one-card cell can have: a training step that returns its
state unchanged; half of the batch left out, the mean taken over the rest;
a served token altered where it is produced.  (No cell spans cards, so the
exchange between them cannot be left out.)  The control, the reference in
TF32 put in the program's place, fails each cell's limits too."""
import pytest
import torch

from bench import checks, harness
from bench import weights as W
from bench.reference.model import Decoder
from bench.reference.serve import token_gaps
from bench.tests.tiny import tiny_cell

TRAIN_CELLS = ["qwen2-0.5b.ddp_topk", "qwen2-0.5b.ddp_dense"]
SERVE_CELLS = ["mixtral-8x22b.serve_decode"]


def _run(cell, trace=0, **kw):
    bm, spec = tiny_cell(cell, trace=trace, **kw)
    return harness.run_cell(bm, spec)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", TRAIN_CELLS + SERVE_CELLS)
def test_sound_run_is_correct(cell, trace):
    result = _run(cell, trace)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) >= ({"setup_s"} if not trace else set())
    if trace:
        assert "busy_s" in result["device"] and "breakdown" in result


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_state_left_unchanged_is_not_correct(cell, monkeypatch):
    from repro_torch.optim import optimizers
    monkeypatch.setattr(optimizers, "sgdm_update",
                        lambda g, s, p, **kw: (p, s))
    result = _run(cell)
    assert not result["correct"]
    assert result["checks"]["change_norm_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_half_the_batch_is_not_correct(cell, monkeypatch):
    from repro_torch.train import ddp
    shard = ddp._shard

    def half(batch, rank, size):
        out = shard(batch, rank, size)
        return {k: v[: v.shape[0] // 2] for k, v in out.items()}

    monkeypatch.setattr(ddp, "_shard", half)
    result = _run(cell)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_an_altered_token_is_not_correct(cell, monkeypatch):
    from repro_torch.serve.engine import SlotRunner
    sample = SlotRunner._sample

    def altered(self, logits):
        out = sample(self, logits)
        out[0] = (out[0] + 1) % logits.shape[-1]
        return out

    monkeypatch.setattr(SlotRunner, "_sample", altered)
    result = _run(cell)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_the_control_fails_the_training_limits(cell):
    from bench.drivers import train_ddp
    bm, spec = tiny_cell(cell)
    ref = train_ddp.reference_readings(spec)
    ctl = train_ddp.reference_readings(spec, precision="tf32")
    judged = checks.judged(checks.compare_train(ctl, ref), spec.wl["limits"])
    assert not checks.passed(judged), judged


def test_the_control_fails_the_serving_limits():
    bm, spec = tiny_cell(SERVE_CELLS[0])
    cfg = spec.cfg
    weights = W.make(cfg, 0, torch.device("cpu"))
    ref = Decoder(cfg, weights)
    gen = torch.Generator().manual_seed(0)
    served = []
    with torch.no_grad():
        for _ in range(3):
            seq = torch.randint(0, cfg["vocab_size"], (20,), generator=gen)
            chosen = []
            for _ in range(10):
                last = ref.logits(seq[None])[0, -1]
                chosen.append(last.max())
                seq = torch.cat([seq, last.argmax()[None]])
            served.append((seq[:20], seq[20:], torch.stack(chosen)))
    read = token_gaps(cfg, weights, served, control="tf32")
    assert read["gap"] <= spec.wl["limits"]["token_gap"] / 10, read
    assert read["control_gap"] > spec.wl["limits"]["token_gap"], read
