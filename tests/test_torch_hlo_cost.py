"""The port's counting layer (``repro_torch.dist.hlo_cost`` /
``hlo_analysis``, ``obs.mfu.lowered_flops``) against the reference.

The reference's HLO walker undercounts live HLO under jax 0.9.0 (it misses
the dots: ``tests/test_dist.py``'s two HLO-cost cases fail), so the port's
flops are held against XLA's own ``cost_analysis()`` of the same function
in jax.  Collective wire bytes are held against the reference's walker on
its own HLO test module (``tests/test_calibrate.py::_HLO``), which it
counts right.  Bytes are the eager program's (inputs + outputs of every op
that is not free), not XLA's at fusion boundaries: they are checked by
hand.  Every fake process group is destroyed before its test returns.
"""
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol

from repro.dist import hlo_analysis as ref_analysis
from repro.dist.hlo_cost import analyze_hlo
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.dist import hlo_analysis, hlo_cost
from repro_torch.dist.hlo_analysis import CollectiveOp, collective_bytes
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.transformer import RunCtx, init_params
from repro_torch.obs.mfu import lowered_flops
from repro_torch.optim.optimizers import sgdm_init, sgdm_update
from repro_torch.train.step import make_train_step

ROOT = Path(__file__).resolve().parents[1]
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _xla_cost(fn, *arrays):
    ca = jax.jit(fn).lower(*arrays).compile().cost_analysis()
    return ca[0] if isinstance(ca, (list, tuple)) else ca


def test_loop_free_count_matches_xla():
    """sum(tanh(x @ w1) @ w2): both dots, the reduce, the tanh."""
    x, w1, w2 = _inputs(0, (64, 128), (128, 256), (256, 32))
    ca = _xla_cost(lambda a, b, c: jnp.sum(jnp.tanh(a @ b) @ c), x, w1, w2)
    got = hlo_cost.analyze(lambda a, b, c: torch.sum(torch.tanh(a @ b) @ c),
                           *map(torch.from_numpy, (x, w1, w2)))
    assert ca["flops"] == 5_244_927
    assert got["flops"] == pytest.approx(ca["flops"], rel=0.05)
    assert got["flops"] == 2 * 64 * 256 * 128 + 2 * 64 * 32 * 256 + 2047
    assert got["transcendentals"] == ca["transcendentals"] == 64 * 256
    assert got["collective_bytes"] == 0


def test_loop_counts_every_trip():
    """A Python loop of 10 tanh(x @ w[i]): 10 x one body, within 2 % of
    XLA's count of the unrolled jax function."""
    x, w = _inputs(1, (16, 32), (10, 32, 32))

    def jfn(a, b):
        for i in range(10):
            a = jnp.tanh(a @ b[i])
        return a

    def tfn(a, b):
        for i in range(10):
            a = torch.tanh(a @ b[i])
        return a

    ca = _xla_cost(jfn, x, w)
    got = hlo_cost.analyze(tfn, torch.from_numpy(x), torch.from_numpy(w))
    one = hlo_cost.analyze(lambda a, b: torch.tanh(a @ b),
                           torch.from_numpy(x), torch.from_numpy(w[0]))
    assert got["flops"] == 10 * one["flops"] == 10 * 2 * 16 * 32 * 32
    assert got["transcendentals"] == 10 * one["transcendentals"]
    assert got["bytes"] == 10 * one["bytes"]
    assert got["flops"] == pytest.approx(ca["flops"], rel=0.02)
    assert got["transcendentals"] == pytest.approx(ca["transcendentals"],
                                                   rel=0.02)


def test_bytes_by_hand():
    """(x + y).t() @ y, summed: inputs + outputs of each op, the view
    free."""
    x, y = map(torch.from_numpy, _inputs(2, (4, 8), (4, 8)))
    prog = hlo_cost.record(lambda a, b: torch.sum((a + b).t() @ b), x, y)
    got = hlo_cost.analyze(prog)
    add = 3 * 4 * 8 * 4                 # read x, y; write a
    mm = (8 * 4 + 4 * 8) * 4 + 8 * 8 * 4
    red = 8 * 8 * 4 + 4
    assert got["bytes"] == add + mm + red
    assert got["flops"] == 32 + 2 * 8 * 8 * 4 + 63
    assert [op.name for op in prog.ops] == [
        "aten.add.Tensor", "aten.t.default", "aten.mm.default",
        "aten.sum.default"]
    assert prog.ops[1].bytes == 0 and not prog.unknown
    # the caller's tensors are untouched and nothing escaped the fake mode
    assert torch.equal(x, torch.from_numpy(_inputs(2, (4, 8))[0]))
    assert prog.argument_bytes == 2 * 128 and prog.output_bytes == 4


@pytest.mark.parametrize("kind", KINDS)
def test_collective_factors_match_reference(kind):
    for d in range(1, 9):
        for b in (0.0, 4.0, 1000.0, 6e6):
            assert (CollectiveOp(kind, b, d).wire_bytes
                    == ref_analysis.CollectiveOp(kind, b, d).wire_bytes)


def _reference_hlo():
    spec = importlib.util.spec_from_file_location(
        "reference_calibrate_tests", ROOT / "tests" / "test_calibrate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._HLO


def test_looped_all_reduce_matches_reference_hlo():
    """Five all-reduces of f32[1000] on four ranks, as the reference's HLO
    test module's while loop: 30 000 wire bytes, five collectives."""
    want = analyze_hlo(_reference_hlo())["collective_bytes"]

    def five(x):
        for _ in range(5):
            dist.all_reduce(x)
        return x

    with hlo_cost.fake_world(4):
        prog = hlo_cost.record(five, torch.zeros(1000))
    coll = collective_bytes(prog)
    assert want == 30_000
    assert hlo_cost.analyze(prog)["collective_bytes"] == want
    assert coll["all-reduce"] == coll["total"] == want
    assert coll["count"] == 5


def test_gather_and_scatter_conventions():
    """All-gather bills the gathered output, reduce-scatter the output
    shard, all-reduce the tensor: c10d and functional forms alike."""
    def prog_fn(x, shard):
        out = torch.empty(1000)
        dist.all_gather_into_tensor(out, shard)
        part = torch.empty(250)
        dist.reduce_scatter_tensor(part, x)
        g = funcol.all_gather_tensor(shard, 0, dist.group.WORLD)
        r = funcol.reduce_scatter_tensor(x, "sum", 0, dist.group.WORLD)
        a = funcol.all_reduce(x, "sum", dist.group.WORLD)
        return out, part, g + 0, r + 0, a + 0

    with hlo_cost.fake_world(4):
        prog = hlo_cost.record(prog_fn, torch.zeros(1000), torch.zeros(250))
    got = [op.collective for op in prog.ops if op.collective is not None]
    want = [CollectiveOp("all-gather", 4000.0, 4),
            CollectiveOp("reduce-scatter", 1000.0, 4),
            CollectiveOp("all-gather", 4000.0, 4),
            CollectiveOp("reduce-scatter", 1000.0, 4),
            CollectiveOp("all-reduce", 4000.0, 4)]
    assert got == want
    ref = [ref_analysis.CollectiveOp(c.kind, c.bytes, c.group_size)
           for c in want]
    assert [c.wire_bytes for c in got] == [c.wire_bytes for c in ref] == [
        3000.0, 3000.0, 3000.0, 3000.0, 6000.0]
    coll = collective_bytes(prog)
    assert coll["count"] == 5 and coll["total"] == 18_000.0


def test_roofline_h100_constants_and_reference_bottleneck():
    assert (hlo_analysis.PEAK_FLOPS, hlo_analysis.HBM_BYTES_PER_S,
            hlo_analysis.ICI_BYTES_PER_S) == (989e12, 3.35e12, 450e9)
    r = hlo_analysis.roofline(989e12, 3.35e12, 0.0)
    assert r["compute_s"] == pytest.approx(1.0)
    assert r["memory_s"] == pytest.approx(1.0)
    fs = ref_analysis.PEAK_FLOPS / hlo_analysis.PEAK_FLOPS
    bs = ref_analysis.HBM_BYTES_PER_S / hlo_analysis.HBM_BYTES_PER_S
    ws = ref_analysis.ICI_BYTES_PER_S / hlo_analysis.ICI_BYTES_PER_S
    rng = np.random.default_rng(3)
    for f, b, w in 10.0 ** rng.uniform(6, 15, size=(50, 3)):
        mine = hlo_analysis.roofline(f, b, w)
        ref = ref_analysis.roofline(f * fs, b * bs, w * ws)
        assert mine["bottleneck"] == ref["bottleneck"]
        assert mine["step_s"] == pytest.approx(ref["step_s"], rel=1e-12)
    assert (hlo_analysis.model_flops(10, 7.0, "train")
            == ref_analysis.model_flops(10, 7.0, "train"))


def test_column_sharded_linear_bills_a_quarter():
    """F.linear with its weight's output dim over ``model`` on a (1, 4)
    mesh: rank 0 runs a quarter of the global product, nothing else."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    glob = hlo_cost.analyze(torch.nn.functional.linear, torch.zeros(8, 64),
                            torch.zeros(128, 64))["flops"]
    with hlo_cost.fake_world(4):
        mesh = make_test_mesh((1, 4), device="cpu")
        mode = hlo_cost.fake_mode()
        with mode:
            x = distribute_tensor(torch.zeros(8, 64), mesh,
                                  [Replicate(), Replicate()],
                                  src_data_rank=None)
            w = distribute_tensor(torch.zeros(128, 64), mesh,
                                  [Replicate(), Shard(0)],
                                  src_data_rank=None)
        prog = hlo_cost.record(torch.nn.functional.linear, x, w)
    got = hlo_cost.analyze(prog)
    assert glob == 2 * 8 * 64 * 128
    assert got["flops"] == glob / 4
    assert got["collective_bytes"] == 0
    assert prog.argument_bytes == (8 * 64 + 32 * 64) * 4


def test_megatron_step_bills_per_rank():
    """Reduced qwen1.5-0.5b's train step, megatron on (1, 4) against the
    same step without a mesh: rank 0 bills between a quarter and half of
    the unsharded flops (the replicated norms, embedding and loss pieces
    keep it above a quarter)."""
    cfg = get_config("qwen1.5-0.5b").reduced()
    shape = InputShape("t", 32, 4, "train")
    with hlo_cost.fake_world(4):
        mesh = make_test_mesh((1, 4), device="cpu")
        sharded = hlo_cost.analyze(dryrun.record_step(cfg, shape, mesh))

    mode = hlo_cost.fake_mode()
    ctx = RunCtx(device="cpu", param_dtype=torch.bfloat16,
                 compute_dtype=torch.bfloat16, chunk_q=512, chunk_k=512,
                 loss_chunk=32)
    params = hlo_cost.fake_cpu(init_params(None, cfg, dtype=torch.bfloat16,
                                           device="meta"), mode)
    with mode:
        opt = sgdm_init(params)
        batch = {"tokens": torch.zeros((4, 32), dtype=torch.int32),
                 "labels": torch.zeros((4, 32), dtype=torch.int32),
                 "sample_weights": torch.full((4,), 0.25)}
    step = make_train_step(
        cfg, ctx, lambda g, s, p, lr: sgdm_update(g, s, p, lr=lr,
                                                  momentum=0.9),
        lambda t: 1e-3)
    whole = hlo_cost.analyze(step, params, opt, batch, 0)
    ratio = sharded["flops"] / whole["flops"]
    print(f"megatron (1, 4) / unsharded flops: {ratio:.4f}")
    assert 0.25 <= ratio <= 0.5
    assert sharded["collective_bytes"] > 0 == whole["collective_bytes"]


def test_lowered_flops():
    """The reference's ``test_lowered_flops_matches_hlo_cost_walker``
    function; None on a host read of a value."""
    a, b = torch.zeros(64, 128), torch.zeros(128, 32)
    got = lowered_flops(lambda x, y: x @ y, a, b)
    assert got == hlo_cost.analyze(lambda x, y: x @ y, a, b)["flops"]
    assert got >= 2 * 64 * 128 * 32
    ca = _xla_cost(lambda x, y: x @ y, np.zeros((64, 128), np.float32),
                   np.zeros((128, 32), np.float32))
    assert got == ca["flops"]
    assert lowered_flops(lambda x: x * float(x.sum()), a) is None
    assert not dist.is_initialized()


def test_unknown_ops_are_charged_bytes_and_named():
    prog = hlo_cost.record(lambda x: torch.special.i0(x), torch.zeros(10))
    assert prog.unknown == {"aten.i0.default"}
    op = prog.ops[-1]
    assert op.flops == 0 and op.bytes == 80
    assert math.isclose(hlo_cost.analyze(prog)["bytes"], 80)


@pytest.mark.parametrize("fn,flops,trans", [
    (lambda x: torch.softmax(x, -1), 4 * 32 - 2 * 4, 32),
    (lambda x: torch.log_softmax(x, -1), 4 * 32 - 2 * 4, 32 + 4),
    (lambda x: torch.logsumexp(x, -1), 3 * 32 - 4, 32 + 4),
    (lambda x: x.mean(-1), 32, 0),
    (lambda x: torch.nn.functional.silu(x), 32, 32),
    (lambda x: torch.zeros(4).index_add_(0, torch.zeros(8, dtype=torch.long),
                                         x[0]), 8, 0),
], ids=["softmax", "log_softmax", "logsumexp", "mean", "silu", "index_add"])
def test_composite_rules_by_hand(fn, flops, trans):
    """Fused ops billed as the parts the reference's HLO would show, on a
    (4, 8) input."""
    got = hlo_cost.analyze(fn, torch.zeros(4, 8))
    assert (got["flops"], got["transcendentals"]) == (flops, trans)
