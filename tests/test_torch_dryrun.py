"""``repro_torch.launch.dryrun`` and ``sweep`` against the reference's.

``pick_n_micro`` and ``_ctx_knobs`` are carried over unchanged: equal for
every assigned config x input shape x production mesh, on stand-in plans
as ``tests/test_torch_sharding.py`` builds them.  The recording itself runs
in a subprocess (its fake process group is process-wide): reduced
qwen1.5-0.5b on a (2, 2) mesh of four fake ranks, train, prefill and
decode, through ``record_step`` and ``write_artifact``, the two halves of
``run_one``; each artifact must carry the
reference's keys (``xla_flops_raw`` renamed ``flop_counter_raw``,
``xla_bytes_raw`` dropped).  The reference's module sets ``XLA_FLAGS`` for
512 host devices when imported, so it is imported inside the test with the
environment restored after.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS
from repro.configs import get_config as jax_get_config
from repro.configs import get_shape as jax_get_shape
from repro.dist import sharding as jsh
from repro_torch.configs import get_config, get_shape
from repro_torch.dist import hlo_cost
from repro_torch.dist import sharding as tsh
from repro_torch.launch import dryrun, sweep
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.decode import _write_step

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")

# the keys of the reference's artifact (src/repro/launch/dryrun.py:
# analyse + run_one), less the two XLA raw counts
REFERENCE_KEYS = {
    "arch", "shape", "mesh", "chips", "attn_mode", "flops_per_chip",
    "bytes_per_chip", "collective", "memory", "roofline",
    "model_flops_per_chip", "useful_flops_ratio", "params_total",
    "params_active", "n_micro", "grad_wire_bf16", "compile_s"}


class JaxStandIn:
    def __init__(self, shape, names):
        self.axis_names = names
        self.shape = dict(zip(names, shape))


class TorchStandIn:
    def __init__(self, shape, names):
        self.mesh_dim_names = names
        self.shape = tuple(shape)


def _reference_dryrun():
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref


@pytest.mark.parametrize("mesh", list(MESHES))
def test_n_micro_and_ctx_knobs_match_reference(mesh):
    ref = _reference_dryrun()
    shape, names = MESHES[mesh]
    jplan = jsh.make_plan(JaxStandIn(shape, names))
    tplan = tsh.make_plan(TorchStandIn(shape, names))
    for arch in ASSIGNED_ARCHS:
        for name in SHAPES:
            jc, tc = jax_get_config(arch), get_config(arch)
            js, ts = jax_get_shape(name), get_shape(name)
            assert (dryrun.pick_n_micro(tc, ts, tplan)
                    == ref.pick_n_micro(jc, js, jplan)), (arch, name)
            assert (dryrun._ctx_knobs(tc, ts, tplan)
                    == ref._ctx_knobs(jc, js, jplan)), (arch, name)


_SCRIPT = r"""
import json, sys, time
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.dist import hlo_cost
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh

hlo_cost.init_fake_world(4)
mesh = make_test_mesh((2, 2), device="cpu")
cfg = get_config("qwen1.5-0.5b").reduced()
recs = []
for name, kind in (("t32", "train"), ("p32", "prefill"), ("d32", "decode")):
    t0 = time.time()
    shape = InputShape(name, 32, 4, kind)
    program = dryrun.record_step(cfg, shape, mesh)
    recs.append(dryrun.write_artifact(cfg, shape, mesh, program,
                                      "qwen1.5-0.5b", name, sys.argv[1], t0,
                                      save_hlo=(kind == "train")))
print(json.dumps(recs))
"""


def test_run_writes_reference_artifacts(tmp_path):
    r = subprocess.run([sys.executable, "-c", _SCRIPT, str(tmp_path)],
                       capture_output=True, text=True, timeout=300,
                       cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(
                           ROOT / "src")))
    assert r.returncode == 0, r.stderr[-3000:]
    train, prefill, decode = json.loads(r.stdout.strip().splitlines()[-1])
    for rec, name in ((train, "t32"), (prefill, "p32"), (decode, "d32")):
        assert REFERENCE_KEYS | {"flop_counter_raw"} <= set(rec), name
        assert not {"xla_flops_raw", "xla_bytes_raw"} & set(rec)
        assert rec["mesh"] == "2x2" and rec["chips"] == 4
        assert rec["attn_mode"] == "megatron"
        assert rec["flops_per_chip"] > 0 and rec["bytes_per_chip"] > 0
        assert rec["unknown_ops"] == []
        assert rec["collective"]["total_looped"] == rec["collective"]["total"]
        assert rec["roofline"]["bottleneck"] in (
            "compute", "memory", "collective")
        assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                      "peak_bytes_est"}
        assert (rec["memory"]["peak_bytes_est"]
                >= rec["memory"]["argument_bytes"])
        saved = tmp_path / f"qwen1.5-0.5b__{name}__2x2.json"
        assert json.loads(saved.read_text()) == rec
    coll = train["collective"]
    assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0
    assert train["n_micro"] == 1 and train["grad_wire_bf16"] is False
    ops = (tmp_path / "qwen1.5-0.5b__t32__2x2.ops.txt").read_text()
    assert len(ops.splitlines()) == train["n_ops"]
    assert "aten.mm.default" in ops


def test_sweep_cached_and_failing_paths(tmp_path, monkeypatch):
    monkeypatch.chdir(ROOT)
    cached = tmp_path / "qwen2-0.5b__train_4k__16x16.json"
    cached.write_text("{}")
    assert sweep.run_combo("qwen2-0.5b", "train_4k", False,
                           str(tmp_path)) == (
        "qwen2-0.5b__train_4k__16x16", "cached", 0.0)
    tag, status, _ = sweep.run_combo("no-such-arch", "train_4k", True,
                                     str(tmp_path), timeout=120)
    assert tag == "no-such-arch__train_4k__2x16x16"
    assert status.startswith("FAIL: ") and "no-such-arch" in status
    assert "KeyError" in (tmp_path / (tag + ".err.txt")).read_text()
    from repro.launch import sweep as ref_sweep
    assert (sweep.ARCHS, sweep.SHAPES) == (ref_sweep.ARCHS, ref_sweep.SHAPES)
    assert set(sweep.ARCHS) == set(ASSIGNED_ARCHS)


@pytest.mark.parametrize("slot", [1, 6])
def test_sharded_cache_write_lands_on_the_owning_rank(slot):
    """Decode's cache write on a cache whose sequence is split over
    ``model`` of a (1, 2) mesh, as the dry run places it: each rank's shard
    equals its slice of the unsharded write (real tensors; no collective
    runs)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    rng = np.random.default_rng(slot)
    full = torch.from_numpy(rng.standard_normal((2, 8, 2, 4)).astype(
        np.float32))
    x = torch.from_numpy(rng.standard_normal((2, 1, 2, 4)).astype(
        np.float32))
    want = full.clone()
    _write_step(want, torch.tensor(slot), x)
    assert torch.equal(want[:, slot], x[:, 0])
    for rank in (0, 1):
        with hlo_cost.fake_world(2, rank):
            mesh = make_test_mesh((1, 2), device="cpu")
            buf = distribute_tensor(full.clone(), mesh,
                                    [Replicate(), Shard(1)],
                                    src_data_rank=None)
            xd = distribute_tensor(x, mesh, [Replicate(), Replicate()],
                                   src_data_rank=None)
            _write_step(buf, torch.tensor(slot), xd)
            assert torch.equal(buf.to_local(),
                               want[:, 4 * rank:4 * (rank + 1)])


# one reduced combination of each class of geometry that DTensor's rules
# refused before the port ran those programs on local shards (ROADMAP.md
# §3), on a (4, 4) mesh of 16 fake ranks: (arch, config fields replaced,
# shape, long-context pattern, n_micro)
CLASSES = {
    "A_microbatch_split": ("qwen1.5-0.5b", {}, (16, 8, "train"), False, 2),
    "B_gqa_decode": ("internlm2-20b", {"num_heads": 12, "num_kv_heads": 2},
                     (64, 8, "decode"), False, 0),
    "C_batch1_decode": ("qwen2-0.5b", {"num_kv_heads": 4},
                        (128, 1, "decode"), True, 0),
    "D_mrope_prefill": ("qwen2-vl-2b", {}, (16, 4, "prefill"), False, 0),
    "E_xlstm_heads": ("xlstm-125m", {"num_heads": 2, "head_dim": 128},
                      (64, 4, "decode"), False, 0),
}

_CLASS_SCRIPT = r"""
import dataclasses, json, sys, time
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.dist import hlo_cost
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh

hlo_cost.init_fake_world(16)
mesh = make_test_mesh((4, 4), device="cpu")
recs = {}
for name, (arch, repl, (s, b, kind), long_ctx, n_micro) in json.loads(
        sys.argv[2]).items():
    t0 = time.time()
    cfg = dataclasses.replace(get_config(arch).reduced(), **repl)
    shape = InputShape(name, s, b, kind)
    program = dryrun.record_step(cfg, shape, mesh, long_ctx, n_micro)
    recs[name] = dryrun.write_artifact(cfg, shape, mesh, program, arch, name,
                                       sys.argv[1], t0,
                                       n_micro_override=n_micro)
print(json.dumps(recs))
"""


@pytest.fixture(scope="module")
def class_records(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun_classes")
    r = subprocess.run([sys.executable, "-c", _CLASS_SCRIPT, str(tmp),
                        json.dumps(CLASSES)], capture_output=True, text=True,
                       timeout=300, cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert r.returncode == 0, r.stderr[-3000:]
    return tmp, json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", list(CLASSES))
def test_repaired_geometry_records(class_records, name):
    """Each class's reduced geometry records on 16 fake ranks: a complete
    artifact with the reference's keys, every op counted, flops above 0,
    and the train step at its ``n_micro``."""
    tmp, recs = class_records
    rec = recs[name]
    arch = CLASSES[name][0]
    assert REFERENCE_KEYS | {"flop_counter_raw"} <= set(rec)
    assert rec["mesh"] == "4x4" and rec["chips"] == 16
    assert rec["unknown_ops"] == []
    assert rec["flops_per_chip"] > 0 and rec["bytes_per_chip"] > 0
    assert rec["n_micro"] == (CLASSES[name][4] or 1)
    assert json.loads((tmp / f"{arch}__{name}__4x4.json").read_text()) == rec
