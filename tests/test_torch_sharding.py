"""The port's sharding rules (``repro_torch/dist/sharding.py``) and input
stand-ins (``repro_torch/launch/specs.py``) against the reference's, on the
CPU, with no process group.

Every assigned config at full size, on stand-in meshes that carry only axis
names and sizes (as ``tests/test_dist.py`` tables the reference's rules):
(16, 16) ("data", "model"), (2, 16, 16) ("pod", "data", "model"), (2, 4)
("data", "model") and (8,) ("data",).  The reference's trees come from
``jax.eval_shape``, the port's from ``meta`` tensors; both are flattened
to {path: spec} and compared entry by entry (param specs, batch specs over
``train_batch_specs`` with the sequence sharded and not, cache specs over
``decode_inputs`` at the decode and long-context shapes).  ``attn_mode_for``
and ``make_run_ctx``'s fields must agree too; ``named``'s placements are
checked by hand.  Equality is exact: the rules are tables.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import ASSIGNED_ARCHS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_shape as jax_get_shape  # noqa: E402
from repro.dist import sharding as jsh  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import get_config, get_shape  # noqa: E402
from repro_torch.dist import sharding as tsh  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.models import RunCtx, init_params  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "8": ((8,), ("data",))}
DTYPES = {jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.int32): torch.int32}


class JaxStandIn:
    """The reference's mesh stand-in: ``axis_names`` and a ``shape`` map."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.shape = dict(zip(names, shape))


class TorchStandIn:
    """The port's: ``mesh_dim_names`` and ``shape``, as a DeviceMesh has."""

    def __init__(self, shape, names):
        self.mesh_dim_names = names
        self.shape = tuple(shape)
        self.ndim = len(shape)


def _plans(mesh):
    shape, names = MESHES[mesh]
    return (jsh.make_plan(JaxStandIn(shape, names)),
            tsh.make_plan(TorchStandIn(shape, names)))


def _flat_jax(tree, leaf_type=None):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=None if leaf_type is None
        else lambda x: isinstance(x, leaf_type))
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            leaf for path, leaf in flat}


def _flat_torch(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_torch(v, path + (str(k),)))
        return out
    return {path: tree}


def _same_specs(jtree, ttree):
    js, ts = _flat_jax(jtree, JP), _flat_torch(ttree)
    assert sorted(js) == sorted(ts)
    for path, spec in js.items():
        assert isinstance(ts[path], tsh.PartitionSpec), path
        assert tuple(ts[path]) == tuple(spec), (path, ts[path], spec)
    return len(js)


def _same_leaves(jtree, ttree):
    """Shapes and dtypes of ShapeDtypeStructs against meta tensors."""
    js, ts = (_flat_jax(jtree, jax.ShapeDtypeStruct), _flat_torch(ttree))
    assert sorted(js) == sorted(ts)
    for path, s in js.items():
        t = ts[path]
        assert t.device.type == "meta", path
        assert tuple(t.shape) == tuple(s.shape), path
        assert t.dtype == DTYPES[jnp.dtype(s.dtype)], path


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    cfg = jax_get_config(arch)
    return jax.eval_shape(lambda k: jtf.init_params(k, cfg),
                          jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _torch_params(arch):
    return init_params(None, get_config(arch), device="meta")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_specs_match_reference(arch, mesh):
    jplan, tplan = _plans(mesh)
    jspec = jsh.param_specs(_jax_params(arch), jax_get_config(arch), jplan)
    tspec = tsh.param_specs(_torch_params(arch), get_config(arch), tplan)
    assert _same_specs(jspec, tspec) > 0


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_batch_and_cache_specs_match_reference(arch, mesh):
    """Batch specs over ``train_batch_specs`` (train and prefill shapes,
    the sequence sharded over tp and not) and cache specs over
    ``decode_inputs`` (the decode shape, and the long-context shape on its
    sliding-window pattern)."""
    jplan, tplan = _plans(mesh)
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    for shape in ("train_4k", "prefill_32k"):
        jb = jspecs.train_batch_specs(jcfg, jax_get_shape(shape))
        tb = tspecs.train_batch_specs(tcfg, get_shape(shape))
        _same_leaves(jb, tb)
        for seq in (False, True):
            _same_specs(jsh.batch_specs(jcfg, jplan, jb, seq_sharded=seq),
                        tsh.batch_specs(tcfg, tplan, tb, seq_sharded=seq))
    for shape, long_ctx in (("decode_32k", False), ("long_500k", True)):
        jt, jc = jspecs.decode_inputs(jcfg, jax_get_shape(shape),
                                      jtf.RunCtx(), long_ctx)
        tt, tc = tspecs.decode_inputs(tcfg, get_shape(shape), RunCtx(),
                                      long_ctx)
        _same_leaves(jt, tt)
        _same_leaves(jc, tc)
        _same_specs(jsh.cache_specs(jcfg, jplan, jc),
                    tsh.cache_specs(tcfg, tplan, tc))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_attn_mode_and_run_ctx_match_reference(mesh):
    """``attn_mode_for`` for every config, and ``make_run_ctx``'s fields
    (its dtypes bf16 by default and f32 when asked, as the reference's)."""
    jplan, tplan = _plans(mesh)
    for arch in ASSIGNED_ARCHS:
        jcfg, tcfg = jax_get_config(arch), get_config(arch)
        assert tsh.attn_mode_for(tcfg, tplan) == jsh.attn_mode_for(jcfg,
                                                                    jplan)
        for f32 in (False, True):
            kw = dict(remat=False, chunk_q=64, chunk_k=128, loss_chunk=256)
            jd = dict(compute_dtype=jnp.float32, param_dtype=jnp.float32)
            td = dict(compute_dtype=torch.float32, param_dtype=torch.float32)
            jc = jsh.make_run_ctx(jcfg, jplan, **kw, **(jd if f32 else {}))
            tc = tsh.make_run_ctx(tcfg, tplan, **kw, **(td if f32 else {}))
            for field in ("tp_axis", "dp_axes", "attn_mode", "seq_sharded",
                          "chunk_q", "chunk_k", "remat", "loss_chunk"):
                assert getattr(tc, field) == getattr(jc, field), field
            for field in ("param_dtype", "compute_dtype"):
                assert getattr(tc, field) == DTYPES[jnp.dtype(
                    getattr(jc, field))], field
            assert tc.mesh is tplan.mesh and tc.device == "cuda"


def test_named_placements_by_hand():
    """A tuple entry shards one dim over both of its mesh dims, in the
    mesh's order; an axis that does not divide is dropped by the rules and
    that dim replicated; a stacked leaf keeps its layer axis whole."""
    from torch.distributed.tensor import Replicate, Shard
    _, plan = _plans("2x16x16")
    mesh = plan.mesh
    cfg = get_config("qwen2-0.5b")
    params = _torch_params("qwen2-0.5b")
    specs = tsh.param_specs(params, cfg, plan)
    named = tsh.named(params, specs, mesh)
    # embed (151 936, 896): vocab over ("pod", "data"), 896 over "model"
    assert specs["embed"] == tsh.P(("pod", "data"), "model")
    assert named["embed"].placements == (Shard(0), Shard(0), Shard(1))
    # stacked wk (24, 896, 128): the layer axis whole; 896 % 32 == 0 over
    # ("pod", "data"), 128 % 16 == 0 over "model"
    wk = named["unit"]["p0"]["attn"]["wk"]
    assert wk.spec == tsh.P(None, ("pod", "data"), "model")
    assert wk.placements == (Shard(1), Shard(1), Shard(2))
    # norm scales replicated everywhere
    assert named["final_norm"]["scale"].placements == (Replicate(),) * 3
    # a dropped axis: an embedding of 31 rows does not divide over "data"
    _, plan24 = _plans("2x4")
    emb = tsh.param_specs({"embed": torch.empty((31, 8), device="meta")},
                          cfg, plan24)["embed"]
    assert emb == tsh.P(None, "model")
    assert tsh.placements_of(plan24.mesh, emb) == (Replicate(), Shard(1))
    with pytest.raises(ValueError, match="order"):
        tsh.placements_of(mesh, tsh.P(("data", "pod")))
    with pytest.raises(ValueError, match="shards two dims"):
        tsh.placements_of(mesh, tsh.P("model", "model"))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "whisper-base",
                                  "qwen2-vl-2b", "xlstm-125m"])
def test_concretize_matches_reference(arch):
    """``concretize`` of the reduced stand-ins: the reference's values,
    shapes and dtypes (ints 0, floats 0.01), on the device asked for."""
    jcfg, tcfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    shape = dataclasses.replace(get_shape("train_4k"), seq_len=16,
                                global_batch=2)
    jshape = dataclasses.replace(jax_get_shape("train_4k"), seq_len=16,
                                 global_batch=2)
    jb = jspecs.concretize(jspecs.train_batch_specs(jcfg, jshape))
    tb = tspecs.concretize(tspecs.train_batch_specs(tcfg, shape),
                           device="cpu")
    _, jc = jspecs.decode_inputs(jcfg, jshape, jtf.RunCtx(), False)
    _, tc = tspecs.decode_inputs(tcfg, shape, RunCtx(device="cpu"), False)
    for jt, tt in ((jb, tb), (jspecs.concretize(jc),
                              tspecs.concretize(tc, device="cpu"))):
        js, ts = _flat_jax(jt), _flat_torch(tt)
        assert sorted(js) == sorted(ts)
        for path, a in js.items():
            t = ts[path]
            assert t.device.type == "cpu"
            assert t.dtype == DTYPES[jnp.dtype(a.dtype)], path
            np.testing.assert_array_equal(t.float().numpy(),
                                          np.asarray(a, np.float32),
                                          err_msg=str(path))
