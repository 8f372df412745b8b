"""The port's sharded programs at the geometries where DTensor's rules used
to refuse them, against the reference on four CPU devices.

Each case replaces the config fields that set its geometry the same way in
both packages (reduced configs, f32, remat off, chunks of 16):

* ``A_micro`` — a microbatch split of a data-sharded batch: qwen1.5-0.5b,
  batch 8 at ``n_micro`` 2 on a (4, 1) mesh (two rows a rank: the global
  split would put the shard on the 2-long microbatch dim);
* ``B_gqa`` — decode with q head-sharded and KV heads that do not divide
  the model axis: qwen2-0.5b with heads 6, kv 3, head_dim 64 on (2, 2);
  the sequence-sharded cache decodes on local shards and merges by the
  log-sum-exp;
* ``C_batch1`` — batch 1 under the data axis (the vocab-sharded
  embedding's partial sum): qwen2-0.5b's long-context pattern (SWA rings
  of 64, a 70-token prompt that wraps them) at b 1 on (2, 2);
* ``D_mrope`` — qwen2-vl-2b's train step on (2, 2) (patch embeddings and
  M-RoPE positions from numpy); ``mrope_angles`` itself on fake tensors;
* ``E_xlstm`` — xLSTM heads that do not divide the model axis:
  xlstm-125m with 2 heads of 128 on (1, 4), a train step and decode.

Serving cases prefill without a mesh in both packages, then decode greedy
steps with params and cache placed by ``cache_specs``/``param_specs``
(the reference under ``jax.jit`` with those in and out shardings); the
port also prefills on the mesh (``prefill_cache`` on DTensors), held
against its own unsharded prefill.  Train cases take one momentum-SGD
step, as ``tests/test_torch_sharded_step.py``.  Bars: params within 2e-4,
the loss within 1e-5 rel + 1e-6, the gradient within 1e-5 of its leaf's
largest |g| + 1e-7, decode logits within 1e-5 and greedy tokens equal.

The log-sum-exp combine alone: ``decode_attention`` on caches sharded over
2 and 4 sequence chunks (the plain version's lse on each rank's chunk,
merged across ranks) against ``decode_attention`` over the whole cache
within 1e-6, with a slot at kv_len 0 (every chunk empty: the reference's
uniform average of all S keys), one whose length ends inside the first
chunk, one across chunks and a full ring.

One reference subprocess (``XLA_FLAGS=--xla_force_host_platform_device_
count=4``) and one launch of four gloo ranks (a ``FileStore``) serve the
whole file.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.attention import decode_attention  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LR = 1e-2
# name -> (arch, fields replaced in both packages, mesh, kind, knobs)
CASES = {
    "A_micro": ("qwen1.5-0.5b", {}, (4, 1), "train",
                {"batch": 8, "seq": 32, "n_micro": 2}),
    "B_gqa": ("qwen2-0.5b", {"num_heads": 6, "num_kv_heads": 3,
                             "head_dim": 64}, (2, 2), "serve",
              {"batch": 4, "prompt": 20, "cache": 64, "gen": 3,
               "long": False}),
    "C_batch1": ("qwen2-0.5b", {}, (2, 2), "serve",
                 {"batch": 1, "prompt": 70, "cache": 128, "gen": 3,
                  "long": True}),
    "D_mrope": ("qwen2-vl-2b", {}, (2, 2), "train",
                {"batch": 4, "seq": 32, "n_micro": 1}),
    "E_xlstm": ("xlstm-125m", {"num_heads": 2, "head_dim": 128}, (1, 4),
                "train", {"batch": 4, "seq": 32, "n_micro": 1}),
    "E_xlstm_decode": ("xlstm-125m", {"num_heads": 2, "head_dim": 128},
                       (1, 4), "serve",
                       {"batch": 4, "prompt": 16, "cache": 32, "gen": 3,
                        "long": False}),
}
TRAIN = [n for n, c in CASES.items() if c[3] == "train"]
SERVE = [n for n, c in CASES.items() if c[3] == "serve"]
NOISY = ("'bq'", "'bk'", "'bv'", "'scale'")
# the combine alone: (mesh, b, S, h, kv, hd) and the per-slot kv_len
COMBINE = {"2_chunks": ((2, 2), 4, 64, 4, 2, 16),
           "4_chunks": ((1, 4), 4, 64, 4, 2, 16)}
COMBINE_LENS = [0, 5, 40, 64 + 7]

_COMMON = r"""
import dataclasses, json, sys
import numpy as np

def config(get_config, arch, repl):
    return dataclasses.replace(get_config(arch).reduced(), **repl)

def nest(flat):
    tree = {"rest": {}}                  # the stack plan's empty remainder
    for path, a in flat.items():
        node = tree
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = a
    return tree

def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out

CASES = json.loads(%(cases)r)
LR = %(lr)r
"""

_JAX_SCRIPT = _COMMON + r"""
import jax
import jax.numpy as jnp
from repro.configs import get_config
from repro.dist.sharding import (batch_specs, cache_specs, make_plan,
                                 make_run_ctx, named, param_specs)
from repro.launch.mesh import make_test_mesh
from repro.models.decode import decode_step, init_cache, prefill_cache
from repro.models.transformer import RunCtx
from repro.optim.optimizers import sgdm_init, sgdm_update
from repro.train.step import make_train_step

src, dest = sys.argv[1], sys.argv[2]
devices = jax.devices()

def opt_update(g, s, p, lr):
    return sgdm_update(g, s, p, lr=lr, momentum=0.9)

out, modes = {}, {}
for name, (arch, repl, mshape, kind, knobs) in CASES.items():
    cfg = config(get_config, arch, repl)
    mesh = make_test_mesh(tuple(mshape), ("data", "model"))
    plan = make_plan(mesh)
    d = dict(np.load(f"{src}/{name}.npz"))
    params = jax.tree.map(jnp.asarray, nest({k[2:]: v for k, v in d.items()
                                            if k.startswith("p/")}))
    ctx = make_run_ctx(cfg, plan, compute_dtype=jnp.float32,
                       param_dtype=jnp.float32, remat=False, chunk_q=16,
                       chunk_k=16, loss_chunk=16)
    modes[name] = ctx.attn_mode
    p_sh = named(params, param_specs(params, cfg, plan), mesh)
    if kind == "train":
        batch = {k: jnp.asarray(v) for k, v in d.items()
                 if not k.startswith("p/")}
        n_micro = knobs["n_micro"]
        b_sh = named(batch, batch_specs(cfg, plan, batch,
                                        seq_sharded=ctx.seq_sharded), mesh)
        with jax.set_mesh(mesh):
            step = jax.jit(make_train_step(
                cfg, ctx, opt_update, lambda t: LR, n_micro=n_micro,
                grad_shardings=p_sh if n_micro > 1 else None),
                in_shardings=(p_sh, {"mom": p_sh}, b_sh, None),
                out_shardings=(p_sh, {"mom": p_sh}, None))
            p2, s2, m = step(jax.device_put(params, p_sh),
                            jax.device_put(sgdm_init(params), {"mom": p_sh}),
                            jax.device_put(batch, b_sh), jnp.asarray(0))
        for k, v in flatten(jax.tree.map(np.asarray, p2)).items():
            out[f"{name}/p/{k}"] = v
        for k, v in flatten(jax.tree.map(np.asarray, s2["mom"])).items():
            out[f"{name}/g/{k}"] = v
        out[f"{name}/loss"] = np.asarray(m["loss"])
        continue
    pattern = cfg.pattern_for_long_context() if knobs["long"] else None
    single = RunCtx(remat=False, chunk_q=16, chunk_k=16, loss_chunk=16)
    cache = init_cache(cfg, knobs["batch"], knobs["cache"], single,
                       pattern=pattern)
    logits, cache = jax.jit(lambda p, t, c: prefill_cache(
        p, t, c, cfg, single, pattern=pattern))(
        params, jnp.asarray(d["prompts"]), cache)
    out[f"{name}/prefill"] = np.asarray(logits)
    c_sh = named(cache, cache_specs(cfg, plan, cache), mesh)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    t_sh = named({"tokens": tok}, batch_specs(cfg, plan, {"tokens": tok}),
                 mesh)["tokens"]
    with jax.set_mesh(mesh):
        step = jax.jit(lambda p, c, t: decode_step(p, c, t, cfg, ctx,
                                                   pattern=pattern),
                       in_shardings=(p_sh, c_sh, t_sh),
                       out_shardings=(None, c_sh))
        p_d, c_d = jax.device_put(params, p_sh), jax.device_put(cache, c_sh)
        for i in range(knobs["gen"]):
            logits, c_d = step(p_d, c_d, jax.device_put(tok, t_sh))
            out[f"{name}/logits{i}"] = np.asarray(logits)
            tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
            out[f"{name}/tokens{i}"] = np.asarray(tok)
np.savez(dest, **out)
print(json.dumps(modes))
"""

_RANK_SCRIPT = _COMMON + r"""
import torch
import torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.dist import (batch_specs, cache_specs, distribute,
                              make_plan, make_run_ctx, named, param_specs)
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import RunCtx
from repro_torch.models.attention import decode_attention
from repro_torch.models.decode import decode_step, init_cache, prefill_cache
from repro_torch.optim.optimizers import sgdm_init, sgdm_update
from repro_torch.train import make_train_step
from torch.distributed.tensor.experimental import implicit_replication

rank, store, src, dest = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                          sys.argv[4])
COMBINE = json.loads(%(combine)r)
COMBINE_LENS = %(combine_lens)r
dist.init_process_group("gloo", store=dist.FileStore(store, 4), rank=rank,
                        world_size=4)
torch.set_num_threads(1)
meshes = {}

def mesh_of(shape):
    shape = tuple(shape)
    if shape not in meshes:
        meshes[shape] = make_test_mesh(shape, ("data", "model"),
                                       device="cpu")
    return meshes[shape]

def opt_update(g, s, p, lr):
    return sgdm_update(g, s, p, lr=lr, momentum=0.9)

def whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t

out, info = {}, {}
for name, (arch, repl, mshape, kind, knobs) in CASES.items():
    cfg = config(get_config, arch, repl)
    mesh = mesh_of(mshape)
    plan = make_plan(mesh)
    d = dict(np.load(f"{src}/{name}.npz"))
    params = params_from_jax(nest({k[2:]: v for k, v in d.items()
                                   if k.startswith("p/")}), cfg,
                             device="cpu")
    ctx = make_run_ctx(cfg, plan, compute_dtype=torch.float32,
                       param_dtype=torch.float32, remat=False, chunk_q=16,
                       chunk_k=16, loss_chunk=16, device="cpu")
    info[name] = {"mode": ctx.attn_mode}
    specs = param_specs(params, cfg, plan)
    p_d = distribute(params, specs, mesh)
    if kind == "train":
        batch = {k: torch.from_numpy(v) for k, v in d.items()
                 if not k.startswith("p/")}
        n_micro = knobs["n_micro"]
        step = make_train_step(cfg, ctx, opt_update, lambda t: LR,
                               n_micro=n_micro,
                               grad_shardings=(named(params, specs, mesh)
                                               if n_micro > 1 else None))
        b_d = distribute(batch, batch_specs(cfg, plan, batch,
                                            seq_sharded=ctx.seq_sharded),
                         mesh)
        p2, s2, m = step(p_d, sgdm_init(p_d), b_d, 0)
        for k, t in flatten(p2).items():
            out[f"{name}/p/{k}"] = whole(t).numpy()
        for k, t in flatten(s2["mom"]).items():
            out[f"{name}/g/{k}"] = whole(t).numpy()
        out[f"{name}/loss"] = np.asarray(float(whole(m["loss"])))
        continue
    pattern = cfg.pattern_for_long_context() if knobs["long"] else None
    single = RunCtx(remat=False, chunk_q=16, chunk_k=16, loss_chunk=16,
                    device="cpu")
    prompts = torch.from_numpy(d["prompts"])
    cache = init_cache(cfg, knobs["batch"], knobs["cache"], single,
                       pattern=pattern)
    logits0, cache = prefill_cache(params, prompts, cache, cfg, single,
                                   pattern=pattern)
    out[f"{name}/prefill_single"] = logits0.numpy()
    # (decoding writes the placed cache in place, and a replicated leaf's
    # local tensor may be the unsharded one)
    filled = {k: t.clone() for k, t in flatten(cache).items()}
    # the serving calls under implicit_replication, as a caller that mixes
    # host-made tensors in runs them (both also enter it on a mesh)
    with implicit_replication():
        # decode on the mesh from the unsharded prefill's cache
        c_d = distribute(cache, cache_specs(cfg, plan, cache), mesh)
        tok = torch.argmax(logits0, -1).to(torch.int32)[:, None]
        for i in range(knobs["gen"]):
            t_d = distribute({"tokens": tok}, batch_specs(
                cfg, plan, {"tokens": tok}), mesh)["tokens"]
            logits, c_d = decode_step(p_d, c_d, t_d, cfg, ctx,
                                      pattern=pattern)
            logits = whole(logits)
            out[f"{name}/logits{i}"] = logits.numpy()
            tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
            out[f"{name}/tokens{i}"] = tok.numpy()
        # the same prefill on the mesh, into a fresh placed cache
        fresh = init_cache(cfg, knobs["batch"], knobs["cache"], single,
                           pattern=pattern)
        lp, cp = prefill_cache(
            p_d, distribute({"t": prompts}, batch_specs(
                cfg, plan, {"t": prompts}), mesh)["t"],
            distribute(fresh, cache_specs(cfg, plan, fresh), mesh), cfg, ctx,
            pattern=pattern)
    out[f"{name}/prefill"] = whole(lp).numpy()
    gap = 0.0
    for k, t in flatten(cp).items():
        gap = max(gap, float((whole(t).double()
                              - filled[k].double()).abs().max()))
    info[name]["prefill_cache_gap"] = gap

# the log-sum-exp combine alone
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
for name, (mshape, b, S, h, kvh, hd) in COMBINE.items():
    mesh = mesh_of(mshape)
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((b, 1, h, hd), (b, S, kvh, hd), (b, S, kvh, hd)))
    place = [Shard(0) if mshape[0] > 1 else Replicate(), Shard(1)]
    o = decode_attention(
        distribute_tensor(q, mesh, [Replicate(), Replicate()],
                          src_data_rank=None),
        distribute_tensor(k, mesh, place, src_data_rank=None),
        distribute_tensor(v, mesh, place, src_data_rank=None),
        torch.tensor(COMBINE_LENS, dtype=torch.int32), backend="torch")
    out[f"combine/{name}"] = o.full_tensor().numpy()
    info[name] = {"rows_sharded": [p.is_shard(0) for p in o.placements],
                  "replicated": [p.is_replicate() for p in o.placements]}
if rank == 0:
    np.savez(dest, **out)
    print(json.dumps(info))
dist.destroy_process_group()
"""


def _inputs(tmp):
    """Per case: the reference's params (noise on its zero leaves) and the
    batch or prompts, as flat numpy arrays in one npz."""
    rng = np.random.default_rng(0)
    for name, (arch, repl, _, kind, knobs) in CASES.items():
        cfg = dataclasses.replace(jax_get_config(arch).reduced(), **repl)
        if kind == "train":
            b, s = knobs["batch"], knobs["seq"]
            w = rng.random(b).astype(np.float32) + 0.5
            data = {"tokens": rng.integers(0, 1000, (b, s)).astype(np.int32),
                    "labels": rng.integers(0, 1000, (b, s)).astype(np.int32),
                    "sample_weights": (w / w.sum()).astype(np.float32)}
            if cfg.family == "vlm":
                data["patch_embeds"] = rng.standard_normal(
                    (b, cfg.num_patch_tokens, cfg.d_model)).astype(
                        np.float32)
                data["mrope_positions"] = np.broadcast_to(
                    np.arange(s, dtype=np.int32), (3, b, s)).copy()
        else:
            data = {"prompts": rng.integers(
                0, 1000, (knobs["batch"], knobs["prompt"])).astype(np.int32)}
        tree = jax.tree.map(np.asarray,
                            jtf.init_params(jax.random.PRNGKey(1), cfg))

        def noise(path, a):
            if any(n in jax.tree_util.keystr(path) for n in NOISY):
                return (a + 0.1 * rng.standard_normal(a.shape)).astype(
                    a.dtype)
            return a

        tree = jax.tree_util.tree_map_with_path(noise, tree)
        flat = {"p/" + "/".join(str(k.key) for k in path): a for path, a in
                jax.tree_util.tree_flatten_with_path(tree)[0]}
        np.savez(tmp / f"{name}.npz", **flat, **data)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results, port results, reference modes, port info)."""
    tmp = tmp_path_factory.mktemp("sharded_geometry")
    _inputs(tmp)
    fill = {"cases": json.dumps(CASES), "lr": LR,
            "combine": json.dumps(COMBINE), "combine_lens": COMBINE_LENS}
    (tmp / "ref.py").write_text(textwrap.dedent(_JAX_SCRIPT % fill))
    (tmp / "rank.py").write_text(textwrap.dedent(_RANK_SCRIPT % fill))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    cmds = [[sys.executable, str(tmp / "ref.py"), str(tmp),
             str(tmp / "ref_out.npz")]]
    cmds += [[sys.executable, str(tmp / "rank.py"), str(r), str(tmp / "store"),
              str(tmp), str(tmp / "port_out.npz")] for r in range(4)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for c in cmds]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
    return (dict(np.load(tmp / "ref_out.npz")),
            dict(np.load(tmp / "port_out.npz")),
            json.loads(outs[0].strip().splitlines()[-1]),
            json.loads(outs[1].strip().splitlines()[-1]))


def _part(results, name, part):
    pre = f"{name}/{part}/"
    return {k[len(pre):]: v for k, v in results.items() if k.startswith(pre)}


@pytest.mark.parametrize("name", TRAIN)
def test_sharded_step_at_geometry_matches_reference(runs, name):
    """One momentum-SGD step on the case's mesh: the same attention mode,
    params within 2e-4, the loss within 1e-5 rel + 1e-6, and the gradient
    (the momentum after one step from zero) within 1e-5 of its leaf's
    largest |g| + 1e-7."""
    ref, port, modes, info = runs
    assert modes[name] == info[name]["mode"]
    rp, pp = _part(ref, name, "p"), _part(port, name, "p")
    assert sorted(rp) == sorted(pp)
    for k in rp:
        np.testing.assert_allclose(pp[k], rp[k], rtol=0, atol=2e-4,
                                   err_msg=k)
    np.testing.assert_allclose(port[f"{name}/loss"], ref[f"{name}/loss"],
                               rtol=1e-5, atol=1e-6)
    rg, pg = _part(ref, name, "g"), _part(port, name, "g")
    assert sorted(rg) == sorted(pg)
    for k in rg:
        bar = 1e-5 * float(np.max(np.abs(rg[k]))) + 1e-7
        np.testing.assert_allclose(pg[k], rg[k], rtol=0, atol=bar,
                                   err_msg=k)


@pytest.mark.parametrize("name", SERVE)
def test_sharded_decode_at_geometry_matches_reference(runs, name):
    """Greedy decode on the case's mesh from the same prefilled cache:
    each step's logits within 1e-5 of the reference's, the tokens equal."""
    ref, port, modes, info = runs
    assert modes[name] == info[name]["mode"]
    for i in range(CASES[name][4]["gen"]):
        np.testing.assert_allclose(port[f"{name}/logits{i}"],
                                   ref[f"{name}/logits{i}"], rtol=0,
                                   atol=1e-5, err_msg=f"step {i}")
        np.testing.assert_array_equal(port[f"{name}/tokens{i}"],
                                      ref[f"{name}/tokens{i}"])


@pytest.mark.parametrize("name", SERVE)
def test_sharded_prefill_matches_reference_and_single_device(runs, name):
    """``prefill_cache`` on the mesh: its logits within 1e-5 of the
    reference's (unsharded) prefill, the cache it fills within 1e-5 of the
    port's unsharded prefill's, ring wraps included."""
    ref, port, _, info = runs
    np.testing.assert_allclose(port[f"{name}/prefill"], ref[f"{name}/prefill"],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(port[f"{name}/prefill_single"],
                               ref[f"{name}/prefill"], rtol=0, atol=1e-5)
    assert info[name]["prefill_cache_gap"] <= 1e-5


@pytest.mark.parametrize("name", list(COMBINE))
def test_lse_combine_equals_whole_cache(runs, name):
    """``decode_attention`` on a sequence sharded over 2 or 4 ranks (each
    chunk's plain version with its log-sum-exp, merged) equals it over the
    whole cache within 1e-6: kv_len 0 gives the uniform average of all S
    keys (every chunk empty), 5 ends inside the first chunk (the others'
    weights underflow to 0), 40 spans chunks, S + 7 is a full ring; the
    output keeps the batch's placement."""
    _, port, _, info = runs
    mshape, b, S, h, kvh, hd = COMBINE[name]
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((b, 1, h, hd), (b, S, kvh, hd), (b, S, kvh, hd)))
    want = decode_attention(q, k, v, torch.tensor(COMBINE_LENS,
                                                  dtype=torch.int32),
                            backend="torch").numpy()
    got = port[f"combine/{name}"]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    uniform = np.einsum("skd->kd", v[0].numpy()) / S
    np.testing.assert_allclose(got[0, 0].reshape(kvh, h // kvh, hd),
                               np.repeat(uniform[:, None], h // kvh, 1),
                               rtol=0, atol=1e-6)
    assert info[name]["rows_sharded"] == [mshape[0] > 1, False]
    assert info[name]["replicated"] == [mshape[0] == 1, True]


def test_mrope_angles_on_fake_tensors_match_reference():
    """M-RoPE's section ids have a static length: the angles build on fake
    tensors (a dry run records them) and, on real ones, equal the
    reference's within 1e-6."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    sections, hd = (16, 8, 8), 64
    pos = np.random.default_rng(3).integers(0, 500, (3, 2, 12)).astype(
        np.int32)
    with FakeTensorMode() as mode:
        cos, sin = tlayers.mrope_angles(mode.from_tensor(torch.from_numpy(
            pos)), hd, sections, 1e6)
    assert cos.shape == sin.shape == (2, 12, hd // 2)
    cos, sin = tlayers.mrope_angles(torch.from_numpy(pos), hd, sections, 1e6)
    jcos, jsin = jlayers.mrope_angles(jax.numpy.asarray(pos), hd, sections,
                                      1e6)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), rtol=0,
                               atol=1e-6)
