"""The port's sharded ``make_train_step`` on a (2, 2) ("data", "model") mesh
of four gloo ranks, against the reference's on four CPU devices and against
the port's own single-device step.

One momentum-SGD step (momentum 0.9, lr 1e-2) from zero momentum on reduced
configs, f32, remat off, chunks of 16, batch 8 x 32 with non-uniform
sample weights:

* megatron: qwen1.5-0.5b (4 heads over tp 2) at ``n_micro`` 1, and at 2
  with ``grad_shardings`` (the ZeRO-2 accumulator);
* context: qwen2-0.5b with heads 3, kv 1, head_dim 64 (replaced the same
  way in both packages), so 3 % 2 != 0 and the sequence shards over tp;
* expert: mixtral-8x22b (4 experts over tp 2, expert parallelism);
* the other families, megatron: recurrentgemma-2b (RG-LRU blocks beside
  local attention), xlstm-125m (mLSTM and sLSTM), whisper-base (the
  encoder's frames from numpy) and qwen2-vl-2b (patch embeddings and
  M-RoPE positions from numpy).

The reference's params (numpy noise on the leaves it makes zero) cross by
``params_from_jax``; the batch comes from a numpy seed.  The reference runs
in a subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
(``make_plan`` -> ``make_run_ctx`` -> ``named`` -> ``jax.jit`` with in and
out shardings, as ``tests/test_dist.py``'s multi-device script); the port in
four processes (gloo over a ``FileStore``), each placing the same global
tensors by ``distribute``.  Bars: against the reference, params within 2e-4
after ``full_tensor()`` and the loss within 1e-5 rel + 1e-6 abs; against
the port's single-device step, params within 2e-4 (the reference's own bar
for sharded against single-device, ``tests/test_dist.py``).  After one step
from zero momentum the momentum is the gradient: it is held against both at
1e-5 of the leaf's largest |g| + 1e-7 (the runs spread by ~1e-7), since the
params' 2e-4 is 2e-2 of gradient at lr 1e-2.  Every output leaf of params
and momentum is a DTensor with its spec's placements.
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
from repro.models import transformer as jtf  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
B, S, LR = 8, 32, 1e-2
# name -> (arch, config fields replaced in both packages, n_micro)
CASES = {
    "megatron": ("qwen1.5-0.5b", {}, 1),
    "megatron_micro2": ("qwen1.5-0.5b", {}, 2),
    "context": ("qwen2-0.5b", {"num_heads": 3, "num_kv_heads": 1,
                               "head_dim": 64}, 1),
    "expert": ("mixtral-8x22b", {}, 1),
    "hybrid": ("recurrentgemma-2b", {}, 1),
    "ssm": ("xlstm-125m", {}, 1),
    "audio": ("whisper-base", {}, 1),
    "vlm": ("qwen2-vl-2b", {}, 1),
}
MODES = {name: "context" if name == "context" else "megatron"
         for name in CASES}
NOISY = ("'bq'", "'bk'", "'bv'", "'scale'")

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
"""

_JAX_SCRIPT = _COMMON + r"""
import jax
import jax.numpy as jnp
from repro.configs import get_config
from repro.dist.sharding import (batch_specs, make_plan, make_run_ctx, named,
                                 param_specs)
from repro.launch.mesh import make_test_mesh
from repro.optim.optimizers import sgdm_init, sgdm_update
from repro.train.step import make_train_step

src, dest = sys.argv[1], sys.argv[2]
mesh = make_test_mesh((2, 2), ("data", "model"))
plan = make_plan(mesh)

def opt_update(g, s, p, lr):
    return sgdm_update(g, s, p, lr=lr, momentum=0.9)

out, modes = {}, {}
for name, (arch, repl, n_micro) in CASES.items():
    cfg = config(get_config, arch, repl)
    d = dict(np.load(f"{src}/{arch}.npz"))
    params = jax.tree.map(jnp.asarray, nest({k[2:]: v for k, v in d.items()
                                            if k.startswith("p/")}))
    batch = {k: jnp.asarray(v) for k, v in d.items()
             if not k.startswith("p/")}
    ctx = make_run_ctx(cfg, plan, compute_dtype=jnp.float32,
                       param_dtype=jnp.float32, remat=False, chunk_q=16,
                       chunk_k=16, loss_chunk=16)
    modes[name] = ctx.attn_mode
    p_sh = named(params, param_specs(params, cfg, plan), mesh)
    b_sh = named(batch, batch_specs(cfg, plan, batch,
                                    seq_sharded=ctx.seq_sharded), mesh)
    with jax.set_mesh(mesh):
        step = jax.jit(make_train_step(
            cfg, ctx, opt_update, lambda t: %(lr)r, n_micro=n_micro,
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
np.savez(dest, **out)
print(json.dumps(modes))
"""

_RANK_SCRIPT = _COMMON + r"""
import torch
import torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.dist import (batch_specs, distribute, make_plan,
                              make_run_ctx, named, param_specs)
from repro_torch.dist.sharding import placements_of
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import RunCtx
from repro_torch.optim.optimizers import sgdm_init, sgdm_update
from repro_torch.train import make_train_step

rank, store, src, dest = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                          sys.argv[4])
dist.init_process_group("gloo", store=dist.FileStore(store, 4), rank=rank,
                        world_size=4)
torch.set_num_threads(1)
mesh = make_test_mesh((2, 2), ("data", "model"), device="cpu")
plan = make_plan(mesh)

def opt_update(g, s, p, lr):
    return sgdm_update(g, s, p, lr=lr, momentum=0.9)

out, info = {}, {}
for name, (arch, repl, n_micro) in CASES.items():
    cfg = config(get_config, arch, repl)
    d = dict(np.load(f"{src}/{arch}.npz"))
    params = params_from_jax(nest({k[2:]: v for k, v in d.items()
                                   if k.startswith("p/")}), cfg,
                             device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in d.items()
             if not k.startswith("p/")}
    ctx = make_run_ctx(cfg, plan, compute_dtype=torch.float32,
                       param_dtype=torch.float32, remat=False, chunk_q=16,
                       chunk_k=16, loss_chunk=16, device="cpu")
    specs = param_specs(params, cfg, plan)
    step = make_train_step(cfg, ctx, opt_update, lambda t: %(lr)r,
                           n_micro=n_micro,
                           grad_shardings=(named(params, specs, mesh)
                                           if n_micro > 1 else None))
    p_d = distribute(params, specs, mesh)
    b_d = distribute(batch, batch_specs(cfg, plan, batch,
                                        seq_sharded=ctx.seq_sharded), mesh)
    p2, s2, m = step(p_d, sgdm_init(p_d), b_d, 0)
    wrong = []
    for tree in (p2, s2["mom"]):
        for path, t in flatten(tree).items():
            spec = flatten(specs)[path]
            if not (hasattr(t, "placements")
                    and tuple(t.placements) == placements_of(mesh, spec)):
                wrong.append(path)
    full = {k: t.full_tensor().numpy() for k, t in flatten(p2).items()}
    grad = {k: t.full_tensor().numpy() for k, t in flatten(s2["mom"]).items()}
    loss = float(m["loss"].full_tensor())
    if rank == 0:
        single = RunCtx(remat=False, chunk_q=16, chunk_k=16, loss_chunk=16,
                        device="cpu")
        p1, s1, m1 = make_train_step(cfg, single, opt_update,
                                    lambda t: %(lr)r, n_micro=n_micro)(
            params, sgdm_init(params), batch, 0)
        for k, v in full.items():
            out[f"{name}/p/{k}"] = v
        for k, v in grad.items():
            out[f"{name}/g/{k}"] = v
        for k, t in flatten(p1).items():
            out[f"{name}/single/{k}"] = t.numpy()
        for k, t in flatten(s1["mom"]).items():
            out[f"{name}/single_g/{k}"] = t.numpy()
        out[f"{name}/loss"] = np.asarray(loss)
        out[f"{name}/single_loss"] = m1["loss"].numpy()
        info[name] = {"mode": ctx.attn_mode, "wrong": wrong,
                      "we_gate": list(map(str, flatten(specs).get(
                          "unit/p0/moe/we_gate", ())))}
if rank == 0:
    np.savez(dest, **out)
    print(json.dumps(info))
dist.destroy_process_group()
"""


def _inputs(tmp):
    """Per arch: the reference's params (noise on its zero leaves) and the
    batch, as flat numpy arrays in one npz each."""
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 1000, (B, S)).astype(np.int32)
    labels = rng.integers(0, 1000, (B, S)).astype(np.int32)
    w = rng.random(B).astype(np.float32) + 0.5
    batch = {"tokens": toks, "labels": labels,
             "sample_weights": (w / w.sum()).astype(np.float32)}
    for arch, repl, _ in CASES.values():
        cfg = dataclasses.replace(jax_get_config(arch).reduced(), **repl)
        extras = {}
        if cfg.family == "audio":
            extras["audio_feats"] = rng.standard_normal(
                (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm":
            extras["patch_embeds"] = rng.standard_normal(
                (B, cfg.num_patch_tokens, cfg.d_model)).astype(np.float32)
            extras["mrope_positions"] = np.broadcast_to(
                np.arange(S, dtype=np.int32), (3, B, S)).copy()
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
        np.savez(tmp / f"{arch}.npz", **flat, **batch, **extras)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results, port results, reference modes, port info)."""
    tmp = tmp_path_factory.mktemp("sharded_step")
    _inputs(tmp)
    fill = {"cases": json.dumps(CASES), "lr": LR}
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


def _params(results, name, part="p"):
    pre = f"{name}/{part}/"
    return {k[len(pre):]: v for k, v in results.items() if k.startswith(pre)}


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_reference(runs, name):
    """The port's sharded step against the reference's sharded step: the
    same attention mode, params within 2e-4, loss within 1e-5 rel + 1e-6."""
    ref, port, modes, info = runs
    assert modes[name] == info[name]["mode"] == MODES[name]
    rp, pp = _params(ref, name), _params(port, name)
    assert sorted(rp) == sorted(pp)
    for k in rp:
        np.testing.assert_allclose(pp[k], rp[k], rtol=0, atol=2e-4,
                                   err_msg=k)
    np.testing.assert_allclose(port[f"{name}/loss"], ref[f"{name}/loss"],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_single_device(runs, name):
    """The port's sharded step against its own single-device step from the
    same params and batch: params within 2e-4, the loss within 1e-5 rel."""
    _, port, _, _ = runs
    sharded, single = _params(port, name), _params(port, name, "single")
    assert sorted(sharded) == sorted(single)
    for k in single:
        np.testing.assert_allclose(sharded[k], single[k], rtol=0, atol=2e-4,
                                   err_msg=k)
    np.testing.assert_allclose(port[f"{name}/loss"],
                               port[f"{name}/single_loss"], rtol=1e-5,
                               atol=1e-6)


def _close_grads(got, want):
    """Each leaf of ``got`` within 1e-5 of ``want``'s largest |g| + 1e-7."""
    assert sorted(got) == sorted(want)
    for k in want:
        bar = 1e-5 * float(np.max(np.abs(want[k]))) + 1e-7
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=bar,
                                   err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_gradient_matches_reference(runs, name):
    """The momentum after the step (the gradient, from zero momentum) of the
    port's sharded step against the reference's sharded step."""
    ref, port, _, _ = runs
    _close_grads(_params(port, name, "g"), _params(ref, name, "g"))


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_gradient_matches_single_device(runs, name):
    """The same gradient against the port's single-device step's."""
    _, port, _, _ = runs
    _close_grads(_params(port, name, "g"), _params(port, name, "single_g"))


@pytest.mark.parametrize("name", list(CASES))
def test_outputs_keep_their_specs(runs, name):
    """Every leaf of the new params and momentum is a DTensor with the
    placements of its spec; mixtral's experts shard on the expert dim
    (expert parallelism: 4 experts over tp 2)."""
    _, _, _, info = runs
    assert info[name]["wrong"] == []
    if name == "expert":
        assert info[name]["we_gate"] == ["None", "model", "data", "None"]
