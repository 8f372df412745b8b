"""The port's context-parallel attention, ``psum_weighted`` and meshes on two
gloo ranks, against the reference on a 2-device CPU mesh.

Both sides take the same numpy inputs from a seed.  The reference runs in a
subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=2``:
``context_parallel_attention`` over ``make_test_mesh((1, 2))`` (jitted,
with ``jax.grad`` of ``sum(sin(o))``), and ``psum_weighted`` under
``shard_map`` with one gradient tree and rate a device.  The port runs two
processes (gloo over a ``FileStore``), each with its own sequence shard,
its own gradient tree and rate.  Bars: outputs within 1e-5, q/k/v
gradients within 1e-4 rel + 1e-5 abs after gathering the shards,
``psum_weighted`` within 1e-6 rel.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
B, S, H, KVH, HD = 2, 64, 4, 2, 16
CASES = (("causal", 0), ("swa", 24))
CHUNK = 16
RATES = (1.0, 3.0)

_JAX_SCRIPT = textwrap.dedent(r"""
    import sys
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.core.weighted_agg import psum_weighted
    from repro.launch.mesh import make_test_mesh
    from repro.models.attention import context_parallel_attention

    d = dict(np.load(sys.argv[1]))
    mesh = make_test_mesh((1, 2))
    out = {}
    q, k, v = (jnp.asarray(d[n]) for n in "qkv")
    for kind, window in %(cases)r:
        def f(q, k, v):
            return context_parallel_attention(
                q, k, v, mesh, "model", kind=kind, window=window,
                chunk_q=%(chunk)d, chunk_k=%(chunk)d)
        out[kind + "_o"] = np.asarray(jax.jit(f)(q, k, v))
        grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(jnp.sin(f(q, k, v))),
                                 argnums=(0, 1, 2)))(q, k, v)
        for name, g in zip("qkv", grads):
            out[kind + "_d" + name] = np.asarray(g)

    def body(g, r):
        agg, total = psum_weighted(g, r[0], ("data", "model"))
        return agg, total[None]

    spec = P(("data", "model"))
    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(spec, spec),
                               out_specs=(spec, spec), check_vma=False))
    agg, total = fn({"a": jnp.asarray(d["g_a"]), "b": {"c": jnp.asarray(d["g_c"])}},
                    jnp.asarray(d["rates"]))
    out["agg_a"], out["agg_c"] = np.asarray(agg["a"]), np.asarray(agg["b"]["c"])
    out["total"] = np.asarray(total)
    np.savez(sys.argv[2], **out)
""")

_RANK_SCRIPT = textwrap.dedent(r"""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import psum_weighted
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
    from repro_torch.models.attention import context_parallel_attention

    rank, store, data, dest = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    d = dict(np.load(data))
    mesh = make_test_mesh((1, 2), device="cpu")
    info = {"shape": list(mesh.shape), "names": list(mesh.mesh_dim_names)}
    for multi_pod in (False, True):
        try:
            make_production_mesh(multi_pod=multi_pod, device="cpu")
            info[f"prod_{multi_pod}"] = "built"
        except RuntimeError as e:
            info[f"prod_{multi_pod}"] = str(e)
    out = {}
    s_local = d["q"].shape[1] // 2
    shard = slice(rank * s_local, (rank + 1) * s_local)
    for kind, window in %(cases)r:
        q, k, v = (torch.tensor(d[n][:, shard], requires_grad=True)
                   for n in "qkv")
        o = context_parallel_attention(q, k, v, mesh, "model", kind=kind,
                                       window=window, chunk_q=%(chunk)d,
                                       chunk_k=%(chunk)d)
        grads = torch.autograd.grad(torch.sin(o).sum(), (q, k, v))
        out[kind + "_o"] = o.detach().numpy()
        for name, g in zip("qkv", grads):
            out[kind + "_d" + name] = g.numpy()
    tree = {"a": torch.tensor(d["g_a"][rank]),
            "b": {"c": torch.tensor(d["g_c"][rank])}}
    agg, total = psum_weighted(tree, float(d["rates"][rank]), mesh,
                               ("data", "model"))
    out["agg_a"], out["agg_c"] = agg["a"].numpy(), agg["b"]["c"].numpy()
    out["total"] = total.numpy()
    np.savez(dest, **out)
    print(json.dumps(info))
    dist.destroy_process_group()
""")


def _run(cmds, env, timeout=240):
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for c in cmds]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results, [rank 0, rank 1] results, [rank infos])."""
    tmp = tmp_path_factory.mktemp("cp")
    rng = np.random.default_rng(0)
    data = {n: rng.standard_normal((B, S, h, HD)).astype(np.float32)
            for n, h in (("q", H), ("k", KVH), ("v", KVH))}
    data["g_a"] = rng.standard_normal((2, 5, 3)).astype(np.float32)
    data["g_c"] = rng.standard_normal((2, 7)).astype(np.float32)
    data["rates"] = np.asarray(RATES, np.float32)
    np.savez(tmp / "data.npz", **data)
    fill = {"cases": CASES, "chunk": CHUNK}
    (tmp / "ref.py").write_text(_JAX_SCRIPT % fill)
    (tmp / "rank.py").write_text(_RANK_SCRIPT % fill)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    cmds = [[sys.executable, str(tmp / "ref.py"), str(tmp / "data.npz"),
             str(tmp / "ref.npz")]]
    cmds += [[sys.executable, str(tmp / "rank.py"), str(r), str(tmp / "store"),
              str(tmp / "data.npz"), str(tmp / f"rank{r}.npz")]
             for r in range(2)]
    outs = _run(cmds, env)
    infos = [json.loads(o.strip().splitlines()[-1]) for o in outs[1:]]
    return (dict(np.load(tmp / "ref.npz")),
            [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)], infos)


@pytest.mark.parametrize("kind", [kind for kind, _ in CASES])
def test_context_parallel_attention_matches_reference(runs, kind):
    """Each rank's output shard and its q/k/v gradient shards, gathered
    along the sequence, against the reference's global arrays."""
    ref, ranks, _ = runs
    o = np.concatenate([r[kind + "_o"] for r in ranks], axis=1)
    np.testing.assert_allclose(o, ref[kind + "_o"], rtol=0, atol=1e-5)
    for name in "qkv":
        g = np.concatenate([r[kind + "_d" + name] for r in ranks], axis=1)
        np.testing.assert_allclose(g, ref[kind + "_d" + name], rtol=1e-4,
                                   atol=1e-5)


def test_psum_weighted_matches_reference(runs):
    """Unequal rates (1, 3): every rank holds sum_i (r_i / sum r) g_i and
    the total rate, as every reference device does."""
    ref, ranks, _ = runs
    for r in ranks:
        for name in ("agg_a", "agg_c"):
            np.testing.assert_allclose(r[name], ref[name][0], rtol=1e-6)
            np.testing.assert_allclose(r[name], ref[name][1], rtol=1e-6)
        np.testing.assert_allclose(r["total"], ref["total"][0], rtol=1e-6)
        assert float(r["total"]) == sum(RATES)


def test_meshes_shape_names_and_refusal(runs):
    """``make_test_mesh((1, 2))`` lays the two ranks out as ("data",
    "model"); both production meshes refuse a 2-rank group."""
    for info in runs[2]:
        assert info["shape"] == [1, 2]
        assert info["names"] == ["data", "model"]
        assert info["prod_False"] == ("mesh (16, 16) needs 256 ranks, the "
                                      "process group has 2")
        assert info["prod_True"] == ("mesh (2, 16, 16) needs 512 ranks, the "
                                     "process group has 2")
