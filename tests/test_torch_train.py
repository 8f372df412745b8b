"""The port's training path against the JAX package, on the CPU.

Reduced qwen2-0.5b (d 256, 2 layers, vocab 1024): the reference's params,
with numpy noise on the QKV biases and norm scales (the reference makes
them zero), are carried across by ``params_from_jax``.  Tokens come from
``TokenData`` at a seed.  Covered: the repairs (kernel attention refuses
autograd, ``RunCtx`` carries ``remat`` and ``loss_chunk``), schedules,
optimizers, the compression layer, the training forward and its gradient,
and both DDP programs, one step each, against the reference's
``make_ddp_steps`` on a one-device mesh; then the compressed program on two
``gloo`` ranks.  Each tolerance is stated where it is used.
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
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.data.synthetic import TokenData as JaxTokenData  # noqa: E402
from repro.launch.mesh import make_test_mesh  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro.train.ddp import make_ddp_steps as jax_make_ddp_steps  # noqa: E402
from repro.train.step import make_loss_fn as jax_make_loss_fn  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax, sgdm_state_from_jax  # noqa: E402
from repro_torch.core import compression as comp  # noqa: E402
from repro_torch.data.synthetic import TokenData  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.transformer import (RunCtx, forward_hidden,  # noqa: E402
                                            lm_loss, logits_fn)
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402
from repro_torch.train.ddp import make_ddp_steps  # noqa: E402
from repro_torch.train.step import make_eval_step, make_loss_fn  # noqa: E402
from repro_torch.tree import leaves, unflatten  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
JCTX = jtf.RunCtx(remat=False, chunk_q=16, chunk_k=16, loss_chunk=16)
LR, MOMENTUM, CR = 1e-2, 0.9, 0.1


def _cfgs():
    return (jax_get_config("qwen2-0.5b").reduced(),
            get_config("qwen2-0.5b").reduced())


def _noisy_params(jcfg, tcfg, seed=0):
    tree = jax.tree.map(np.asarray, jtf.init_params(jax.random.PRNGKey(1),
                                                    jcfg))
    rng = np.random.default_rng(seed)

    def noise(path, a):
        name = jax.tree_util.keystr(path)
        if any(n in name for n in ("'bq'", "'bk'", "'bv'", "'scale'")):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(noise, tree)
    return (jax.tree.map(jnp.asarray, tree),
            params_from_jax(tree, tcfg, device="cpu"))


def _batch(cfg, b=4, s=32, seed=0):
    x, y = TokenData(vocab_size=cfg.vocab_size, seq_len=s).sample(
        np.random.default_rng(seed), b)
    return ({"tokens": jnp.asarray(x), "labels": jnp.asarray(y)},
            {"tokens": torch.from_numpy(x), "labels": torch.from_numpy(y)})


def _assert_trees_close(ttree, jtree, **tol):
    tl, jl = leaves(ttree), jax.tree.leaves(jtree)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   np.asarray(b, np.float32), **tol)


# ---------------------------------------------------------------------------
# repairs


@pytest.mark.parametrize("fn", ["chunked", "decode"])
def test_kernel_attention_refuses_autograd(fn):
    """The kernels have no backward; with grad on, inputs that require grad
    raise on the kernel backend (on every device), and the plain backend
    differentiates."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 1 if fn == "decode" else 8, 4, 32), generator=g)
    k = torch.randn((1, 8, 2, 32), generator=g)
    v = torch.randn((1, 8, 2, 32), generator=g).requires_grad_()

    def call(backend):
        if fn == "decode":
            return tattn.decode_attention(q, k, v, 8, backend=backend)
        return tattn.chunked_attention(q, k, v, backend=backend)

    with pytest.raises(RuntimeError, match="no backward"):
        call("kernel")
    call("torch").sum().backward()
    assert v.grad is not None and torch.count_nonzero(v.grad) > 0
    with torch.no_grad():
        torch.testing.assert_close(call("kernel"), call("torch"))


def test_runctx_carries_remat_and_loss_chunk():
    jd, td = jtf.RunCtx(), RunCtx()
    assert (td.remat, td.loss_chunk) == (jd.remat, jd.loss_chunk) == (True,
                                                                     512)


# ---------------------------------------------------------------------------
# schedules, optimizers


@pytest.mark.parametrize("as_tensor", [False, True])
def test_schedules_match_jax(as_tensor):
    """f32 on both sides; rtol 1e-6 for the cosine's transcendental."""
    steps = [0, 1, 9, 10, 11, 74, 75, 76, 150, 224, 225, 300]
    cases = [(jsched.multistep_lr(0.1, [75, 150, 225], 0.2),
              tsched.multistep_lr(0.1, [75, 150, 225], 0.2)),
             (jsched.warmup_cosine(3e-4, 10, 200),
              tsched.warmup_cosine(3e-4, 10, 200))]
    for jfn, tfn in cases:
        for s in steps:
            got = tfn(torch.tensor(s) if as_tensor else s)
            if as_tensor:
                assert isinstance(got, torch.Tensor) and got.ndim == 0
            np.testing.assert_allclose(float(got), float(jfn(s)), rtol=1e-6)


def _tree(seed):
    """A nested tree whose insertion order is not sorted order."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (5, 3), "b": {"z": (3,), "a": (2, 2)}, "emb": (7,)}

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        return rng.standard_normal(s).astype(np.float32)

    t = make(shapes)
    return (jax.tree.map(jnp.asarray, t),
            jax.tree.map(lambda a: torch.from_numpy(a.copy()), t))


@pytest.mark.parametrize("nesterov,wd", [(False, 0.0), (False, 0.01),
                                         (True, 0.01)])
def test_sgdm_update_matches_jax(nesterov, wd):
    """Two steps from zero momentum; the non-Nesterov leaves go through
    fused_sgdm's plain version here.  rtol 1e-6: same f32 ops."""
    (jp, tp), (jg, tg) = _tree(1), _tree(2)
    js, ts = jopt.sgdm_init(jp), topt.sgdm_init(tp)
    for _ in range(2):
        jp, js = jopt.sgdm_update(jg, js, jp, lr=0.1, momentum=0.9,
                                  weight_decay=wd, nesterov=nesterov)
        tp, ts = topt.sgdm_update(tg, ts, tp, lr=0.1, momentum=0.9,
                                  weight_decay=wd, nesterov=nesterov)
    _assert_trees_close(tp, jp, rtol=1e-6, atol=1e-7)
    _assert_trees_close(ts["mom"], js["mom"], rtol=1e-6, atol=1e-7)


def test_sgdm_bf16_momentum_on_cpu_and_backends():
    """A bf16 momentum runs the plain update on the CPU as the reference
    does; both backends give the same bits on CPU tensors."""
    (jp, tp), (jg, tg) = _tree(3), _tree(4)
    js = jopt.sgdm_init(jp, mom_dtype=jnp.bfloat16)
    ts = topt.sgdm_init(tp, mom_dtype=torch.bfloat16)
    jp2, js2 = jopt.sgdm_update(jg, js, jp, lr=0.1)
    tp2, ts2 = topt.sgdm_update(tg, ts, tp, lr=0.1)
    _assert_trees_close(tp2, jp2, rtol=1e-6, atol=1e-7)
    _assert_trees_close(ts2["mom"], js2["mom"], rtol=1e-2, atol=1e-2)
    ts = topt.sgdm_init(tp)
    a, _ = topt.sgdm_update(tg, ts, tp, lr=0.1, backend="kernel")
    b, _ = topt.sgdm_update(tg, ts, tp, lr=0.1, backend="torch")
    for x, y in zip(leaves(a), leaves(b)):
        assert torch.equal(x, y)


def test_adam_update_matches_jax():
    """Three steps; rtol 1e-5 for the bias corrections' powers and sqrt."""
    (jp, tp), (jg, tg) = _tree(5), _tree(6)
    jinit, jupd = jopt.make_optimizer("adam", weight_decay=0.01)
    tinit, tupd = topt.make_optimizer("adam", weight_decay=0.01)
    js, ts = jinit(jp), tinit(tp)
    for _ in range(3):
        jp, js = jupd(jg, js, jp, 1e-2)
        tp, ts = tupd(tg, ts, tp, 1e-2)
    _assert_trees_close(tp, jp, rtol=1e-5, atol=1e-7)
    assert int(ts["t"]) == int(js["t"]) == 3


# ---------------------------------------------------------------------------
# compression layer


def test_flatten_grads_order_and_values_match_jax():
    """Flat index i names the same parameter in both packages: the flat
    vectors of one converted tree are equal, and unflatten inverts."""
    jcfg, tcfg = _cfgs()
    jp, tp = _noisy_params(jcfg, tcfg)
    jflat, _ = jcomp.flatten_grads(jp)
    tflat, unflatten = comp.flatten_grads(tp)
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
    back = unflatten(tflat)
    for a, b in zip(leaves(back), leaves(tp)):
        assert torch.equal(a, b)
    stacked = jax.tree.map(lambda x: jnp.stack([x, 2 * x]), jp)
    jst, _ = jcomp.flatten_stacked_grads(stacked)
    tst, unflatten_one = comp.flatten_stacked_grads(
        jax.tree.map(lambda x: torch.from_numpy(np.array(x)), stacked))
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    assert leaves(unflatten_one(tst[1]))[0].shape == leaves(tp)[0].shape


def test_global_topk_energy_gap_and_densify_match_jax():
    """Tie-free input: the same survivors as a set; gap to 1e-6."""
    g = np.random.default_rng(7).permutation(4000).astype(np.float32) - 2000
    g /= 997.0
    k = 400
    jv, ji = jcomp.global_topk(jnp.asarray(g), k)
    tv, ti = comp.global_topk(torch.from_numpy(g), k)
    assert ti.dtype == torch.int32
    assert set(ti.tolist()) == set(np.asarray(ji).tolist())
    jd = jcomp.densify(jv, ji, g.size)
    td = comp.densify(tv, ti, g.size)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(comp.sparsify_mask(torch.from_numpy(g),
                                                     k).numpy(), np.asarray(jd))
    np.testing.assert_allclose(
        float(comp.energy_gap(torch.from_numpy(g), td)),
        float(jcomp.energy_gap(jnp.asarray(g), jd)), rtol=1e-6)


def test_ewma_and_adaptive_decisions_match_jax():
    """A fixed gap sequence gives the same EWMA values and decisions, and
    the controller's accounting agrees (mirrors tests/test_core.py)."""
    gaps = [0.9, 0.2, 0.1, 0.5, 0.05, 0.31, 0.29, 0.0, 1.0, 0.3]
    jc = jcomp.AdaptiveCompressor(cr=0.1, delta=0.3, alpha=0.5)
    tc = comp.AdaptiveCompressor(cr=0.1, delta=0.3, alpha=0.5)
    for gap in gaps:
        use = tc.decide(gap)
        assert use == jc.decide(gap)
        assert tc.ewma.value == jc.ewma.value
        tc.account(use, 10_000)
        jc.account(use, 10_000)
    assert (tc.t_compressed, tc.t_uncompressed, tc.floats_sent,
            tc.cnc_ratio) == (jc.t_compressed, jc.t_uncompressed,
                              jc.floats_sent, jc.cnc_ratio)


@pytest.mark.parametrize("use_block_topk", [False, True])
@pytest.mark.parametrize("cr,delta", [(0.1, 0.3), (0.01, 1e-6), (0.5, 0.99)])
def test_adaptive_compressor_step_matches_jax(use_block_topk, cr, delta):
    """``step`` on a fixed gradient: the same tensor sent (block top-k
    bit-exact; exact top-k tie-free, so the same set), the same decisions
    and EWMA (to 1e-6, the gap's f32 sums), the same CNC accounting."""
    g = np.random.default_rng(9).permutation(10_000).astype(np.float32)
    g = (g - 5000) / 4999.0
    jc = jcomp.AdaptiveCompressor(cr=cr, delta=delta,
                                  use_block_topk=use_block_topk)
    tc = comp.AdaptiveCompressor(cr=cr, delta=delta,
                                 use_block_topk=use_block_topk)
    for _ in range(4):
        js, juse = jc.step(jnp.asarray(g))
        ts, tuse = tc.step(torch.from_numpy(g))
        assert tuse == juse
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_allclose(tc.ewma.value, jc.ewma.value, rtol=1e-6)
    assert (tc.t_compressed, tc.floats_sent) == (jc.t_compressed,
                                                  jc.floats_sent)


def test_token_data_identical_to_jax_package():
    for seed in (0, 3):
        a = TokenData(vocab_size=1024, seq_len=16, seed=seed)
        b = JaxTokenData(vocab_size=1024, seq_len=16, seed=seed)
        xa, ya = a.sample(np.random.default_rng(seed), 4)
        xb, yb = b.sample(np.random.default_rng(seed), 4)
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


# ---------------------------------------------------------------------------
# training forward, loss and gradient


@pytest.mark.parametrize("remat", [False, True])
def test_forward_loss_and_grad_match_jax(remat):
    """Hidden states to 1e-5, logits to 1e-4 and the loss to rel 1e-6
    (f32 through 2 layers, sums in other orders); the loss gradient to
    2e-5 abs + 1e-3 rel (a few thousand-term f32 sums per entry).  The
    sample-weighted loss of make_loss_fn too."""
    jcfg, tcfg = _cfgs()
    jp, tp = _noisy_params(jcfg, tcfg)
    jb, tb = _batch(jcfg)
    ctx = RunCtx(device="cpu", remat=remat, loss_chunk=16)
    jh, _ = jtf.forward_hidden(jp, jb["tokens"], jcfg, JCTX)
    th, aux = forward_hidden(tp, tb["tokens"], tcfg, ctx)
    assert float(aux) == 0.0
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5)
    np.testing.assert_allclose(logits_fn(tp, th, tcfg).numpy(),
                               np.asarray(jtf.logits_fn(jp, jh, jcfg)),
                               atol=1e-4)

    w = np.random.default_rng(1).random(4).astype(np.float32)
    w /= w.sum()
    jb["sample_weights"], tb["sample_weights"] = jnp.asarray(w), \
        torch.from_numpy(w)
    jfn = jax_make_loss_fn(jcfg, JCTX)
    (jl, jm), jg = jax.value_and_grad(jfn, has_aux=True)(jp, jb)
    live = [p.clone().requires_grad_() for p in leaves(tp)]
    tl, tm = make_loss_fn(tcfg, ctx)(unflatten(tp, live), tb)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    for p, g in zip(live, jax.tree.leaves(jg)):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), atol=2e-5,
                                   rtol=1e-3)
    m = make_eval_step(tcfg, ctx)(tp, tb)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-6)
    plain = lm_loss(tp, th, tb["labels"], tcfg, ctx)
    np.testing.assert_allclose(
        float(plain), float(jtf.lm_loss(jp, jh, jb["labels"], jcfg, JCTX)),
        rtol=1e-6)


def test_forward_refuses_other_families():
    cfg = get_config("mixtral-8x22b").reduced()
    with pytest.raises(NotImplementedError):
        forward_hidden({}, torch.zeros((1, 4), dtype=torch.long), cfg,
                       RunCtx(device="cpu"))


# ---------------------------------------------------------------------------
# DDP programs vs the reference


@pytest.fixture(scope="module")
def ddp_pair():
    """One dense and one compressed step of each package from the same
    params and momentum (a dense step first, so the momentum is not 0)."""
    jcfg, tcfg = _cfgs()
    jp, tp = _noisy_params(jcfg, tcfg)
    jb, tb = _batch(jcfg, b=4, s=32, seed=5)
    mesh = make_test_mesh((1,), ("data",))
    jd, jc, jk, jn = jax_make_ddp_steps(
        jcfg, JCTX, mesh,
        lambda g, s, p, lr: jopt.sgdm_update(g, s, p, lr=lr,
                                             momentum=MOMENTUM),
        lambda t: LR, cr=CR, param_template=jp)
    rates = jnp.ones((1,), jnp.float32)
    with jax.set_mesh(mesh):
        jp1, js1, jm1 = jax.jit(jd)(jp, jopt.sgdm_init(jp), jb, rates,
                                    jnp.asarray(0))
        jp2, js2, jm2 = jax.jit(jc)(jp1, js1, jb, rates, jnp.asarray(1))
    # the port starts the compressed step from the reference's state
    tp1 = params_from_jax(jax.tree.map(np.asarray, jp1), tcfg, device="cpu")
    ts1 = sgdm_state_from_jax(jax.tree.map(np.asarray, js1), tcfg,
                              device="cpu")
    ctx = RunCtx(device="cpu", loss_chunk=16)
    td, tc, tk, tn = make_ddp_steps(
        tcfg, ctx,
        lambda g, s, p, lr: topt.sgdm_update(g, s, p, lr=lr,
                                             momentum=MOMENTUM),
        lambda t: LR, CR, tp)
    trates = torch.ones(1)
    tpd, tsd, tmd = td(tp, topt.sgdm_init(tp), tb, trates, 0)
    tp2, ts2, tm2 = tc(tp1, ts1, tb, trates, 1)
    return dict(jk=jk, jn=jn, tk=tk, tn=tn, jm1=jm1, jm2=jm2, jp1=jp1,
                jp2=jp2, js1=js1, js2=js2, tmd=tmd, tm2=tm2, tpd=tpd, tsd=tsd,
                tp1=tp1, tp2=tp2, ts2=ts2)


def test_ddp_dense_step_matches_jax(ddp_pair):
    """Loss to rel 1e-6; params and momentum after one step to 1e-6 abs
    (lr 1e-2 times gradients that agree to 2e-5 abs, 1e-3 rel)."""
    r = ddp_pair
    assert (r["tk"], r["tn"]) == (r["jk"], r["jn"])
    np.testing.assert_allclose(float(r["tmd"]["loss"]),
                               float(r["jm1"]["loss"]), rtol=1e-6)
    assert float(r["tmd"]["gap"]) == 0.0
    _assert_trees_close(r["tpd"], r["jp1"], atol=1e-6, rtol=0)
    _assert_trees_close(r["tsd"]["mom"], r["js1"]["mom"], atol=3e-5,
                        rtol=1e-3)


def test_ddp_compressed_step_matches_jax(ddp_pair):
    """From the same params and momentum: loss to rel 1e-6, gap to 1e-5
    abs.  Survivors: the two top-k index sets may differ only where the
    port's and the reference's gradients, which agree to 2e-5, reorder
    magnitudes around the k-th; at most 0.1 % of k differ.  Params to 1e-6
    abs (a survivor that differs moves its param by at most lr times the
    k-th magnitude), momentum wherever both kept the same survivors."""
    r = ddp_pair
    np.testing.assert_allclose(float(r["tm2"]["loss"]),
                               float(r["jm2"]["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(r["tm2"]["gap"]),
                               float(r["jm2"]["gap"]), atol=1e-5)
    assert 0.0 < float(r["tm2"]["gap"]) < 1.0
    # survivors: positions where the momentum took the sparse aggregate
    jmom = np.concatenate([np.asarray(x).ravel()
                           for x in jax.tree.leaves(r["js2"]["mom"])])
    jmom1 = np.concatenate([np.asarray(x).ravel()
                            for x in jax.tree.leaves(r["js1"]["mom"])])
    tmom = torch.cat([x.reshape(-1) for x in leaves(r["ts2"]["mom"])]).numpy()
    jsel = np.flatnonzero(jmom != np.float32(MOMENTUM) * jmom1)
    tsel = np.flatnonzero(tmom != np.float32(MOMENTUM) * jmom1)
    k = r["jk"]
    assert abs(len(jsel) - k) <= k // 100 and abs(len(tsel) - k) <= k // 100
    differ = len(np.setxor1d(jsel, tsel))
    assert differ <= k // 1000, f"{differ} survivors differ of k={k}"
    _assert_trees_close(r["tp2"], r["jp2"], atol=1e-6, rtol=0)
    same = np.setdiff1d(np.arange(jmom.size), np.setxor1d(jsel, tsel))
    np.testing.assert_allclose(tmom[same], jmom[same], atol=3e-5, rtol=1e-3)


def test_ddp_scatter_agg_switch_gives_the_same_bits():
    """use_scatter_agg True (the wrapper: its plain version on CPU tensors)
    and False (the index_put_ chain) give identical steps; ``on_phase``
    sees each step's phases in order."""
    _, tcfg = _cfgs()
    tp = _noisy_params(*_cfgs())[1]
    _, tb = _batch(tcfg, b=2, s=16, seed=2)
    ctx = RunCtx(device="cpu", loss_chunk=16, remat=False)
    outs, phases = [], []
    for flag in (True, False):
        dense, step, _, _ = make_ddp_steps(
            tcfg, ctx, lambda g, s, p, lr: topt.sgdm_update(g, s, p, lr=lr),
            lambda t: LR, CR, tp, use_scatter_agg=flag,
            on_phase=phases.append)
        outs.append(step(tp, topt.sgdm_init(tp), tb, torch.ones(1), 0))
    for a, b in zip(leaves(outs[0][0]), leaves(outs[1][0])):
        assert torch.equal(a, b)
    dense(tp, topt.sgdm_init(tp), tb, torch.ones(1), 0)
    assert phases == 2 * ["fwd_bwd", "topk", "aggregate", "update"] + [
        "fwd_bwd", "aggregate", "update"]


# ---------------------------------------------------------------------------
# two gloo ranks

_GLOO_SCRIPT = textwrap.dedent(r"""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core.compression import flatten_grads, global_topk
    from repro_torch.kernels.scatter_agg import scatter_aggregate_ref
    from repro_torch.models import RunCtx, init_params
    from repro_torch.optim.optimizers import sgdm_init, sgdm_update
    from repro_torch.train.ddp import make_ddp_steps
    from repro_torch.train.step import make_loss_fn
    from repro_torch.tree import leaves, unflatten

    rank, store_path = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, 2), rank=rank, world_size=2)
    torch.manual_seed(0)
    cfg = get_config("qwen2-0.5b").reduced()
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    ctx = RunCtx(device="cpu", loss_chunk=16, remat=False)
    seen = {}

    def capture(g, s, p, lr):
        seen["agg"] = torch.cat([x.reshape(-1) for x in leaves(g)])
        return sgdm_update(g, s, p, lr=lr)

    _, comp_step, k, n = make_ddp_steps(cfg, ctx, capture, lambda t: 1e-2,
                                        0.1, params)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (4, 17)).astype(np.int64))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    rates = torch.tensor([1.0, 3.0])
    new_p, _, m = comp_step(params, sgdm_init(params), batch, rates, 0)

    # this rank's packet, made again outside the step
    live = [p.clone().requires_grad_() for p in leaves(params)]
    total, _ = make_loss_fn(cfg, ctx)(
        unflatten(params, live), {kk: v[2 * rank:2 * rank + 2]
                                  for kk, v in batch.items()})
    flat, _ = flatten_grads(unflatten(params, list(
        torch.autograd.grad(total, live))))
    vals, idx = global_topk(flat, k)
    vals = vals * (rates[rank] / rates.sum())
    vals_all = [torch.empty_like(vals) for _ in range(2)]
    idx_all = [torch.empty_like(idx) for _ in range(2)]
    dist.all_gather(vals_all, vals)
    dist.all_gather(idx_all, idx)
    ref = scatter_aggregate_ref(torch.stack(vals_all), torch.stack(idx_all),
                                n)
    shared = len(set(idx_all[0].tolist()) & set(idx_all[1].tolist()))
    same = [bool(torch.equal(a, b)) for a, b in
            zip(leaves(new_p), leaves(params))]
    print(json.dumps({
        "rank": rank, "bit_exact": bool(torch.equal(seen["agg"], ref)),
        "shared": shared, "k": k, "loss": float(m["loss"]),
        "gap": float(m["gap"]), "moved": not all(same)}))
    dist.destroy_process_group()
""")


def test_compressed_step_on_two_gloo_ranks(tmp_path):
    """Two ranks on the CPU (gloo, FileStore): each rank's aggregate equals
    scatter_aggregate_ref of both ranks' packets in rank order, bit for
    bit, with many indices shared across the packets; loss and gap agree
    across ranks."""
    script = tmp_path / "ranks.py"
    script.write_text(_GLOO_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), store],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for r in range(2)]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-3000:]
            results.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
    for r in results:
        assert r["bit_exact"], r
        assert r["shared"] > r["k"] // 4, r
        assert r["moved"]
    assert results[0]["loss"] == results[1]["loss"]
    assert results[0]["gap"] == results[1]["gap"]
