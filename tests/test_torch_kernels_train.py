"""The training kernels' plain versions against the JAX package.

``block_topk``, ``fused_sgdm`` and ``scatter_aggregate`` of the port run
their plain versions on CPU tensors (the CUDA kernels run only on the card,
where ``chip_smoke.py`` holds them against these plain versions).  Inputs
are made with numpy from a seed and handed to both packages.  The JAX side
runs ``block_topk`` and ``fused_sgdm`` in interpret mode and the oracles of
``repro/kernels/ref.py``; its Pallas ``scatter_aggregate`` raises under
this jax, so the reference there is the ``.at[].add`` chain it is pinned
to.  Bounds are the reference's: bit-exact for block top-k and the
aggregate (tests/test_kernels.py, BENCH_scadles.json), rtol 1e-4 and atol
1e-7 for fused SGDM (tests/test_kernels.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.block_topk import block_topk as jax_block_topk  # noqa: E402
from repro_torch.kernels import block_topk as bt  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import scatter_agg as sa  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(a, dtype="float32"):
    jdt, tdt = DTYPES[dtype]
    a = np.asarray(a, np.float32)
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a.copy()).to(tdt)


def _np(x):
    """A torch or jax array as f32 numpy (exact for bf16)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _blocks(rows, bs, seed, special=True):
    """Gaussian rows; with ``special``, row 0 all zero, row 1 all ones
    (every entry ties at the threshold), row 2 a few heavy ties."""
    g = np.random.default_rng(seed).standard_normal((rows, bs))
    if special:
        g[0] = 0.0
        g[1] = 1.0
        g[2, ::3] = 0.5
        g[2, 1::3] = -0.5
    return g.astype(np.float32)


# ---------------------------------------------------------------------------
# block_topk


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,bs,frac", [(8, 128, 0.01), (8, 128, 0.9),
                                          (24, 256, 0.1), (16, 1024, 0.1)])
def test_block_topk_ref_bit_exact_with_jax(rows, bs, frac, dtype):
    k = max(1, int(frac * bs))
    gj, gt = _both(_blocks(rows, bs, rows + bs), dtype)
    out_j, cnt_j = jref.block_topk_ref(gj, k)
    out_t, cnt_t = bt.block_topk_ref(gt, k)
    assert out_t.dtype == gt.dtype and cnt_t.dtype == torch.int32
    np.testing.assert_array_equal(_np(out_t), _np(out_j))
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    assert cnt_t[0, 0] == 0                     # all-zero row keeps none
    assert cnt_t[1, 0] == bs                    # a row of ties keeps all


def test_block_topk_wrapper_matches_jax_kernel_interpret():
    """The wrapper (its plain version on the CPU) against the reference's
    Pallas kernel run in interpret mode."""
    gj, gt = _both(_blocks(16, 1024, 5))
    out_j, cnt_j = jax_block_topk(gj, 102, interpret=True)
    before = dict(bt.launches)
    out_t, cnt_t = bt.block_topk(gt, 102)
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    assert bt.launches == before                # CPU: no kernel launched


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [5000, 8192, 1000])
def test_ops_block_topk_sparsify_and_counts_match_jax(n, dtype):
    """n off a block multiple (5000, 1000) and an exact one (8192 = 8 rows,
    no row padding); counts trimmed to ceil(n / bs) rows."""
    g = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    g[:700] = 0.0                               # a zero block at the start
    gj, gt = _both(g, dtype)
    sj = jops.block_topk_sparsify(gj, 0.1)
    st = ops.block_topk_sparsify(gt, 0.1)
    np.testing.assert_array_equal(_np(st), _np(sj))
    vj, cj = jops.block_topk_counts(gj, 0.05, block_size=256)
    vt, ct = ops.block_topk_counts(gt, 0.05, block_size=256)
    np.testing.assert_array_equal(_np(vt), _np(vj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert ct.shape == (-(-n // 256),)


def test_block_topk_vjp_matches_jax():
    """Straight-through mask: the gradient of sum(out * w) is w on the
    survivors and 0 elsewhere, as ``jax.vjp`` of the reference gives."""
    rng = np.random.default_rng(3)
    g = _blocks(8, 128, 4)
    w = rng.standard_normal(g.shape).astype(np.float32)
    gj = jnp.asarray(g)
    _, vjp = jax.vjp(lambda x: jax_block_topk(x, 13, interpret=True)[0], gj)
    dj, = vjp(jnp.asarray(w))
    gt = torch.from_numpy(g).requires_grad_()
    out, cnt = bt.block_topk(gt, 13)
    assert not cnt.requires_grad
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(gt.grad.numpy(), np.asarray(dj))


@pytest.mark.parametrize("bad", ["block", "ndim", "float16", "layout"])
def test_block_topk_kernel_checks_its_input(bad):
    """The CUDA path refuses what the kernel does not take, before any
    build (so the check runs here on CPU tensors)."""
    g = torch.zeros((4, 1024))
    if bad == "block":
        g = torch.zeros((4, 1000))
    elif bad == "ndim":
        g = torch.zeros(4096)
    elif bad == "float16":
        g = g.half()
    else:
        g = torch.zeros((1024, 4)).T
    with pytest.raises((ValueError, TypeError)):
        bt._block_topk_kernel(g, 10)


# ---------------------------------------------------------------------------
# fused_sgdm


@pytest.mark.parametrize("momentum,wd", [(0.9, 0.0), (0.9, 0.01), (0.0, 0.0),
                                         (0.0, 0.01)])
def test_fused_sgdm_matches_jax(momentum, wd):
    rng = np.random.default_rng(11)
    p, m, g = (rng.standard_normal((16, 1024)).astype(np.float32)
               for _ in range(3))
    lr = 0.05
    pj, mj = jref.fused_sgdm_ref(jnp.asarray(p), jnp.asarray(m),
                                 jnp.asarray(g), lr, momentum, wd)
    pt, mt = bt.fused_sgdm(torch.from_numpy(p), torch.from_numpy(m),
                           torch.from_numpy(g), torch.tensor(lr), momentum,
                           wd)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-4,
                               atol=1e-7)
    assert mt.dtype == torch.float32


@pytest.mark.parametrize("n", [1000, 4096, 3])
def test_fused_sgdm_flat_matches_jax_kernel_interpret(n):
    """Odd lengths: the reference pads to blocks, the port needs no pad."""
    rng = np.random.default_rng(n)
    p, m, g = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    pj, mj = jops.fused_sgdm_flat(jnp.asarray(p), jnp.asarray(m),
                                  jnp.asarray(g), 0.1, momentum=0.9,
                                  weight_decay=0.01)
    pt, mt = ops.fused_sgdm_flat(torch.from_numpy(p), torch.from_numpy(m),
                                 torch.from_numpy(g), 0.1, momentum=0.9,
                                 weight_decay=0.01)
    assert pt.shape == (n,)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-4,
                               atol=1e-7)


def test_fused_sgdm_bf16_params_keep_f32_momentum():
    rng = np.random.default_rng(2)
    p, m, g = (rng.standard_normal(256).astype(np.float32) for _ in range(3))
    pj, mj = jref.fused_sgdm_ref(jnp.asarray(p).astype(jnp.bfloat16),
                                 jnp.asarray(m),
                                 jnp.asarray(g).astype(jnp.bfloat16), 0.1)
    pt, mt = bt.fused_sgdm(torch.from_numpy(p).bfloat16(),
                           torch.from_numpy(m),
                           torch.from_numpy(g).bfloat16(), 0.1)
    assert pt.dtype == torch.bfloat16 and mt.dtype == torch.float32
    np.testing.assert_array_equal(_np(pt), _np(pj))
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-4,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# scatter_aggregate


def _agg_jax(vals, idx, n):
    return (jnp.zeros((n,), vals.dtype)
            .at[idx.reshape(-1)].add(vals.reshape(-1)))


def _packets(D, k, n, seed, dup=True):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.permutation(n)[:k] for _ in range(D)])
    if dup:      # cross-packet duplicates, up to 4-way
        idx[1, :8] = idx[0, :8]
        idx[2, :4] = idx[0, :4]
        idx[3, :4] = idx[0, :4]
    vals = (rng.standard_normal((D, k)) * 1e3).astype(np.float32)
    vals[0, 0] = -0.0           # -0.0 added onto +0.0 gives +0.0
    return vals, idx.astype(np.int32)


@pytest.mark.parametrize("D,k,n,dup", [(4, 32, 1000, True),
                                       (1, 16, 200, False)])
def test_scatter_aggregate_bit_exact_with_jax_chain(D, k, n, dup):
    vals, idx = _packets(D, k, n, D + k, dup)
    ref = _agg_jax(jnp.asarray(vals), jnp.asarray(idx), n)
    before = sa.launches
    out = sa.scatter_aggregate(torch.from_numpy(vals),
                               torch.from_numpy(idx), n)
    assert out.dtype == torch.float32 and out.shape == (n,)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert np.signbit(out.numpy()).sum() == np.signbit(np.asarray(ref)).sum()
    assert sa.launches == before


def test_scatter_aggregate_packet_order_matters_and_is_kept():
    """Three packets on one index whose sum depends on the order: the
    result is the reference's left-to-right order."""
    vals = np.array([[1e8], [1.0], [-1e8]], np.float32)
    idx = np.zeros((3, 1), np.int32)
    ref = _agg_jax(jnp.asarray(vals), jnp.asarray(idx), 2)
    out = sa.scatter_aggregate_ref(torch.from_numpy(vals),
                                   torch.from_numpy(idx), 2)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert out[0] == 0.0        # (1e8 + 1) rounds to 1e8 in f32


@pytest.mark.parametrize("bad", ["dtype", "idx64", "shape", "layout"])
def test_scatter_aggregate_checks_its_input(bad):
    vals = torch.zeros((2, 8))
    idx = torch.zeros((2, 8), dtype=torch.int32)
    if bad == "dtype":
        vals = vals.double()
    elif bad == "idx64":
        idx = idx.long()
    elif bad == "shape":
        idx = idx[:, :4]
    else:
        vals = torch.zeros((8, 2)).T
    with pytest.raises((ValueError, TypeError)):
        sa._check(vals, idx, 100)


@pytest.mark.parametrize("fn", ["block_topk", "fused_sgdm",
                                "scatter_aggregate"])
def test_wrappers_refuse_other_devices(fn):
    """A tensor neither on the CPU nor on a card gets an error, not the
    plain version: the plain version runs for CPU tensors only."""
    x = torch.zeros((8, 128), device="meta")
    with pytest.raises(ValueError, match="device"):
        if fn == "block_topk":
            bt.block_topk(x, 4)
        elif fn == "fused_sgdm":
            bt.fused_sgdm(x, x, x, 0.1)
        else:
            sa.scatter_aggregate(x, x.int(), 10)
