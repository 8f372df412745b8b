"""The arithmetic and the schedule of the port's prefill kernel, on the CPU.

The CUDA kernel (``csrc/flash_attention.cu``) runs f32 attention as
3xTF32 wgmma products (each operand split into hi = tf32(x) and lo =
tf32(x - hi), rounded to nearest), an online softmax in base 2 with the
scale folded into one multiply, and P V with the keys of each 8-key group
permuted so that the tf32 accumulator fragment of S serves as the A
fragment of P V.  f32 at hd 256 splits the head dim over a cluster of two
blocks: each forms its partial S over its 128 dims, the two partials are
summed, and each block runs the shared softmax and its half of P V.  Its
schedule is :func:`tile_plan` below (queries per
block from ``kernels/flash_attention.py::query_tile``).  The kernel runs
only on the card; here a plain PyTorch model of that arithmetic, driven by
that schedule, with TF32 rounding emulated on the f32 bit pattern, is held
against the reference's ``chunked_attention`` (its jax path) at the
reference's oracle tolerance, 2e-5 in f32 and 2e-2 in bf16
(tests/test_kernels_flash.py), and the schedule against the mask.  Inputs
come from numpy with a seed.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.models.attention import chunked_attention as jax_chunked  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

NEG_INF = -1e30
LOG2E = 1.4426950408889634
# position c of an 8-key group holds key 2c, position c + 4 key 2c + 1
PERM = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])


def head_split(hd, dtype):
    """Blocks a head's dims are split over (``Cfg::SPLIT``): two for f32 at
    hd 256, whose Q and K/V planes do not fit one block's shared memory."""
    return 2 if dtype == torch.float32 and hd == 256 else 1


def key_tile(hd, dtype):
    """Keys per tile (``Cfg::BK`` in the source), from the dims a block
    holds: 32 where a tile of 64 would not fit shared memory (256 dims;
    f32 at 128, so also f32 hd 256 split in two), else 64."""
    w = hd // head_split(hd, dtype)
    return 32 if w >= 256 or (dtype == torch.float32 and w >= 128) else 64


def key_tiles(qpos_first, qpos_last, sk, kind, window, bk):
    """The key tiles a block of queries [qpos_first, qpos_last] visits
    (``key_tiles`` in the source): none past the causal diagonal of its
    last query, none before the window of its first."""
    k_lo, k_hi = 0, sk
    if kind != "bidir":
        k_hi = min(sk, qpos_last + 1)
        if kind == "swa" and window > 0:
            k_lo = max(0, qpos_first - window + 1)
    k_lo = k_lo // bk * bk
    return range(k_lo, max(k_hi, k_lo), bk)


def tile_plan(sq, sk, hd, dtype, *, kind="causal", window=0, q_offset=0):
    """The kernel's schedule: for each group of 64 query rows (one consumer
    warpgroup) its first row, its valid rows and the key tiles it
    multiplies: its block's tiles, less those past the group's own
    diagonal.  (With a split, the two blocks of a cluster share one group
    of 64 queries and its tiles.)"""
    bq, bk = fa.query_tile(sq, hd, dtype), key_tile(hd, dtype)
    plan = []
    for q0 in range(0, sq, bq):
        tiles = key_tiles(q_offset + q0, q_offset + min(q0 + bq, sq) - 1,
                          sk, kind, window, bk)
        for row0 in range(q0, min(q0 + bq, sq), 64):
            last = q_offset + min(row0 + 64, sq) - 1
            mine = [kt for kt in tiles if kind == "bidir" or kt <= last]
            plan.append((row0, min(64, sq - row0), mine))
    return plan, bk


def tf32(x):
    """cvt.rna.tf32.f32: keep 10 mantissa bits, ties away from zero."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm3(a, b):
    """a (..., m, k) times b (..., n, k)^T as the kernel's three tf32
    products, lo*hi + hi*lo + hi*hi, each exact in f32, summed in f32."""
    ah, al = split(a)
    bh, bl = split(b)
    bt = lambda t: t.transpose(-1, -2)  # noqa: E731
    return al @ bt(bh) + ah @ bt(bl) + ah @ bt(bh)


def mm1(a, b):
    """One tf32 product, for contrast."""
    return tf32(a) @ tf32(b).transpose(-1, -2)


def masked_scores(s, qpos, kpos, sk, kind, window):
    """The kernel's mask on raw scores s (rows qpos, columns kpos)."""
    ok = torch.ones_like(s, dtype=torch.bool)
    if kind != "bidir":
        ok = kpos[None, :] <= qpos[:, None]
        if kind == "swa" and window > 0:
            ok &= kpos[None, :] > qpos[:, None] - window
    return ok, (kpos >= sk)[None, :].expand_as(s)


def kernel_model(q, k, v, *, kind="causal", window=0, q_offset=0,
                 dtype=torch.float32, product=mm3, permute=True, split=None):
    """The kernel's algorithm in plain PyTorch: per 64-row group and per
    key tile of ``tile_plan``, S by ``product``, masked, scaled into base 2
    (scale * log2 e in f32), the online softmax with exp2, P V (keys of
    each 8-key group permuted for f32; P rounded to bf16 for bf16), and one
    division by max(l, 1e-30).  With a split (``head_split`` unless
    ``split`` is given), S is the sum of the blocks' partial products over
    their dims, taken in block order, and each block's P V fills its dims
    of O."""
    b, sq, h, hd = q.shape
    n_split = head_split(hd, dtype) if split is None else split
    w = hd // n_split
    _, sk, kvh, _ = k.shape
    g = h // kvh
    plan, bk = tile_plan(sq, sk, hd, dtype, kind=kind, window=window,
                            q_offset=q_offset)
    sl2 = torch.tensor(hd ** -0.5, dtype=torch.float32) * \
        torch.tensor(LOG2E, dtype=torch.float32)
    qf, kf, vf = (t.float() for t in (q, k, v))
    pad = bk * math.ceil(sk / bk) - sk
    kf = torch.nn.functional.pad(kf, (0, 0, 0, 0, 0, pad))  # TMA zero fill
    vf = torch.nn.functional.pad(vf, (0, 0, 0, 0, 0, pad))
    out = torch.zeros(b, sq, h, hd)
    for bi in range(b):
        for head in range(h):
            kh = head // g
            for row0, rows, tiles in plan:
                qg = qf[bi, row0:row0 + rows, head]
                qpos = q_offset + row0 + torch.arange(rows)
                m = torch.full((rows,), NEG_INF)
                l = torch.zeros(rows)
                acc = torch.zeros(rows, hd)
                for kt in tiles:
                    kt_ = kf[bi, kt:kt + bk, kh]
                    vt_ = vf[bi, kt:kt + bk, kh]
                    kpos = kt + torch.arange(bk)
                    if dtype == torch.float32:
                        s = product(qg[:, :w], kt_[:, :w])
                        for r in range(1, n_split):
                            s = s + product(qg[:, r * w:(r + 1) * w],
                                            kt_[:, r * w:(r + 1) * w])
                    else:
                        s = qg @ kt_.T
                    ok, past = masked_scores(s, qpos, kpos, sk, kind, window)
                    s = torch.where(ok, s * sl2, NEG_INF)
                    s = torch.where(past, -torch.inf, s)
                    m_new = torch.maximum(m, s.amax(1))
                    alpha = torch.exp2(m - m_new)
                    p = torch.exp2(s - m_new[:, None])
                    l = l * alpha + p.sum(1)
                    m = m_new
                    if dtype == torch.float32:
                        if permute:
                            idx = (torch.arange(bk) // 8 * 8
                                   + PERM.repeat(bk // 8))
                            p, vt_ = p[:, idx], vt_[idx]
                        pv = torch.cat([product(
                            p, vt_[:, r * w:(r + 1) * w].T.contiguous())
                            for r in range(n_split)], dim=1)
                    else:
                        pv = p.to(torch.bfloat16).float() @ vt_
                    acc = acc * alpha[:, None] + pv
                out[bi, row0:row0 + rows, head] = \
                    acc / torch.clamp(l, min=1e-30)[:, None]
    return out.to(q.dtype)


def _both(shape, seed, dtype="float32"):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        return (jnp.asarray(a).astype(jnp.bfloat16),
                torch.from_numpy(a).to(torch.bfloat16))
    return jnp.asarray(a), torch.from_numpy(a)


def _inputs(b, sq, sk, h, kvh, hd, seed, dtype="float32"):
    return [_both(s, seed + i, dtype) for i, s in enumerate(
        [(b, sq, h, hd), (b, sk, kvh, hd), (b, sk, kvh, hd)])]


def _err(out_t, ref_j, tol):
    out = out_t.float().numpy()
    ref = np.asarray(ref_j, np.float32)
    return float(np.max(np.abs(out - ref) - tol * np.abs(ref)))


# ---------------------------------------------------------------------------
# 3xTF32 holds the f32 limit; one tf32 pass does not


@pytest.mark.parametrize("hd", [32, 64, 128, 256])
def test_three_tf32_products_hold_the_f32_limit(hd):
    b, sq, sk, h, kvh = 1, 80, 80, 2, 1
    (qj, qt), (kj, kt), (vj, vt) = _inputs(b, sq, sk, h, kvh, hd, 10 + hd)
    ref = jax_chunked(qj, kj, vj, kind="causal")
    out = kernel_model(qt, kt, vt, kind="causal")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("hd", [64, 128])
def test_one_tf32_product_misses_the_f32_limit(hd):
    """The emulation bites: a single tf32 pass errs by far more than
    2e-5, so the three products are what holds the limit."""
    b, sq, sk, h, kvh = 1, 80, 80, 2, 1
    (qj, qt), (kj, kt), (vj, vt) = _inputs(b, sq, sk, h, kvh, hd, 20 + hd)
    ref = jax_chunked(qj, kj, vj, kind="causal")
    out = kernel_model(qt, kt, vt, kind="causal", product=mm1)
    assert _err(out, ref, 2e-5) > 2e-5 * 10


def test_tf32_rounding_is_to_nearest_ties_away():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -11 + 2 ** -20,
                      -(1.0 + 2 ** -11), 1.0 + 2 ** -12, 3.0])
    want = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -10, -(1.0 + 2 ** -10),
                         1.0, 3.0])
    assert torch.equal(tf32(x), want)
    hi, lo = split(torch.tensor([math.pi]))
    assert abs(float(hi) + float(lo) - math.pi) < 2 ** -21 * math.pi


# ---------------------------------------------------------------------------
# the whole kernel model against the reference: masks, offsets, ragged
# edges, GQA, dtypes

MODEL_CASES = [
    # (b, sq, sk, h, kvh, hd, kind, window, q_offset, dtype)
    (2, 128, 128, 4, 2, 64, "causal", 0, 0, "float32"),
    (1, 96, 128, 4, 2, 64, "swa", 48, 32, "float32"),
    (2, 24, 40, 4, 2, 64, "causal", 0, 16, "float32"),
    (1, 100, 100, 4, 2, 128, "bidir", 0, 0, "float32"),
    (1, 150, 150, 2, 1, 256, "swa", 64, 0, "float32"),
    (1, 200, 200, 6, 1, 128, "causal", 0, 0, "float32"),
    (1, 64, 256, 2, 1, 64, "causal", 0, 192, "float32"),
    (1, 130, 130, 2, 2, 32, "causal", 0, 0, "float32"),
    (1, 128, 128, 4, 2, 64, "causal", 0, 0, "bfloat16"),
    (1, 100, 100, 4, 2, 64, "swa", 30, 0, "bfloat16"),
    (1, 200, 200, 6, 1, 128, "causal", 0, 0, "bfloat16"),
    (1, 70, 70, 2, 1, 256, "bidir", 0, 0, "bfloat16"),
    # f32 hd 256, split over a cluster: ragged causal, bidir, a 64-query
    # chunk past the window (recurrentgemma's, at a reduced h), g 10
    (1, 130, 130, 2, 1, 256, "causal", 0, 0, "float32"),
    (1, 100, 100, 2, 1, 256, "bidir", 0, 0, "float32"),
    (1, 64, 4096, 2, 1, 256, "swa", 2048, 4032, "float32"),
    (1, 96, 96, 10, 1, 256, "swa", 48, 0, "float32"),
]


@pytest.mark.parametrize("case", MODEL_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_kernel_model_matches_jax(case):
    b, sq, sk, h, kvh, hd, kind, window, off, dt = case
    (qj, qt), (kj, kt), (vj, vt) = _inputs(b, sq, sk, h, kvh, hd, 31, dt)
    ref = jax_chunked(qj, kj, vj, kind=kind, window=window, q_offset=off)
    out = kernel_model(qt, kt, vt, kind=kind, window=window, q_offset=off,
                       dtype=qt.dtype)
    tol = 2e-2 if dt == "bfloat16" else 2e-5
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


def test_head_split_only_reorders_the_sums():
    """The split's S is the 3xTF32 sum over hd 256 taken as two sums of 128
    dims: against one block over all 256 it moves O by f32 rounding only,
    far inside the 2e-5 limit."""
    assert head_split(256, torch.float32) == 2
    assert head_split(256, torch.bfloat16) == 1
    assert head_split(128, torch.float32) == 1
    (qj, qt), (kj, kt), (vj, vt) = _inputs(1, 80, 80, 2, 1, 256, 51)
    two = kernel_model(qt, kt, vt, kind="causal")
    one = kernel_model(qt, kt, vt, kind="causal", split=1)
    torch.testing.assert_close(two, one, rtol=2e-6, atol=2e-6)


# ---------------------------------------------------------------------------
# the exp2 online softmax with the folded scale, alone (exact f32 products)


@pytest.mark.parametrize("bk", [16, 32, 64])
def test_exp2_online_softmax_with_folded_scale(bk):
    rng = np.random.default_rng(bk)
    s = torch.from_numpy(rng.standard_normal((8, 200)).astype(np.float32)) * 9
    v = torch.from_numpy(rng.standard_normal((200, 16)).astype(np.float32))
    scale = 64 ** -0.5
    want = torch.softmax(s.double() * scale, dim=1) @ v.double()
    sl2 = torch.tensor(scale, dtype=torch.float32) * \
        torch.tensor(LOG2E, dtype=torch.float32)
    m = torch.full((8,), NEG_INF)
    l = torch.zeros(8)
    acc = torch.zeros(8, 16)
    for kt in range(0, 200, bk):
        t = s[:, kt:kt + bk] * sl2
        m_new = torch.maximum(m, t.amax(1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(t - m_new[:, None])
        l = l * alpha + p.sum(1)
        acc = acc * alpha[:, None] + p @ v[kt:kt + bk]
        m = m_new
    torch.testing.assert_close((acc / l[:, None]).double(), want,
                               rtol=2e-6, atol=2e-6)


def test_fully_masked_row_keeps_the_finite_floor():
    """A row whose window holds no key: its block visits no tile, and the
    max(l, 1e-30) floor gives 0, never NaN.  (A row that visits only
    masked keys gets exp2(NEG_INF - NEG_INF) = 1 for each, as the TPU
    kernel's finite NEG_INF gives.)"""
    q = torch.zeros(1, 1, 1, 32)
    k = torch.zeros(1, 64, 1, 32)
    v = torch.arange(64.0)[None, :, None, None].expand(1, 64, 1, 32)
    out = kernel_model(q, k, v.contiguous(), kind="swa", window=4,
                       q_offset=200)
    assert torch.isfinite(out).all()


def test_wrapper_refuses_a_window_that_holds_no_key():
    """The smallest input of the fault: the kernel would return 0 and the
    plain version 31.5 (the mean of the key indices); the wrapper and the
    plain version refuse it, as the reference's chunked_attention does."""
    q = torch.zeros(1, 1, 1, 32)
    k = torch.zeros(1, 64, 1, 32)
    v = torch.arange(64.0)[None, :, None, None].expand(1, 64, 1, 32)
    for fn in (fa.flash_attention, fa.flash_attention_ref):
        with pytest.raises(ValueError, match="no key"):
            fn(q, k, v.contiguous(), kind="swa", window=4, q_offset=200)
    with pytest.raises(ValueError, match="no key"):
        fa.flash_attention(q, k, v.contiguous(), kind="swa", window=4,
                           q_offset=67)          # on the bound: 67 + 1 - 4
    # the same call with a window that reaches back to the keys is served
    out = fa.flash_attention(q, k, v.contiguous(), kind="swa", window=201,
                             q_offset=200)
    assert float(out[0, 0, 0, 0]) == pytest.approx(31.5)


@pytest.mark.parametrize("sq,window,q_offset", [
    (1, 4, 66),        # one query, its window holds key 63 only
    (16, 8, 55),       # the last query sees key 63 only; earlier ones more
    (64, 32, 31),      # a chunk: 31 + 64 - 32 = 63 = sk - 1
    (1, 64, 126),
])
def test_windows_just_inside_the_bound_match_jax(sq, window, q_offset):
    """q_offset + sq - window = sk - 1: the last query's window holds one
    key; the plain version, the wrapper on the CPU and the kernel model all
    keep parity with the reference's chunked_attention there."""
    sk, h, kvh, hd = 64, 2, 1, 64
    assert q_offset + sq - window == sk - 1
    (qj, qt), (kj, kt), (vj, vt) = _inputs(1, sq, sk, h, kvh, hd, 5,
                                           "float32")
    ref = np.asarray(jax_chunked(qj, kj, vj, kind="swa", window=window,
                                 q_offset=q_offset), np.float32)
    for out in (fa.flash_attention(qt, kt, vt, kind="swa", window=window,
                                   q_offset=q_offset),
                fa.flash_attention_ref(qt, kt, vt, kind="swa",
                                       window=window, q_offset=q_offset),
                kernel_model(qt, kt, vt, kind="swa", window=window,
                             q_offset=q_offset, dtype=qt.dtype)):
        np.testing.assert_allclose(out.float().numpy(), ref, rtol=2e-5,
                                   atol=2e-5)


# ---------------------------------------------------------------------------
# the key permutation leaves P V unchanged and matches the fragments


def test_permutation_matches_the_tf32_fragments():
    """Lane c of a quad holds S columns {2c, 2c+1} of each 8-key group (the
    accumulator layout) and the A fragment wants positions {c, c + 4}: so
    position c must hold key 2c and position c + 4 key 2c + 1."""
    for c in range(4):
        assert int(PERM[c]) == 2 * c and int(PERM[c + 4]) == 2 * c + 1
    assert sorted(PERM.tolist()) == list(range(8))


@pytest.mark.parametrize("bk", [32, 64])
def test_permuted_keys_leave_pv_unchanged(bk):
    rng = np.random.default_rng(bk + 1)
    p = torch.from_numpy(rng.random((64, bk)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((bk, 64)).astype(np.float32))
    idx = torch.arange(bk) // 8 * 8 + PERM.repeat(bk // 8)
    # the same terms summed in another order: a few f32 ulps of ~4
    torch.testing.assert_close(mm3(p[:, idx], v[idx].T.contiguous()),
                               mm3(p, v.T.contiguous()), rtol=4e-6,
                               atol=4e-6)
    (qj, qt), (kj, kt), (vj, vt) = _inputs(1, 70, 70, 2, 1, 64, 41)
    a = kernel_model(qt, kt, vt, permute=True)
    b = kernel_model(qt, kt, vt, permute=False)
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the tile schedule: every unmasked pair is covered, every skipped tile is
# fully masked

PLAN_CASES = [
    # (sq, sk, hd, dtype, kind, window, q_offset)
    (128, 128, 64, torch.float32, "causal", 0, 0),
    (8192, 8192, 64, torch.float32, "causal", 0, 0),
    (64, 8192, 64, torch.float32, "causal", 0, 8128),
    (200, 200, 128, torch.float32, "causal", 0, 0),
    (200, 200, 128, torch.bfloat16, "causal", 0, 0),
    (96, 128, 64, torch.float32, "swa", 48, 32),
    (300, 300, 64, torch.bfloat16, "swa", 100, 0),
    (150, 150, 256, torch.float32, "swa", 64, 0),
    (150, 150, 256, torch.bfloat16, "swa", 64, 0),
    (100, 100, 128, torch.float32, "bidir", 0, 0),
    (65, 130, 32, torch.bfloat16, "bidir", 0, 0),
    (24, 40, 64, torch.float32, "causal", 0, 16),
    (1, 1, 64, torch.float32, "causal", 0, 0),
    (129, 257, 64, torch.float32, "causal", 0, 128),
    (64, 512, 64, torch.float32, "swa", 64, 448),
    (130, 130, 32, torch.float32, "swa", 0, 0),
    (64, 4096, 256, torch.float32, "swa", 2048, 4032),
]


def _visible(qpos, kpos, kind, window):
    ok = np.ones((len(qpos), len(kpos)), bool)
    if kind != "bidir":
        ok = kpos[None, :] <= qpos[:, None]
        if kind == "swa" and window > 0:
            ok &= kpos[None, :] > qpos[:, None] - window
    return ok


@pytest.mark.parametrize("case", PLAN_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_tile_plan_covers_every_unmasked_pair(case):
    sq, sk, hd, dtype, kind, window, off = case
    plan, bk = tile_plan(sq, sk, hd, dtype, kind=kind, window=window,
                            q_offset=off)
    assert [r0 for r0, _, _ in plan] == list(range(0, sq, 64))
    assert sum(rows for _, rows, _ in plan) == sq
    all_tiles = np.arange(0, sk, bk)
    for row0, rows, tiles in plan:
        qpos = off + row0 + np.arange(rows)
        assert all(0 <= kt < sk and kt % bk == 0 for kt in tiles)
        assert list(tiles) == sorted(set(tiles))
        for kt in all_tiles:
            kpos = kt + np.arange(min(bk, sk - kt))
            seen = _visible(qpos, kpos, kind, window).any()
            if kt not in tiles:
                assert not seen, (row0, kt)
            elif kind != "bidir":
                # a visited tile starts at or before the group's diagonal
                assert kt <= qpos[-1]


@pytest.mark.parametrize("sq,hd,dtype,want", [
    (128, 64, torch.float32, 128), (64, 64, torch.float32, 64),
    (65, 64, torch.float32, 128), (200, 128, torch.float32, 64),
    (200, 128, torch.bfloat16, 128), (8192, 256, torch.float32, 64),
    (8192, 256, torch.bfloat16, 128), (40, 32, torch.bfloat16, 64)])
def test_query_tile_by_call(sq, hd, dtype, want):
    """Two consumer warpgroups (128 queries) unless the call has at most
    64 queries (a scheduler chunk) or f32 Q planes fill shared memory."""
    assert fa.query_tile(sq, hd, dtype) == want


# ---------------------------------------------------------------------------
# the wrapper refuses what TMA cannot read


def test_check_aligned_refuses_a_view_off_by_one_element():
    """TMA needs a 16-byte aligned base: the wrapper's check raises on a
    contiguous view that starts one element into its buffer, and passes
    the buffer itself."""
    buf = torch.zeros(2 * 16 * 2 * 64 + 1)
    whole = buf[:-1].view(2, 16, 2, 64)
    shifted = buf[1:].view(2, 16, 2, 64)
    assert shifted.is_contiguous()
    fa.check_aligned(k=whole)
    with pytest.raises(ValueError, match="16-byte"):
        fa.check_aligned(k=shifted)
    with pytest.raises(ValueError, match="v starts"):
        fa.check_aligned(q=whole, v=shifted)


def test_check_aligned_refuses_an_odd_row_stride():
    """A row stride that is not a multiple of 16 bytes (a slice of a wider
    last dimension) is refused too."""
    wide = torch.zeros(2, 16, 2, 66)
    view = wide[..., :64]
    with pytest.raises(ValueError, match="strides"):
        fa.check_aligned(k=view)
    fa.check_aligned(k=torch.zeros(2, 16, 2, 64))
