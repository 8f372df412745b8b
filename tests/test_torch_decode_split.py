"""The split-K arithmetic of the port's flash-decode kernel, on the CPU.

The CUDA kernel (``csrc/flash_decode.cu``) splits each slot's keys over up
to eight blocks of a cluster by ``kernels/flash_decode.py::split_geometry``,
runs the online softmax over each split, and combines the splits' (m, l,
acc) in rank order.  The kernel runs only on the card; here a plain PyTorch
model of that algorithm, driven by the same geometry function, is held
against the reference's ``decode_attention`` (its jax path) at the
reference's decode tolerance, 2e-6 (tests/test_kernels_decode.py), and the
geometry function against its own rules.  Inputs come from numpy with a
seed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.models.attention import decode_attention as jax_decode  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402

NEG_INF = -1e30


def split_model(q, k, v, kv_len):
    """The kernel's algorithm in plain f32 PyTorch: per split of
    ``split_geometry`` its (m, l, acc) — keys at or past kv_len score
    NEG_INF, keys past the stream (or past the split) -inf — combined in
    rank order, divided by max(l, 1e-30) once.  Returns (out, parts)."""
    b, _, h, hd = q.shape
    _, S, kvh, _ = k.shape
    g = h // kvh
    nsplit, kps = fd.split_geometry(b, kvh, S)
    lens = torch.as_tensor(kv_len).to(torch.int64).reshape(-1).expand(b)
    n_valid = lens.clamp(0, S)
    n_stream = torch.where(n_valid > 0, n_valid, torch.full_like(n_valid, S))
    keys = torch.arange(S)
    s = torch.einsum("bkgd,bskd->bkgs", q.reshape(b, kvh, g, hd).float(),
                     k.float()) * hd ** -0.5
    s = torch.where((keys[None] < n_valid[:, None])[:, None, None], s,
                    NEG_INF)
    s = torch.where((keys[None] >= n_stream[:, None])[:, None, None],
                    -torch.inf, s)
    parts = []
    for r in range(nsplit):
        lo, hi = r * kps, min((r + 1) * kps, S)
        sr = s[..., lo:hi]
        m = sr.amax(-1)                                    # -inf: empty
        p = torch.exp(sr - torch.where(torch.isinf(m), 0.0, m)[..., None])
        acc = torch.einsum("bkgs,bskd->bkgd", p, v[:, lo:hi].float())
        parts.append((m, p.sum(-1), acc))
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    L = torch.zeros_like(M)
    O = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:                                # rank order
        w = torch.exp(m - M)
        L = L + l * w
        O = O + acc * w[..., None]
    out = O / torch.clamp(L, min=1e-30)[..., None]
    return out.reshape(b, 1, h, hd).to(q.dtype), parts


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _edge_lens(b, kvh, S, which):
    """kv_len at the split edges of (b, kvh, S): the low edges (0, 1, the
    first boundary - 1 and the boundary) or the high ones (boundary + 1,
    the second boundary - 1, S, S + 6)."""
    _, kps = fd.split_geometry(b, kvh, S)
    lens = ([0, 1, kps - 1, kps] if which == "low"
            else [kps + 1, 2 * kps - 1, S, S + 6])
    return lens[:b] + [S] * (b - len(lens))


# (b, h, kvh, hd, S): g 1, 7 and 16; hd 32, 64 and 256; S that the split
# size does not divide
GROUPS = {
    "g1-hd32": (4, 2, 2, 32, 200),
    "g7-hd64": (4, 14, 2, 64, 300),
    "g7-hd256": (4, 7, 1, 256, 130),
    "g16-hd32": (4, 32, 2, 32, 1000),
    "g16-hd256": (4, 16, 1, 256, 170),
}


@pytest.mark.parametrize("which", ["low", "high"])
@pytest.mark.parametrize("group", list(GROUPS))
def test_split_model_matches_reference(group, which):
    b, h, kvh, hd, S = GROUPS[group]
    nsplit, kps = fd.split_geometry(b, kvh, S)
    assert nsplit > 2 and S % kps, "the case must cross several splits"
    lens = _edge_lens(b, kvh, S, which)
    q, k, v = _arrays([(b, 1, h, hd), (b, S, kvh, hd), (b, S, kvh, hd)],
                      seed=S + h)
    ref = jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(lens, jnp.int32))
    out, _ = split_model(*(torch.from_numpy(a) for a in (q, k, v)),
                         torch.tensor(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-6)
    # and the wrapper's plain version, which the kernel is held to on the
    # card, agrees with the model on the same inputs
    plain = fd.flash_decode(*(torch.from_numpy(a) for a in (q, k, v)),
                            torch.tensor(lens, dtype=torch.int32))
    torch.testing.assert_close(out, plain, rtol=0, atol=2e-6)


@pytest.mark.parametrize("scalar_len", [0, 1, 33, 10_000])
def test_split_model_scalar_len(scalar_len):
    """A scalar kv_len: 0 streams every key (uniform average of NEG_INF
    scores), past S clamps to S."""
    b, h, kvh, hd, S = 2, 14, 2, 64, 96
    q, k, v = _arrays([(b, 1, h, hd), (b, S, kvh, hd), (b, S, kvh, hd)], 5)
    ref = jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     scalar_len)
    out, _ = split_model(*(torch.from_numpy(a) for a in (q, k, v)),
                         scalar_len)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-6)


def test_split_past_the_stream_contributes_nothing():
    """A split wholly past a slot's stream has m = -inf, l = 0, acc = 0."""
    b, h, kvh, hd, S = 2, 4, 2, 32, 256
    nsplit, kps = fd.split_geometry(b, kvh, S)
    q, k, v = _arrays([(b, 1, h, hd), (b, S, kvh, hd), (b, S, kvh, hd)], 6)
    lens = torch.tensor([kps - 3, S])
    _, parts = split_model(*(torch.from_numpy(a) for a in (q, k, v)), lens)
    for r, (m, l, acc) in enumerate(parts):
        if r >= 1:
            assert torch.all(torch.isneginf(m[0])), r
            assert torch.all(l[0] == 0) and torch.all(acc[0] == 0), r
        assert torch.all(torch.isfinite(m[1])) and torch.all(l[1] > 0), r


def _table(b, ncols, rows, rng):
    n = b * ncols
    perm = np.concatenate([rng.permutation(rows)
                           for _ in range(-(-n // rows))])[:n]
    return perm.reshape(b, ncols).astype(np.int32)


@pytest.mark.parametrize("pg,ncols", [(1, 150), (5, 41), (16, 13)])
def test_split_model_paged_view(pg, ncols):
    """Through a scrambled block table: the model on the gathered view of
    the pools (S = ncols * pg, the logical length the paged entry splits)
    matches the reference's own oracle of its paged kernel (``pool[bt]``,
    then ``decode_attention``), and equals, bit for bit, the model on a
    contiguous cache holding the same keys."""
    b, h, kvh, hd = 4, 14, 2, 64
    S = ncols * pg
    rows = b * ncols + 3
    rng = np.random.default_rng(pg)
    q, kp, vp = _arrays([(b, 1, h, hd), (rows, pg, kvh, hd),
                         (rows, pg, kvh, hd)], pg + 100)
    bt = _table(b, ncols, rows, rng)
    lens = _edge_lens(b, kvh, S, "low" if pg % 2 else "high")
    ref = jax_decode(jnp.asarray(q),
                     jnp.asarray(kp)[bt].reshape(b, S, kvh, hd),
                     jnp.asarray(vp)[bt].reshape(b, S, kvh, hd),
                     jnp.asarray(lens, jnp.int32))
    kt, vt = (torch.from_numpy(a)[torch.from_numpy(bt).long()]
              .reshape(b, S, kvh, hd) for a in (kp, vp))
    out, _ = split_model(torch.from_numpy(q), kt, vt, torch.tensor(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-6)
    contiguous, _ = split_model(torch.from_numpy(q), kt.clone(), vt.clone(),
                                torch.tensor(lens))
    assert torch.equal(out, contiguous)
    plain = fd.flash_decode_paged(
        *(torch.from_numpy(a) for a in (q, kp, vp, bt)),
        torch.tensor(lens, dtype=torch.int32))
    torch.testing.assert_close(out, plain, rtol=0, atol=2e-6)


SHAPES = [(b, kvh, S) for b in (1, 3, 8, 64) for kvh in (1, 2, 8)
          for S in (1, 31, 32, 33, 160, 192, 1000, 16384, 16385)]


@pytest.mark.parametrize("b,kvh,S", SHAPES,
                         ids=[f"b{b}-kv{k}-S{S}" for b, k, S in SHAPES])
def test_split_geometry_rules(b, kvh, S):
    nsplit, kps = fd.split_geometry(b, kvh, S)
    assert 1 <= nsplit <= fd.MAX_SPLIT
    assert kps % fd.SPLIT_UNIT == 0 and kps > 0
    # the splits cover [0, S) and none starts at or past S
    assert (nsplit - 1) * kps < S <= nsplit * kps
    # as many splits as the target asks, up to the cap and the key count
    want = -(-fd.TARGET_BLOCKS // (b * kvh))
    assert nsplit <= max(1, min(want, fd.MAX_SPLIT))
    # a function of (b, kv, S) only: the paged entry's logical length
    # S = ncols * pg splits as the contiguous entry's S does
    for pg in (1, 5, 16, 128):
        if S % pg == 0:
            assert fd.split_geometry(b, kvh, (S // pg) * pg) == (nsplit, kps)


def test_split_geometry_serving_and_long_context():
    """qwen2-0.5b's serving decode (b 8, kv 2): S 160 -> 3 splits of 64,
    the 16 384-token context -> 6 splits of 2752, 96 blocks."""
    assert fd.split_geometry(8, 2, 160) == (3, 64)
    assert fd.split_geometry(8, 2, 192) == (3, 64)
    assert fd.split_geometry(8, 2, 16384) == (6, 2752)
    with pytest.raises(ValueError):
        fd.split_geometry(8, 2, 0)
