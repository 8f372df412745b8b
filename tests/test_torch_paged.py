"""The port's paged KV cache against the JAX package, on the CPU.

* ``flash_decode_paged_ref`` (the plain version of the paged kernel) against
  the reference's own oracle of its paged kernel — the ``pool[bt]`` gather,
  then ``decode_attention`` on its jax path — at atol 2e-6
  (tests/test_kernels_decode.py), over scrambled and shared tables, scratch
  rows, kv_len 0/1/full and pages of 1 and 5 tokens.
* Port paged against port fixed, ``torch.equal``, through insert -> decode
  -> evict -> recycle -> re-admit (the mirror of tests/test_serve_scale.py).
* The port's paged ``decode_step`` against the reference's, from the same
  params (``params_from_jax``) and the same cache (``cache_from_jax``), at
  atol 1e-4 (the tolerance of tests/test_torch_serve.py).
* ``ChunkedPrefill`` against the reference's and against the port's
  ``prefill_cache``, uneven chunks and a ``gather_prefix_kv`` seeding
  included, at the reference's 4e-6.
* ``PagePool``/``PrefixIndex``/``page_keys`` driven through one scripted
  sequence in both packages, with identical results.
* The in-place rules: eviction never touches a pool page, insert writes
  only the request's own pages, gathered prefixes are copies, and a decode
  write never lands on a shared page.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import RunCtx as JaxCtx  # noqa: E402
from repro.models import decode as jdec  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import paging as jpaging  # noqa: E402
from repro.models.attention import decode_attention as jax_decode_attention  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import cache_from_jax, params_from_jax  # noqa: E402
from repro_torch.kernels.flash_decode import flash_decode_paged_ref  # noqa: E402
from repro_torch.models import decode as tdec  # noqa: E402
from repro_torch.models import paging as tpaging  # noqa: E402
from repro_torch.models.transformer import RunCtx  # noqa: E402

JCTX = JaxCtx(remat=False, chunk_q=8, chunk_k=8, kernel_interpret=False)
TCTX = RunCtx(device="cpu")


def _cfgs(arch="qwen2-0.5b", window=None):
    jcfg, tcfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    if window is not None:
        jcfg = dataclasses.replace(jcfg, long_context_variant_window=window)
        tcfg = dataclasses.replace(tcfg, long_context_variant_window=window)
    return jcfg, tcfg


def _params(jcfg, tcfg, seed=0):
    """The reference's params with numpy noise on the biases and norm
    scales (zero at init), in both packages."""
    tree = jax.tree.map(np.asarray,
                        jax_init_params(jax.random.PRNGKey(1), jcfg))
    rng = np.random.default_rng(seed)

    def noise(path, a):
        name = jax.tree_util.keystr(path)
        if any(n in name for n in ("'bq'", "'bk'", "'bv'", "'scale'")):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(noise, tree)
    return (jax.tree.map(jnp.asarray, tree),
            params_from_jax(tree, tcfg, device="cpu"))


def _prompt(cfg, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (1, n),
                                                dtype=np.int32)


def _np_cache(cache):
    return jax.tree.map(np.asarray, cache)


# ---------------------------------------------------------------------------
# the paged kernel's plain version vs the reference's oracle


def _table(kind, b, ncols, rows, rng):
    n = b * ncols
    perm = np.concatenate([rng.permutation(rows)
                           for _ in range(-(-n // rows))])[:n]
    bt = perm.reshape(b, ncols).astype(np.int32)
    if kind == "shared":
        bt[1, :ncols // 2] = bt[0, :ncols // 2]
    elif kind == "scratch":
        bt[-1] = rows - 1
    return bt


PAGED_CASES = [
    # (b, h, kvh, hd, pg, ncols, rows, kv_len, table)
    (3, 4, 2, 8, 8, 3, 12, [5, 24, 17], "scrambled"),
    (4, 4, 2, 8, 1, 16, 70, [0, 1, 16, 9], "scrambled"),
    (4, 6, 2, 16, 5, 7, 40, [35, 0, 1, 12], "shared"),
    (3, 4, 1, 8, 5, 4, 14, [20, 11, 1], "scratch"),
    (2, 4, 4, 8, 8, 4, 9, [32, 3], "shared"),
]


@pytest.mark.parametrize("case", PAGED_CASES,
                         ids=[f"pg{c[4]}-{c[8]}-kvlen{c[7]}"
                              for c in PAGED_CASES])
def test_paged_plain_matches_reference_oracle(case):
    b, h, kvh, hd, pg, ncols, rows, lens, table = case
    rng = np.random.default_rng(sum(lens) + pg)
    q = rng.standard_normal((b, 1, h, hd)).astype(np.float32)
    kp = rng.standard_normal((rows, pg, kvh, hd)).astype(np.float32)
    vp = rng.standard_normal((rows, pg, kvh, hd)).astype(np.float32)
    bt = _table(table, b, ncols, rows, rng)
    kvl = np.asarray(lens, np.int32)
    S = ncols * pg
    ref = jax_decode_attention(
        jnp.asarray(q), jnp.asarray(kp)[bt].reshape(b, S, kvh, hd),
        jnp.asarray(vp)[bt].reshape(b, S, kvh, hd), jnp.asarray(kvl))
    out = flash_decode_paged_ref(*(torch.from_numpy(a)
                                   for a in (q, kp, vp, bt, kvl)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-6)


@pytest.mark.parametrize("hd", [64, 256])
def test_paged_plain_group_16_matches_reference_oracle(hd):
    """g = 16 query heads per kv head (the kernel's MAX_GROUP) through a
    scrambled table of 5-token pages, kv_len 0, 1, mid and full."""
    b, kvh, pg, ncols = 4, 2 if hd == 64 else 1, 5, 9
    h, S, rows = 16 * kvh, ncols * pg, b * ncols + 2
    rng = np.random.default_rng(hd)
    q = rng.standard_normal((b, 1, h, hd)).astype(np.float32)
    kp = rng.standard_normal((rows, pg, kvh, hd)).astype(np.float32)
    vp = rng.standard_normal((rows, pg, kvh, hd)).astype(np.float32)
    bt = _table("scrambled", b, ncols, rows, rng)
    kvl = np.asarray([0, 1, 23, S], np.int32)
    ref = jax_decode_attention(
        jnp.asarray(q), jnp.asarray(kp)[bt].reshape(b, S, kvh, hd),
        jnp.asarray(vp)[bt].reshape(b, S, kvh, hd), jnp.asarray(kvl))
    out = flash_decode_paged_ref(*(torch.from_numpy(a)
                                   for a in (q, kp, vp, bt, kvl)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-6)


# ---------------------------------------------------------------------------
# paged vs fixed in the port, and vs the reference's paged decode


def _admit_both(tp, tcfg, fixed, paged, pool, slot, plen, seed, need,
                cache_len, pat):
    toks = torch.from_numpy(_prompt(tcfg, plen, seed)).long()
    _, src = tdec.prefill_cache(tp, toks,
                                tdec.init_cache(tcfg, 1, cache_len, TCTX,
                                                pat),
                                tcfg, TCTX, pat)
    tdec.slot_insert(fixed, slot, src)
    pages = pool.alloc(tdec.pages_needed(tcfg, cache_len, 8, need, pat))
    tdec.slot_insert(paged, slot, src, pages=pages)
    return pages


@pytest.mark.parametrize("long_context", [False, True])
def test_paged_bit_exact_with_fixed_through_recycling(long_context):
    """At identical occupancy the two layouts decode identical logits:
    three requests, slot 1 evicted mid-flight, its pages recycled into a
    new request re-admitted in the same slot.  The long-context pattern
    runs SWA rings shorter than the prompt (pages of gcd(W, 8))."""
    jcfg, tcfg = _cfgs(window=12 if long_context else None)
    _, tp = _params(jcfg, tcfg)
    pat = tcfg.pattern_for_long_context() if long_context else None
    max_batch, cache_len, gen = 4, 32, 8
    fixed = tdec.init_slot_cache(tcfg, max_batch, cache_len, TCTX, pat)
    paged = tdec.init_paged_cache(tcfg, max_batch, cache_len, TCTX,
                                  page_size=8, num_pages=12, pattern=pat)
    pool = tpaging.PagePool(12)
    kw = dict(cache_len=cache_len, pat=pat)
    if long_context:
        assert paged["unit"]["p0"]["k"].shape[2] == 4   # gcd(12, 8)
    lists = [_admit_both(tp, tcfg, fixed, paged, pool, slot, plen,
                         20 + slot, plen + gen, **kw)
             for slot, plen in enumerate([5, 14, 3])]
    tok = torch.tensor([[3], [7], [1], [0]])
    for i in range(gen):
        lf, fixed = tdec.decode_step(tp, fixed, tok, tcfg, TCTX, pat)
        lp, paged = tdec.decode_step(tp, paged, tok, tcfg, TCTX, pat)
        live = [0, 2] if i == 3 else [0, 1, 2]
        assert torch.equal(lf[live], lp[live]), f"step {i}"
        if i == 2:
            tdec.slot_evict(fixed, 1)
            tdec.slot_evict(paged, 1)
            pool.free(lists[1])
        if i == 3:      # recycle: the freed pages go to a new request
            lists[1] = _admit_both(tp, tcfg, fixed, paged, pool, 1, 9, 31,
                                   9 + gen, **kw)
            assert set(lists[1]) & set(range(12))
        tok = torch.argmax(lf, -1)[:, None]
    assert torch.equal(fixed["pos"], paged["pos"])


def test_paged_decode_step_matches_reference():
    """The reference builds and fills a paged cache; the port decodes from
    the converted copy.  Logits within 1e-4, pools within 1e-5, tables and
    lengths equal, over steps that include an eviction."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    max_batch, cache_len, page, npages = 3, 32, 8, 12
    jc = jdec.init_paged_cache(jcfg, max_batch, cache_len, JCTX,
                               page_size=page, num_pages=npages)
    pool = jpaging.PagePool(npages)
    for slot, plen in enumerate([6, 13, 2]):
        toks = jnp.asarray(_prompt(jcfg, plen, 40 + slot))
        _, src = jdec.prefill_cache(
            jp, toks, jdec.init_cache(jcfg, 1, cache_len, JCTX), jcfg, JCTX)
        pages = pool.alloc(jdec.pages_needed(jcfg, cache_len, page,
                                             plen + 6))
        jc = jdec.slot_insert(jc, slot, src, pages=pages)
    tc = cache_from_jax(_np_cache(jc), device="cpu")
    assert tc["unit"]["p0"]["bt"].dtype == torch.int32

    jstep = jax.jit(lambda c, t: jdec.decode_step(jp, c, t, jcfg, JCTX))
    tok = np.array([[3], [7], [1]], np.int32)
    for i in range(5):
        jl, jc = jstep(jc, jnp.asarray(tok))
        tl, tc = tdec.decode_step(tp, tc, torch.from_numpy(tok).long(),
                                  tcfg, TCTX)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
        if i == 1:
            jc = jdec.slot_evict(jc, 2)
            tdec.slot_evict(tc, 2)
        tok = np.asarray(jnp.argmax(jl, axis=-1))[:, None].astype(np.int32)
    for part in ("unit", "rest"):
        for layer, cl in jc[part].items():
            np.testing.assert_array_equal(tc[part][layer]["bt"].numpy(),
                                          np.asarray(cl["bt"]))
            for leaf in ("k", "v"):
                np.testing.assert_allclose(tc[part][layer][leaf].numpy(),
                                           np.asarray(cl[leaf]), atol=1e-5)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_cache_from_jax_fixed_and_paged_layouts():
    jcfg, tcfg = _cfgs()
    for jc in (jdec.init_slot_cache(jcfg, 2, 16, JCTX),
               jdec.init_paged_cache(jcfg, 2, 16, JCTX, page_size=4,
                                     num_pages=6)):
        tc = cache_from_jax(_np_cache(jc), device="cpu")
        flat_j = jax.tree_util.tree_leaves_with_path(jc)
        for path, a in flat_j:
            node = tc
            for key in path:
                node = node[key.key]
            assert tuple(node.shape) == a.shape
            assert str(node.dtype).endswith(str(a.dtype))
    with pytest.raises(ValueError, match="unit, rest and pos"):
        cache_from_jax({"unit": {}}, device="cpu")


# ---------------------------------------------------------------------------
# chunked prefill


@pytest.mark.parametrize("chunk", [4, 5, 13])
def test_chunked_prefill_matches_reference_and_fused(chunk):
    """13 tokens in chunks of 4 (4+4+4+1), 5 (uneven) and 13 (one chunk):
    logits and caches within 4e-6 of the reference's ChunkedPrefill, and of
    the port's fused prefill_cache."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    cache_len = 24
    toks = _prompt(jcfg, 13, 5)
    jcp = jdec.ChunkedPrefill(jp, jnp.asarray(toks),
                              jdec.init_cache(jcfg, 1, cache_len, JCTX),
                              jcfg, JCTX)
    tcp = tdec.ChunkedPrefill(tp, torch.from_numpy(toks).long(),
                              tdec.init_cache(tcfg, 1, cache_len, TCTX),
                              tcfg, TCTX)
    while not tcp.done:
        assert jcp.step(chunk) == tcp.step(chunk)
    assert jcp.done and tcp.remaining == 0
    jl, jc = jcp.finish()
    tl, tc = tcp.finish()
    fl, fc = tdec.prefill_cache(tp, torch.from_numpy(toks).long(),
                                tdec.init_cache(tcfg, 1, cache_len, TCTX),
                                tcfg, TCTX)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=4e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(tl.numpy(), fl.numpy(), atol=4e-6, rtol=1e-5)
    for leaf in ("k", "v"):
        np.testing.assert_allclose(tc["unit"]["p0"][leaf].numpy(),
                                   np.asarray(jc["unit"]["p0"][leaf]),
                                   atol=4e-6, rtol=1e-5)
        np.testing.assert_allclose(tc["unit"]["p0"][leaf].numpy(),
                                   fc["unit"]["p0"][leaf].numpy(), atol=4e-6,
                                   rtol=1e-5)
    assert int(tc["pos"]) == int(jc["pos"]) == 13


def test_chunked_prefill_ring_fold_matches_reference():
    """Long-context pattern, prompt longer than the window: finish folds
    the contiguous carry into the ring as the reference does."""
    jcfg, tcfg = _cfgs(window=8)
    jp, tp = _params(jcfg, tcfg)
    jpat, tpat = jcfg.pattern_for_long_context(), \
        tcfg.pattern_for_long_context()
    toks = _prompt(jcfg, 19, 6)
    jcp = jdec.ChunkedPrefill(jp, jnp.asarray(toks),
                              jdec.init_cache(jcfg, 1, 32, JCTX, jpat),
                              jcfg, JCTX, pattern=jpat)
    tcp = tdec.ChunkedPrefill(tp, torch.from_numpy(toks).long(),
                              tdec.init_cache(tcfg, 1, 32, TCTX, tpat),
                              tcfg, TCTX, pattern=tpat)
    while not tcp.done:
        jcp.step(6)
        tcp.step(6)
    jl, jc = jcp.finish()
    tl, tc = tcp.finish()
    assert tc["unit"]["p0"]["k"].shape[2] == 8
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=4e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(tc["unit"]["p0"]["k"].numpy(),
                               np.asarray(jc["unit"]["p0"]["k"]), atol=4e-6,
                               rtol=1e-5)


def test_chunked_prefill_seeded_from_shared_pages():
    """A prompt whose first 16 tokens sit in a paged cache: the job seeded
    by gather_prefix_kv starts at token 16 and finishes where an unseeded
    prefill of the whole prompt does, in both packages."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    cache_len, page = 32, 8
    donor = _prompt(jcfg, 20, 7)
    toks = np.concatenate([donor[:, :16], _prompt(jcfg, 6, 8)], axis=1)
    jc = jdec.init_paged_cache(jcfg, 2, cache_len, JCTX, page_size=page,
                               num_pages=8)
    _, src = jdec.prefill_cache(jp, jnp.asarray(donor),
                                jdec.init_cache(jcfg, 1, cache_len, JCTX),
                                jcfg, JCTX)
    jc = jdec.slot_insert(jc, 0, src, pages=[5, 2, 7])
    tc = cache_from_jax(_np_cache(jc), device="cpu")

    jkv = jdec.gather_prefix_kv(jc, [5, 2], 16)
    tkv = tdec.gather_prefix_kv(tc, [5, 2], 16)
    assert len(tkv) == len(jkv) == tcfg.num_layers
    for a, b in zip(jkv, tkv):
        np.testing.assert_array_equal(b["k"].numpy(), np.asarray(a["k"]))
    outs = {}
    for name, (dec, params, cfg, ctx, kv, tensor) in {
            "jax": (jdec, jp, jcfg, JCTX, jkv, jnp.asarray),
            "torch": (tdec, tp, tcfg, TCTX, tkv,
                      lambda a: torch.from_numpy(a).long())}.items():
        job = dec.ChunkedPrefill(params, tensor(toks),
                                 dec.init_cache(cfg, 1, cache_len, ctx), cfg,
                                 ctx, start_token=16, prefix_kv=kv)
        assert job.done_tokens == 16
        while not job.done:
            job.step(4)
        outs[name] = job.finish()
    whole, _ = tdec.prefill_cache(tp, torch.from_numpy(toks).long(),
                                  tdec.init_cache(tcfg, 1, cache_len, TCTX),
                                  tcfg, TCTX)
    np.testing.assert_allclose(outs["torch"][0].numpy(),
                               np.asarray(outs["jax"][0]), atol=4e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(outs["torch"][0].numpy(), whole.numpy(),
                               atol=4e-6, rtol=1e-5)


def test_chunked_prefill_guards():
    _, tcfg = _cfgs()
    tp = params_from_jax(jax.tree.map(np.asarray, jax_init_params(
        jax.random.PRNGKey(0), jax_get_config("qwen2-0.5b").reduced())),
        tcfg, device="cpu")
    toks = torch.zeros((1, 8), dtype=torch.long)
    job = tdec.ChunkedPrefill(tp, toks, tdec.init_cache(tcfg, 1, 16, TCTX),
                              tcfg, TCTX)
    with pytest.raises(ValueError, match="incomplete"):
        job.finish()
    assert job.step(8) == 8 and job.done and job.step(4) == 0
    with pytest.raises(ValueError, match="start_token"):
        tdec.ChunkedPrefill(tp, toks, tdec.init_cache(tcfg, 1, 16, TCTX),
                            tcfg, TCTX, start_token=8)
    with pytest.raises(ValueError, match="prefix_kv"):
        tdec.ChunkedPrefill(tp, toks, tdec.init_cache(tcfg, 1, 16, TCTX),
                            tcfg, TCTX, start_token=4)


# ---------------------------------------------------------------------------
# page bookkeeping: one scripted sequence through both packages


def _script(paging):
    """Drive a pool and an index through allocation, sharing, CoW tails,
    reservation, reclamation and frees; return every observable."""
    out = []
    pool = paging.PagePool(10)
    idx = paging.PrefixIndex(4)
    a = pool.alloc(3)
    toks_a = tuple(range(10))               # 2 full pages + 2-token tail
    out += [a, idx.insert(toks_a, a, pool), [pool.refcount(p) for p in a]]
    m = idx.match(toks_a + (99, 98))
    out += [dataclasses.astuple(m)]
    m = idx.match((0, 1, 2, 3, 7, 7, 7, 7), limit=7)
    out += [dataclasses.astuple(m)]
    out += [pool.reserve(4), pool.available, pool.alloc(4), pool.reserved]
    b = pool.alloc(4, reserved=True)
    pool.incref(a[:2])
    out += [b, pool.free(a), pool.in_use(), idx.reclaimable(pool)]
    toks_b = tuple(range(100, 108))
    out += [idx.insert(toks_b, b, pool), pool.free(b)]
    idx.invalidate_tail(a[2])
    out += [dataclasses.astuple(idx.match(toks_a)), idx.reclaim(3, pool),
            idx.held_pages(), idx.stats(), pool.free(a[:2]),
            idx.drop_all(pool), pool.available, pool.conserved()]
    out += [paging.page_keys(tuple(range(13)), 4),
            paging.page_keys(tuple(range(13)), 5)]
    return out


def test_paging_scripted_sequence_identical():
    assert _script(tpaging) == _script(jpaging)


def test_page_pool_guards():
    pool = tpaging.PagePool(4)
    with pytest.raises(ValueError, match="without reservation"):
        pool.alloc(1, reserved=True)
    with pytest.raises(ValueError, match="incref of free"):
        pool.incref([0])
    got = pool.alloc(2)
    pool.free(got)
    with pytest.raises(ValueError, match="double free"):
        pool.free(got)
    with pytest.raises(ValueError, match="exceeds"):
        pool.unreserve(1)
    assert pool.conserved()


def test_prefix_sharing_supported_matches_reference():
    for arch in ("qwen2-0.5b", "mistral-large-123b", "internlm2-20b"):
        jcfg, tcfg = jax_get_config(arch).reduced(), \
            get_config(arch).reduced()
        for pat in (None, "long"):
            jp = jcfg.pattern_for_long_context() if pat else None
            tpat = tcfg.pattern_for_long_context() if pat else None
            for cache_len, page in ((32, 8), (48, 16), (30, 8)):
                assert (tdec.prefix_sharing_supported(tcfg, cache_len, page,
                                                      tpat)
                        == jdec.prefix_sharing_supported(jcfg, cache_len,
                                                         page, jp))
                for n in (1, 9, 30, 64):
                    assert (tdec.pages_needed(tcfg, cache_len, page, n, tpat)
                            == jdec.pages_needed(jcfg, cache_len, page, n,
                                                 jp))


# ---------------------------------------------------------------------------
# in-place rules of the paged layout


def _filled_paged(tcfg, tp, pages=(3, 1, 4), plen=13):
    cache = tdec.init_paged_cache(tcfg, 2, 32, TCTX, page_size=8,
                                  num_pages=6)
    toks = torch.from_numpy(_prompt(tcfg, plen, 9)).long()
    _, src = tdec.prefill_cache(tp, toks, tdec.init_cache(tcfg, 1, 32, TCTX),
                                tcfg, TCTX)
    tdec.slot_insert(cache, 0, src, pages=list(pages))
    return cache, src


def test_paged_insert_writes_only_own_pages_and_evict_touches_none():
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg, tcfg)
    cache, src = _filled_paged(tcfg, tp)
    k = cache["unit"]["p0"]["k"]
    bt = cache["unit"]["p0"]["bt"]
    assert bt[:, 0].tolist() == [[3, 1, 4, 6]] * bt.shape[0]  # col 3: scratch
    untouched = [r for r in range(k.shape[1]) if r not in (3, 1, 4)]
    assert not k[:, untouched].any()        # scratch rows included
    view = k[:, bt[0, 0].long()].reshape(k.shape[0], 32, *k.shape[-2:])
    assert torch.equal(view[:, :13], src["unit"]["p0"]["k"][:, 0, :13])
    before = k.clone()
    tdec.slot_evict(cache, 0)
    assert torch.equal(k, before)           # pages may belong to others now
    assert bt[:, 0].tolist() == [[6] * 4] * bt.shape[0]
    assert int(cache["pos"][0]) == 0
    # a shared first column is mapped but not written
    tdec.slot_insert(cache, 1, src, pages=[5, 0], skip_cols=1)
    assert not k[:, 5].any() and k[:, 0].any()
    assert bt[0, 1, :2].tolist() == [5, 0]


def test_gather_prefix_kv_returns_copies():
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg, tcfg)
    cache, src = _filled_paged(tcfg, tp)
    kv = tdec.gather_prefix_kv(cache, [3, 1], 12)
    assert kv[0]["k"].shape == (1, 12, tcfg.num_kv_heads,
                                tcfg.resolved_head_dim)
    kept = kv[0]["k"].clone()
    cache["unit"]["p0"]["k"][0, 3] = 7.0    # the donor's page is recycled
    assert torch.equal(kv[0]["k"], kept)
    assert torch.equal(kept[0], src["unit"]["p0"]["k"][0, 0, :12])


def test_decode_never_writes_a_shared_page():
    """Two requests map the same two full prefix pages; decoding both for
    several steps leaves those pages' bytes unchanged (decode writes land
    at pos >= prompt_len, past every shared page)."""
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg, tcfg)
    cache = tdec.init_paged_cache(tcfg, 2, 32, TCTX, page_size=8,
                                  num_pages=8)
    pool = tpaging.PagePool(8)
    toks = torch.from_numpy(_prompt(tcfg, 17, 11)).long()
    _, src = tdec.prefill_cache(tp, toks, tdec.init_cache(tcfg, 1, 32, TCTX),
                                tcfg, TCTX)
    first = pool.alloc(4)
    tdec.slot_insert(cache, 0, src, pages=first)
    shared = first[:2]                      # full pages inside prompt_len - 1
    pool.incref(shared)
    second = shared + pool.alloc(2)
    tdec.slot_insert(cache, 1, src, pages=second, skip_cols=2)
    snap = {leaf: cache["unit"]["p0"][leaf][:, shared].clone()
            for leaf in ("k", "v")}
    tok = torch.tensor([[1], [2]])
    for _ in range(8):
        logits, cache = tdec.decode_step(tp, cache, tok, tcfg, TCTX)
        tok = torch.argmax(logits, -1)[:, None]
    for leaf in ("k", "v"):
        assert torch.equal(cache["unit"]["p0"][leaf][:, shared], snap[leaf])
    assert cache["pos"].tolist() == [25, 25]
