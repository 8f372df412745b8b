"""The port's MoE and hybrid families against the JAX package, on the CPU.

Reduced mixtral-8x22b (SWA, 4 experts top-2; at window 8 where the ring
must wrap), reduced recurrentgemma-2b (an RG-LRU layer and a local
attention layer, the gemma embedding scale, tied embeddings) and reduced
llama4-maverick (top-1 with a shared expert, a ``dense_alt`` FFN, SWA and
full attention).  The reference's params, with numpy noise on the leaves it
makes zero (norm scales; ``rglru.conv_b``, ``b_a``, ``b_i``), are carried
across by ``params_from_jax``.  The reference runs its jax attention paths
(``decode_backend``/``prefill_backend`` "jax"); the port's default
``"kernel"`` runs the kernels' plain versions on CPU tensors.

Covered: the training forward, loss and ``make_loss_fn`` total (with the
MoE aux loss) and its gradient; ``decode_step`` step by step, ``prefill_
cache`` and ``ChunkedPrefill`` against the reference; the port's decode
against its own forward; the recurrent cache's size; slot insert/evict of
recurrent state; paged against fixed-slot decode; ``prefix_sharing_
supported``; the real runner behind the scheduler; the launcher; and
``check_supported`` over the whole registry.  Each tolerance is stated where it is used.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.serve as jserve  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import decode as jdec  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.train.step import make_loss_fn as jax_make_loss_fn  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.registry import ASSIGNED_ARCHS  # noqa: E402
from repro_torch.convert import cache_from_jax, params_from_jax  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models import decode as tdec  # noqa: E402
from repro_torch.models import paging  # noqa: E402
from repro_torch.models.transformer import (RunCtx, check_supported,  # noqa: E402
                                            forward_hidden, init_params,
                                            lm_loss, logits_fn)
from repro_torch.train.step import make_loss_fn  # noqa: E402
from repro_torch.tree import leaves, unflatten  # noqa: E402

ARCHS = ["mixtral-8x22b", "recurrentgemma-2b", "llama4-maverick-400b-a17b"]
# kernel_interpret=False keeps the reference's serving runner on its jax
# decode path (its Pallas kernels raise under this jax)
JCTX = jtf.RunCtx(remat=False, chunk_q=8, chunk_k=8, loss_chunk=8,
                  kernel_interpret=False)
TCTX = RunCtx(remat=False, loss_chunk=8, device="cpu")
NOISY = ("'scale'", "'conv_b'", "'b_a'", "'b_i'", "'bq'", "'bk'", "'bv'")
# the reference's own decode-vs-prefill bound (tests/test_decode.py)
DECODE_TOL = 2e-4


def _cfgs(arch, window=None):
    jcfg = jax_get_config(arch).reduced()
    tcfg = get_config(arch).reduced()
    if window is not None:
        jcfg = dataclasses.replace(jcfg, window_size=window)
        tcfg = dataclasses.replace(tcfg, window_size=window)
    return jcfg, tcfg


_MODELS = {}


def _model(arch, window=None):
    """(jcfg, jax params, tcfg, port params), noisy, cached per arch."""
    key = (arch, window)
    if key not in _MODELS:
        jcfg, tcfg = _cfgs(arch, window)
        tree = jax.tree.map(np.asarray,
                            jtf.init_params(jax.random.PRNGKey(1), jcfg))
        rng = np.random.default_rng(0)

        def noise(path, a):
            name = jax.tree_util.keystr(path)
            if any(n in name for n in NOISY):
                return (a + 0.1 * rng.standard_normal(a.shape)).astype(
                    a.dtype)
            return a

        tree = jax.tree_util.tree_map_with_path(noise, tree)
        _MODELS[key] = (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
                        params_from_jax(tree, tcfg, device="cpu"))
    return _MODELS[key]


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s),
                                                dtype=np.int32)


def _close_cache(tc, jc, atol):
    for part in ("unit", "rest"):
        assert set(tc[part]) == set(jc[part])
        for layer, cl in jc[part].items():
            assert set(tc[part][layer]) == set(cl)
            for name, a in cl.items():
                np.testing.assert_allclose(
                    tc[part][layer][name].float().numpy(),
                    np.asarray(a, np.float32), atol=atol,
                    err_msg=f"{part}.{layer}.{name}")
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


# ---------------------------------------------------------------------------
# families and kinds


@pytest.mark.parametrize("arch", ARCHS)
def test_check_supported_accepts_moe_and_hybrid(arch):
    cfg = get_config(arch)
    check_supported(cfg)
    check_supported(cfg.reduced())
    check_supported(cfg, cfg.pattern_for_long_context())


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_check_supported_accepts_every_registry_config(arch):
    """Every model of the registry, full, reduced and under its
    long-context pattern: the port serves the whole zoo."""
    cfg = get_config(arch)
    check_supported(cfg)
    check_supported(cfg.reduced())
    check_supported(cfg, cfg.pattern_for_long_context())


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_jax(arch):
    """``params_from_jax`` is a checked tree map against ``init_params``:
    every new leaf has the reference's name, shape and dtype."""
    jcfg, tcfg = _cfgs(arch)
    jshapes = jax.eval_shape(lambda k: jtf.init_params(k, jcfg),
                             jax.random.PRNGKey(0))
    tmeta = init_params(None, tcfg, device="meta")
    assert (jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jshapes)
            == jax.tree.map(lambda a: (tuple(a.shape),
                                       str(a.dtype).replace("torch.", "")),
                            tmeta))


# ---------------------------------------------------------------------------
# training forward, loss, gradient


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grad_match_jax(arch):
    """Hidden states within 1e-5, the aux loss within 1e-6 relative, the
    loss and the total within 1e-6 relative, gradients within 2e-5 + 1e-3
    relative (``tests/test_torch_train.py``'s bounds for the dense
    family)."""
    jcfg, jp, tcfg, tp = _model(arch)
    toks = _tokens(tcfg, 2, 16)
    labels = np.roll(toks, -1, axis=1)
    jh, jaux = jtf.forward_hidden(jp, jnp.asarray(toks), jcfg, JCTX)
    th, taux = forward_hidden(tp, torch.from_numpy(toks).long(), tcfg, TCTX)
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh),
                               atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    if tcfg.moe is not None:
        assert float(taux) > 0
    else:
        assert float(taux) == 0
    jl = jtf.lm_loss(jp, jh, jnp.asarray(labels), jcfg, JCTX)
    tl = lm_loss(tp, th, torch.from_numpy(labels).long(), tcfg, TCTX)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)

    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks).long(),
          "labels": torch.from_numpy(labels).long()}
    (jt, jm), jg = jax.value_and_grad(jax_make_loss_fn(jcfg, JCTX),
                                      has_aux=True)(jp, jb)
    live = [p.clone().requires_grad_() for p in leaves(tp)]
    tt, tm = make_loss_fn(tcfg, dataclasses.replace(TCTX, remat=True))(
        unflatten(tp, live), tb)
    tt.backward()
    np.testing.assert_allclose(tt.item(), float(jt), rtol=1e-6)
    np.testing.assert_allclose(tm["aux"].item(), float(jm["aux"]), rtol=1e-6)
    for p, g in zip(live, jax.tree.leaves(jg)):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), atol=2e-5,
                                   rtol=1e-3)


# ---------------------------------------------------------------------------
# decode, prefill, chunked prefill


@pytest.mark.parametrize("arch,window", [("mixtral-8x22b", 8),
                                         ("recurrentgemma-2b", None),
                                         ("llama4-maverick-400b-a17b", 8)])
def test_decode_steps_match_jax(arch, window):
    """24 tokens one step at a time from empty caches in both packages:
    every step's logits within the reference's 2e-4; the caches after the
    last step (mixtral and llama4's rings wrapped three times) within
    1e-5."""
    jcfg, jp, tcfg, tp = _model(arch, window)
    b, s = 2, 24
    toks = _tokens(tcfg, b, s, seed=1)
    jc = jdec.init_cache(jcfg, b, s, JCTX)
    tc = tdec.init_cache(tcfg, b, s, TCTX)
    step = jax.jit(lambda c, t: jdec.decode_step(jp, c, t, jcfg, JCTX))
    for t in range(s):
        jl, jc = step(jc, jnp.asarray(toks[:, t:t + 1]))
        tl, tc = tdec.decode_step(tp, tc, torch.from_numpy(
            toks[:, t:t + 1]).long(), tcfg, TCTX)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=DECODE_TOL, err_msg=f"step {t}")
    _close_cache(tc, jc, atol=1e-5)


@pytest.mark.parametrize("arch,window", [("mixtral-8x22b", 8),
                                         ("recurrentgemma-2b", None),
                                         ("llama4-maverick-400b-a17b", 8)])
def test_decode_matches_own_forward(arch, window):
    """The port's decode against its own training forward (the reference's
    ``tests/test_decode.py`` check, at its bound)."""
    _, _, tcfg, tp = _model(arch, window)
    b, s = 2, 24
    toks = torch.from_numpy(_tokens(tcfg, b, s, seed=2)).long()
    with torch.no_grad():
        h, _ = forward_hidden(tp, toks, tcfg, TCTX)
        full = logits_fn(tp, h, tcfg)
        cache = tdec.init_cache(tcfg, b, s, TCTX)
        err = 0.0
        for t in range(s):
            lg, cache = tdec.decode_step(tp, cache, toks[:, t:t + 1], tcfg,
                                         TCTX)
            err = max(err, float((lg - full[:, t]).abs().max()))
    assert err < DECODE_TOL


@pytest.mark.parametrize("arch,window", [("mixtral-8x22b", 8),
                                         ("recurrentgemma-2b", None),
                                         ("llama4-maverick-400b-a17b", None)])
def test_prefill_cache_matches_jax(arch, window):
    """Fused prefill of 20 tokens into a 28-token cache, then 4 decode
    steps: logits within 1e-4, caches within 1e-5."""
    jcfg, jp, tcfg, tp = _model(arch, window)
    toks = _tokens(tcfg, 2, 20, seed=3)
    jl, jc = jdec.prefill_cache(jp, jnp.asarray(toks),
                                jdec.init_cache(jcfg, 2, 28, JCTX), jcfg,
                                JCTX)
    tl, tc = tdec.prefill_cache(tp, torch.from_numpy(toks).long(),
                                tdec.init_cache(tcfg, 2, 28, TCTX), tcfg,
                                TCTX)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    _close_cache(tc, jc, atol=1e-5)
    for i in range(4):
        nxt = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        jl, jc = jdec.decode_step(jp, jc, jnp.asarray(nxt), jcfg, JCTX)
        tl, tc = tdec.decode_step(tp, tc, torch.from_numpy(nxt).long(),
                                  tcfg, TCTX)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   err_msg=f"step {i}")
    _close_cache(tc, jc, atol=1e-5)


@pytest.mark.parametrize("arch,window", [("mixtral-8x22b", 8),
                                         ("recurrentgemma-2b", None),
                                         ("llama4-maverick-400b-a17b", 8)])
def test_chunked_prefill_matches_jax_and_one_shot(arch, window):
    """13 tokens in chunks of 4 (4+4+4+1): against the reference's chunked
    prefill (logits 1e-4, caches 1e-5) and the port's own one-shot prefill
    at the reference's chunked-vs-whole bound (atol 4e-6, rtol 1e-5,
    ``tests/test_serve_scale.py``).  The MoE groups (4 tokens) stay within
    capacity, so chunking routes no token differently."""
    jcfg, jp, tcfg, tp = _model(arch, window)
    toks = _tokens(tcfg, 1, 13, seed=4)
    jcp = jdec.ChunkedPrefill(jp, jnp.asarray(toks),
                              jdec.init_cache(jcfg, 1, 32, JCTX), jcfg, JCTX)
    tcp = tdec.ChunkedPrefill(tp, torch.from_numpy(toks).long(),
                              tdec.init_cache(tcfg, 1, 32, TCTX), tcfg, TCTX)
    while not tcp.done:
        assert tcp.step(4) == jcp.step(4)
    assert jcp.done
    jl, jc = jcp.finish()
    tl, tc = tcp.finish()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    _close_cache(tc, jc, atol=1e-5)
    wl, wc = tdec.prefill_cache(tp, torch.from_numpy(toks).long(),
                                tdec.init_cache(tcfg, 1, 32, TCTX), tcfg,
                                TCTX)
    np.testing.assert_allclose(tl.numpy(), wl.numpy(), atol=4e-6, rtol=1e-5)
    for a, b in zip(leaves(tc), leaves(wc)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   atol=4e-6, rtol=1e-5)


def test_recurrent_cache_constant_memory():
    _, tcfg = _cfgs("recurrentgemma-2b")
    small = tdec.init_cache(tcfg, 1, 64, TCTX)
    large = tdec.init_cache(tcfg, 1, 4096, TCTX)
    for name in ("h", "conv"):
        assert (small["unit"]["p0"][name].shape
                == large["unit"]["p0"][name].shape)
    assert small["unit"]["p0"]["h"].dtype == torch.float32
    r = tcfg.lru_dim
    assert small["unit"]["p0"]["h"].shape == (1, 1, r)
    assert small["unit"]["p0"]["conv"].shape == (1, 1, 3, r)
    # the local-attention layer's ring stops at the window
    assert large["unit"]["p1"]["k"].shape[2] == tcfg.window_size


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "recurrentgemma-2b",
                                  "llama4-maverick-400b-a17b", "qwen2-0.5b"])
@pytest.mark.parametrize("long_context", [False, True])
def test_prefix_sharing_supported_matches_jax(arch, long_context):
    jcfg, tcfg = _cfgs(arch)
    jpat = jcfg.pattern_for_long_context() if long_context else None
    tpat = tcfg.pattern_for_long_context() if long_context else None
    for cache_len, page in ((32, 8), (48, 16), (20, 8)):
        assert (tdec.prefix_sharing_supported(tcfg, cache_len, page, tpat)
                == jdec.prefix_sharing_supported(jcfg, cache_len, page,
                                                 jpat))
    if arch != "qwen2-0.5b":
        assert tdec.prefix_sharing_supported(tcfg, 32, 8, tpat) is None


# ---------------------------------------------------------------------------
# slots and pages


def _prefilled(tp, tcfg, plen, cache_len, seed):
    toks = torch.from_numpy(_tokens(tcfg, 1, plen, seed=seed)).long()
    one = tdec.init_cache(tcfg, 1, cache_len, TCTX)
    one["pos"] = torch.zeros((1,), dtype=torch.int32)
    return tdec.prefill_cache(tp, toks, one, tcfg, TCTX)[1]


@pytest.mark.parametrize("paged", [False, True])
def test_slot_insert_evict_carry_recurrent_state(paged):
    """RG-LRU state goes into a slot with ``slot_insert`` (fixed and
    paged), leaves the other slots alone, and ``slot_evict`` zeroes it."""
    _, _, tcfg, tp = _model("recurrentgemma-2b")
    cache_len = 32
    if paged:
        cache = tdec.init_paged_cache(tcfg, 3, cache_len, TCTX, page_size=8,
                                      num_pages=12)
    else:
        cache = tdec.init_slot_cache(tcfg, 3, cache_len, TCTX)
    srcs = [_prefilled(tp, tcfg, plen, cache_len, seed=10 + i)
            for i, plen in enumerate((5, 11, 7))]
    pool = paging.PagePool(12)
    for slot, src in enumerate(srcs):
        pages = (pool.alloc(tdec.pages_needed(tcfg, cache_len, 8, 16))
                 if paged else None)
        tdec.slot_insert(cache, slot, src, pages=pages)
    for slot, src in enumerate(srcs):
        for name in ("h", "conv"):
            assert torch.equal(cache["unit"]["p0"][name][:, slot],
                               src["unit"]["p0"][name][:, 0])
            assert bool(src["unit"]["p0"][name].abs().max() > 0)
    assert cache["pos"].tolist() == [5, 11, 7]
    tdec.slot_evict(cache, 1)
    for name in ("h", "conv"):
        assert not bool(cache["unit"]["p0"][name][:, 1].any())
        for slot in (0, 2):
            assert torch.equal(cache["unit"]["p0"][name][:, slot],
                               srcs[slot]["unit"]["p0"][name][:, 0])
    assert cache["pos"].tolist() == [5, 0, 7]


@pytest.mark.parametrize("arch,window", [("mixtral-8x22b", 8),
                                         ("recurrentgemma-2b", None),
                                         ("llama4-maverick-400b-a17b", 8)])
def test_paged_decode_bit_identical_to_fixed(arch, window):
    """Fixed-slot and paged caches at one occupancy decode the same logits
    bit for bit, through inserts, steps and an eviction whose pages are
    recycled into a new request (``tests/test_serve_scale.py``'s check)."""
    _, _, tcfg, tp = _model(arch, window)
    max_batch, cache_len, page, gen = 4, 32, 8, 6
    fixed = tdec.init_slot_cache(tcfg, max_batch, cache_len, TCTX)
    paged = tdec.init_paged_cache(tcfg, max_batch, cache_len, TCTX,
                                  page_size=page, num_pages=16)
    pool = paging.PagePool(16)
    held = {}

    def admit(slot, plen, seed):
        src = _prefilled(tp, tcfg, plen, cache_len, seed)
        tdec.slot_insert(fixed, slot, src)
        held[slot] = pool.alloc(tdec.pages_needed(tcfg, cache_len, page,
                                                  plen + gen))
        tdec.slot_insert(paged, slot, src, pages=held[slot])

    for slot, plen in enumerate((5, 11, 3)):
        admit(slot, plen, 20 + slot)
    tok = torch.tensor([[3], [7], [1], [0]])
    live = [0, 1, 2]
    for i in range(gen):
        lf, _ = tdec.decode_step(tp, fixed, tok, tcfg, TCTX)
        lp, _ = tdec.decode_step(tp, paged, tok, tcfg, TCTX)
        assert torch.equal(lf[live], lp[live]), f"step {i}"
        if i == 2:
            tdec.slot_evict(fixed, 1)
            tdec.slot_evict(paged, 1)
            pool.free(held.pop(1))
            admit(3, 9, 30)
            live = [0, 2, 3]


@pytest.fixture(scope="module")
def hybrid():
    return _model("recurrentgemma-2b")


def _trace(pkg):
    return pkg.RequestStream(dist="S1", n_clients=4, prompt_lens=(8, 24),
                             max_new_tokens=6, slo_ttft_s=2.0,
                             slo_tpot_s=0.5, seed=0).generate(3.0)


def _cost(pkg):
    return pkg.StepCostModel(decode_step_s=0.01, prefill_token_s=5e-4,
                             prefill_base_s=1e-3)


def test_real_runner_tokens_identical(hybrid):
    """A Table I trace through the scheduler with chunked prefill (chunks
    of 8): the port's fixed-slot and paged runners on recurrentgemma
    generate the same greedy tokens as each other and as the reference's
    runner fed the same prompts."""
    jcfg, jp, tcfg, tp = hybrid

    def run(pkg, params, cfg, ctx, prompts=None, **kw):
        runner = pkg.SlotRunner(params, cfg, ctx, 2, 48, **kw)
        if prompts is not None:
            runner.prompt_tokens = prompts
        _, s = pkg.Scheduler(2, _cost(pkg), runners=[runner],
                             chunk_tokens=8).run(_trace(pkg), horizon_s=3.0)
        assert s["conservation_ok"]
        return runner

    fixed = run(tserve, tp, tcfg, TCTX)
    paged = run(tserve, tp, tcfg, TCTX, page_size=8, num_pages=16,
                prefix_sharing=True)
    assert paged.prefix_index is None        # no sharing for this family
    ref = run(jserve, jp, jcfg, JCTX, prompts=lambda req: jnp.asarray(
        fixed.prompt_tokens(req).numpy().astype(np.int32)))
    assert len(fixed.generated) > 0
    assert paged.generated == fixed.generated
    assert ref.generated == fixed.generated
    assert paged.pool.conserved()


def test_paged_cache_from_jax_decodes_like_jax(hybrid):
    """A reference paged cache, filled there and carried across by
    ``cache_from_jax``, decodes one step to the reference's logits (1e-4)
    and state (1e-5)."""
    jcfg, jp, tcfg, tp = hybrid
    cache_len, page = 32, 8
    jc = jdec.init_paged_cache(jcfg, 2, cache_len, JCTX, page_size=page,
                               num_pages=8)
    for slot, plen in enumerate((6, 13)):
        toks = jnp.asarray(_tokens(tcfg, 1, plen, seed=40 + slot))
        _, src = jdec.prefill_cache(jp, toks,
                                    jdec.init_cache(jcfg, 1, cache_len, JCTX),
                                    jcfg, JCTX)
        jc = jdec.slot_insert(jc, slot, src,
                              pages=list(range(4 * slot, 4 * slot + 4)))
    tc = cache_from_jax(jax.tree.map(np.asarray, jc), device="cpu")
    tok = np.array([[2], [5]], np.int32)
    jl, jc = jdec.decode_step(jp, jc, jnp.asarray(tok), jcfg, JCTX)
    tl, tc = tdec.decode_step(tp, tc, torch.from_numpy(tok).long(), tcfg,
                              TCTX)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    _close_cache(tc, jc, atol=1e-5)


# ---------------------------------------------------------------------------
# launcher


@pytest.mark.parametrize("arch", ARCHS)
def test_offline_launcher_serves_on_cpu(arch):
    args = launch.parse_args(["--arch", arch, "--reduced", "--device", "cpu",
                              "--batch", "2", "--prompt-len", "16", "--gen",
                              "4", "--temperature", "0"])
    res = launch.run_offline(args)
    assert res["tokens"].shape == (2, 4)
    assert bool(torch.isfinite(res["last_logits"]).all())
    # the same greedy tokens from the plain decode path, step by step
    cfg, ctx, params, prompts, _ = launch.setup(args)
    ctx = dataclasses.replace(ctx, prefill_backend="torch",
                              decode_backend="torch")
    cache = tdec.init_cache(cfg, 2, 20, ctx)
    logits, cache = tdec.prefill_cache(params, prompts, cache, cfg, ctx)
    for i in range(4):
        nxt = torch.argmax(logits, -1)
        assert torch.equal(nxt, res["tokens"][:, i])
        logits, cache = tdec.decode_step(params, cache, nxt[:, None], cfg,
                                         ctx)


def test_streaming_launcher_serves_the_hybrid_on_cpu():
    res = launch.run_streaming(launch.parse_args([
        "--arch", "recurrentgemma-2b", "--reduced", "--device", "cpu",
        "--streaming", "--horizon", "1.5", "--clients", "4",
        "--prompt-len", "8", "--gen", "4", "--temperature", "0"]))
    s = res["summary"]
    assert s["n_requests"] > 0
    assert s["completed"] + s["dropped"] == s["n_requests"]
