"""The port's audio family (whisper) against the JAX package, on the CPU.

Reduced whisper-base: 2 encoder and 2 decoder layers (4 heads of 64, d 256,
64 encoder frames), LayerNorms with a bias, sinusoidal positions and no
RoPE, a cross-attention in every decoder block, tied embeddings.  The
reference's params, with numpy noise on the LayerNorms' scales and biases
(ones and zeros there), are carried across by ``params_from_jax``; tokens
and the encoder's frames (the stubbed front end's output) are drawn from
numpy seeds.  The reference runs its jax paths (``kernel_interpret=
False``); the port's default ``"kernel"`` backends run the kernels' plain
versions on CPU tensors.

Covered: the encoder and the training forward, loss and ``make_loss_fn``'s
gradient with ``audio_feats``; ``prefill_cross_kv``; ``decode_step`` step
by step; ``prefill_cache`` and ``ChunkedPrefill`` against the reference
and against one shot; cross K/V through paged slots; paged against
fixed-slot decode; a reference paged cache by ``cache_from_jax``; both
packages' ``SlotRunner`` behind the scheduler, which leave the cross K/V at
zero; the launcher.  Tolerances are ``tests/test_torch_zoo.py``'s: hidden
states 1e-5, logits 1e-4 (decode 2e-4), caches 1e-5, gradients 2e-5 +
1e-3 relative.
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
from repro_torch.convert import cache_from_jax, params_from_jax  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models import decode as tdec  # noqa: E402
from repro_torch.models import paging  # noqa: E402
from repro_torch.models.transformer import (RunCtx, encode,  # noqa: E402
                                            forward_hidden, lm_loss)
from repro_torch.train.step import make_loss_fn  # noqa: E402
from repro_torch.tree import leaves, unflatten  # noqa: E402

ARCH = "whisper-base"
JCTX = jtf.RunCtx(remat=False, chunk_q=8, chunk_k=8, loss_chunk=8,
                  kernel_interpret=False)
TCTX = RunCtx(remat=False, loss_chunk=8, device="cpu")
NOISY = ("'scale'", "'bias'")
DECODE_TOL = 2e-4


@pytest.fixture(scope="module")
def model():
    """(jcfg, jax params, tcfg, port params)."""
    jcfg, tcfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    tree = jax.tree.map(np.asarray,
                        jtf.init_params(jax.random.PRNGKey(1), jcfg))
    rng = np.random.default_rng(0)

    def noise(path, a):
        if any(n in jax.tree_util.keystr(path) for n in NOISY):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(noise, tree)
    return (jcfg, jax.tree.map(jnp.asarray, tree), tcfg,
            params_from_jax(tree, tcfg, device="cpu"))


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s),
                                                dtype=np.int32)


def _feats(cfg, b, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)


def _close(t, j, atol, msg=""):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol,
                               err_msg=msg)


def _close_cache(tc, jc, atol):
    for part in ("unit", "rest"):
        assert set(tc[part]) == set(jc[part])
        for layer, cl in jc[part].items():
            assert set(tc[part][layer]) == set(cl)
            for name, a in cl.items():
                _close(tc[part][layer][name], a, atol, f"{part}.{layer}.{name}")
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def _caches(model, b, cache_len, seed, slot_cache=False):
    """Fresh caches in both packages with the cross K/V of the same frames
    filled by ``prefill_cross_kv``."""
    jcfg, jp, tcfg, tp = model
    feats = _feats(tcfg, b, seed)
    init_j = jdec.init_slot_cache if slot_cache else jdec.init_cache
    init_t = tdec.init_slot_cache if slot_cache else tdec.init_cache
    jc = jdec.prefill_cross_kv(jp, jnp.asarray(feats), jcfg, JCTX,
                               init_j(jcfg, b, cache_len, JCTX))
    tc = tdec.prefill_cross_kv(tp, torch.from_numpy(feats), tcfg, TCTX,
                               init_t(tcfg, b, cache_len, TCTX))
    return jc, tc


# ---------------------------------------------------------------------------
# the encoder and the training forward


def test_forward_loss_and_grad_match_jax(model):
    """The encoder's output and the hidden states within 1e-5, the loss and
    ``make_loss_fn``'s total within 1e-6 relative, its gradient (encoder
    and cross-attention leaves included) within 2e-5 + 1e-3 relative."""
    jcfg, jp, tcfg, tp = model
    toks = _tokens(tcfg, 2, 16)
    labels = np.roll(toks, -1, axis=1)
    feats = _feats(tcfg, 2, seed=1)
    _close(encode(tp, torch.from_numpy(feats), tcfg, TCTX),
           jtf.encode(jp, jnp.asarray(feats), jcfg, JCTX), 1e-5)
    jh, _ = jtf.forward_hidden(jp, jnp.asarray(toks), jcfg, JCTX,
                               audio_feats=jnp.asarray(feats))
    th, _ = forward_hidden(tp, torch.from_numpy(toks).long(), tcfg, TCTX,
                           audio_feats=torch.from_numpy(feats))
    _close(th, jh, 1e-5)
    jl = jtf.lm_loss(jp, jh, jnp.asarray(labels), jcfg, JCTX)
    tl = lm_loss(tp, th, torch.from_numpy(labels).long(), tcfg, TCTX)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
          "audio_feats": jnp.asarray(feats)}
    tb = {"tokens": torch.from_numpy(toks).long(),
          "labels": torch.from_numpy(labels).long(),
          "audio_feats": torch.from_numpy(feats)}
    (jt, _), jg = jax.value_and_grad(jax_make_loss_fn(jcfg, JCTX),
                                     has_aux=True)(jp, jb)
    live = [p.clone().requires_grad_() for p in leaves(tp)]
    tt, _ = make_loss_fn(tcfg, dataclasses.replace(TCTX, remat=True))(
        unflatten(tp, live), tb)
    tt.backward()
    np.testing.assert_allclose(tt.item(), float(jt), rtol=1e-6)
    names = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(jg)[0]]
    assert any("encoder" in n for n in names)
    for p, g, name in zip(live, jax.tree.leaves(jg), names):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), atol=2e-5,
                                   rtol=1e-3, err_msg=name)


def test_forward_needs_audio_feats(model):
    _, _, tcfg, tp = model
    with pytest.raises(ValueError, match="audio_feats"):
        forward_hidden(tp, torch.zeros((1, 4), dtype=torch.long), tcfg, TCTX)


# ---------------------------------------------------------------------------
# serving


def test_prefill_cross_kv_matches_jax(model):
    """Every decoder layer's ck/cv (b, 64, kv, hd) within 1e-5; the
    self-attention caches stay zero."""
    jc, tc = _caches(model, 2, 12, seed=2)
    _close_cache(tc, jc, 1e-5)
    assert bool(tc["unit"]["p0"]["ck"].abs().max() > 0)
    assert not bool(tc["unit"]["p0"]["k"].any())


def test_decode_steps_match_jax(model):
    """16 tokens one step at a time after ``prefill_cross_kv``: every
    step's logits within 2e-4 (sinusoidal positions from the cache's pos),
    caches after the last step within 1e-5."""
    jcfg, jp, tcfg, tp = model
    b, s = 2, 16
    toks = _tokens(tcfg, b, s, seed=3)
    jc, tc = _caches(model, b, s, seed=4)
    step = jax.jit(lambda c, t: jdec.decode_step(jp, c, t, jcfg, JCTX))
    for t in range(s):
        jl, jc = step(jc, jnp.asarray(toks[:, t:t + 1]))
        tl, tc = tdec.decode_step(tp, tc, torch.from_numpy(
            toks[:, t:t + 1]).long(), tcfg, TCTX)
        _close(tl, jl, DECODE_TOL, f"step {t}")
    _close_cache(tc, jc, 1e-5)


def test_prefill_cache_matches_jax(model):
    """Fused prefill of 20 tokens after ``prefill_cross_kv``, then 4 decode
    steps: logits within 1e-4, caches within 1e-5."""
    jcfg, jp, tcfg, tp = model
    toks = _tokens(tcfg, 2, 20, seed=5)
    jc, tc = _caches(model, 2, 28, seed=6)
    jl, jc = jdec.prefill_cache(jp, jnp.asarray(toks), jc, jcfg, JCTX)
    tl, tc = tdec.prefill_cache(tp, torch.from_numpy(toks).long(), tc, tcfg,
                                TCTX)
    _close(tl, jl, 1e-4)
    _close_cache(tc, jc, 1e-5)
    for i in range(4):
        nxt = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        jl, jc = jdec.decode_step(jp, jc, jnp.asarray(nxt), jcfg, JCTX)
        tl, tc = tdec.decode_step(tp, tc, torch.from_numpy(nxt).long(),
                                  tcfg, TCTX)
        _close(tl, jl, 1e-4, f"step {i}")
    _close_cache(tc, jc, 1e-5)


def test_chunked_prefill_matches_jax_and_one_shot(model):
    """13 tokens in chunks of 4 (positions from each chunk's start, the
    cross-attention bidirectional over all 64 frames): against the
    reference's chunked prefill (logits 1e-4, caches 1e-5) and the port's
    one-shot prefill at the reference's chunked-vs-whole bound (atol 4e-6,
    rtol 1e-5)."""
    jcfg, jp, tcfg, tp = model
    toks = _tokens(tcfg, 1, 13, seed=7)
    jc, tc = _caches(model, 1, 16, seed=8)
    _, wc = _caches(model, 1, 16, seed=8)
    jcp = jdec.ChunkedPrefill(jp, jnp.asarray(toks), jc, jcfg, JCTX)
    tcp = tdec.ChunkedPrefill(tp, torch.from_numpy(toks).long(), tc, tcfg,
                              TCTX)
    while not tcp.done:
        assert tcp.step(4) == jcp.step(4)
    jl, jc = jcp.finish()
    tl, tc = tcp.finish()
    _close(tl, jl, 1e-4)
    _close_cache(tc, jc, 1e-5)
    wl, wc = tdec.prefill_cache(tp, torch.from_numpy(toks).long(), wc, tcfg,
                                TCTX)
    np.testing.assert_allclose(tl.numpy(), wl.numpy(), atol=4e-6, rtol=1e-5)
    for a, b in zip(leaves(tc), leaves(wc)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=4e-6,
                                   rtol=1e-5)


def _prefilled(model, plen, cache_len, seed):
    """A batch-1 fixed cache: cross K/V of its own frames, then a prompt."""
    _, _, tcfg, tp = model
    one = tdec.init_cache(tcfg, 1, cache_len, TCTX)
    one["pos"] = torch.zeros((1,), dtype=torch.int32)
    one = tdec.prefill_cross_kv(tp, torch.from_numpy(_feats(tcfg, 1, seed)),
                                tcfg, TCTX, one)
    toks = torch.from_numpy(_tokens(tcfg, 1, plen, seed=seed)).long()
    return tdec.prefill_cache(tp, toks, one, tcfg, TCTX)[1]


def test_paged_decode_bit_identical_to_fixed(model):
    """Fixed-slot and paged caches at one occupancy, each request with its
    own frames (its cross K/V slot-resident beside the paged self-attention
    K/V), decode the same logits bit for bit through inserts, steps and an
    eviction whose pages go to a new request; the evicted slot's cross K/V
    is zeroed and the others' kept."""
    _, _, tcfg, tp = model
    max_batch, cache_len, page, gen = 4, 32, 8, 6
    fixed = tdec.init_slot_cache(tcfg, max_batch, cache_len, TCTX)
    paged = tdec.init_paged_cache(tcfg, max_batch, cache_len, TCTX,
                                  page_size=page, num_pages=16)
    assert "bt" in paged["unit"]["p0"] and "ck" in paged["unit"]["p0"]
    pool = paging.PagePool(16)
    held, srcs = {}, {}

    def admit(slot, plen, seed):
        srcs[slot] = _prefilled(model, plen, cache_len, seed)
        tdec.slot_insert(fixed, slot, srcs[slot])
        held[slot] = pool.alloc(tdec.pages_needed(tcfg, cache_len, page,
                                                  plen + gen))
        tdec.slot_insert(paged, slot, srcs[slot], pages=held[slot])

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
            assert not bool(paged["unit"]["p0"]["ck"][:, 1].any())
            assert torch.equal(paged["unit"]["p0"]["cv"][:, 0],
                               srcs[0]["unit"]["p0"]["cv"][:, 0])
            admit(3, 9, 30)
            live = [0, 2, 3]


def test_paged_cache_from_jax_decodes_like_jax(model):
    """A reference paged cache whose slots hold their own cross K/V, carried
    across by ``cache_from_jax``, decodes one step to the reference's
    logits (1e-4) and caches (1e-5)."""
    jcfg, jp, tcfg, tp = model
    cache_len, page = 32, 8
    jc = jdec.init_paged_cache(jcfg, 2, cache_len, JCTX, page_size=page,
                               num_pages=8)
    for slot, plen in enumerate((6, 13)):
        one = jdec.prefill_cross_kv(
            jp, jnp.asarray(_feats(tcfg, 1, 40 + slot)), jcfg, JCTX,
            jdec.init_cache(jcfg, 1, cache_len, JCTX))
        toks = jnp.asarray(_tokens(tcfg, 1, plen, seed=40 + slot))
        _, src = jdec.prefill_cache(jp, toks, one, jcfg, JCTX)
        jc = jdec.slot_insert(jc, slot, src,
                              pages=list(range(4 * slot, 4 * slot + 4)))
    tc = cache_from_jax(jax.tree.map(np.asarray, jc), device="cpu")
    tok = np.array([[2], [5]], np.int32)
    jl, jc = jdec.decode_step(jp, jc, jnp.asarray(tok), jcfg, JCTX)
    tl, tc = tdec.decode_step(tp, tc, torch.from_numpy(tok).long(), tcfg,
                              TCTX)
    _close(tl, jl, 1e-4)
    _close_cache(tc, jc, 1e-5)


def test_slot_runners_serve_with_zero_cross_kv(model):
    """Behind the scheduler, neither package's ``SlotRunner`` runs the
    encoder: a request's cross K/V stay zero (reference behaviour, kept).
    The port's fixed-slot and paged runners and the reference's runner fed
    the same prompts generate the same greedy tokens, and every cross leaf
    of both packages' caches is still zero after the run."""
    jcfg, jp, tcfg, tp = model

    def run(pkg, params, cfg, ctx, prompts=None, **kw):
        runner = pkg.SlotRunner(params, cfg, ctx, 2, 40, **kw)
        if prompts is not None:
            runner.prompt_tokens = prompts
        trace = pkg.RequestStream(dist="S1", n_clients=4, prompt_lens=(8, 20),
                                  max_new_tokens=6, slo_ttft_s=2.0,
                                  slo_tpot_s=0.5, seed=0).generate(2.0)
        cost = pkg.StepCostModel(decode_step_s=0.01, prefill_token_s=5e-4,
                                 prefill_base_s=1e-3)
        _, s = pkg.Scheduler(2, cost, runners=[runner],
                             chunk_tokens=8).run(trace, horizon_s=2.0)
        assert s["conservation_ok"]
        return runner

    fixed = run(tserve, tp, tcfg, TCTX)
    paged = run(tserve, tp, tcfg, TCTX, page_size=8, num_pages=12,
                prefix_sharing=True)
    assert paged.prefix_index is None       # whisper shares no prefix
    ref = run(jserve, jp, jcfg, JCTX, prompts=lambda req: jnp.asarray(
        fixed.prompt_tokens(req).numpy().astype(np.int32)))
    assert len(fixed.generated) > 2
    assert paged.generated == fixed.generated
    assert ref.generated == fixed.generated
    for cache in (fixed.cache, paged.cache):
        for cl in list(cache["unit"].values()) + list(cache["rest"].values()):
            assert not bool(cl["ck"].any()) and not bool(cl["cv"].any())
    for cl in list(ref.cache["unit"].values()) + list(
            ref.cache["rest"].values()):
        assert not bool(jnp.any(cl["ck"])) and not bool(jnp.any(cl["cv"]))


def test_offline_launcher_serves_on_cpu():
    """The launcher draws the frames from their own stream, fills the cross
    K/V and decodes greedily; the plain path from the same frames gives
    the same tokens.  The first three streams are those of a launcher with
    three (init, prompts, sampling)."""
    args = launch.parse_args(["--arch", ARCH, "--reduced", "--device", "cpu",
                              "--batch", "2", "--prompt-len", "16", "--gen",
                              "4", "--temperature", "0"])
    res = launch.run_offline(args)
    cfg = res["cfg"]
    assert res["tokens"].shape == (2, 4)
    assert res["audio_feats"].shape == (2, cfg.encoder_seq_len, cfg.d_model)
    assert torch.equal(res["audio_feats"],
                       launch.audio_feats(args, cfg, torch.device("cpu")))
    cfg, ctx, params, prompts, _ = launch.setup(args)
    ctx = dataclasses.replace(ctx, prefill_backend="torch",
                              decode_backend="torch")
    cache = tdec.prefill_cross_kv(params, res["audio_feats"], cfg, ctx,
                                  tdec.init_cache(cfg, 2, 20, ctx))
    logits, cache = tdec.prefill_cache(params, prompts, cache, cfg, ctx)
    for i in range(4):
        nxt = torch.argmax(logits, -1)
        assert torch.equal(nxt, res["tokens"][:, i])
        logits, cache = tdec.decode_step(params, cache, nxt[:, None], cfg,
                                         ctx)
    seeds = [int(s.generate_state(1)[0])
             for s in np.random.SeedSequence(args.seed).spawn(3)]
    for g, seed in zip(launch.generators(args.seed, "cpu"), seeds):
        assert torch.equal(g.get_state(),
                           torch.Generator().manual_seed(seed).get_state())


@pytest.mark.parametrize("arch", ["whisper-base", "xlstm-125m"])
def test_prefix_sharing_supported_is_none(arch):
    """Neither whisper (cross K/V keyed on audio) nor xLSTM (state, no
    pages) shares prompt-prefix pages, in either package."""
    jcfg, tcfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    for cache_len, page in ((32, 8), (48, 16)):
        assert tdec.prefix_sharing_supported(tcfg, cache_len, page) is None
        assert jdec.prefix_sharing_supported(jcfg, cache_len, page) is None
