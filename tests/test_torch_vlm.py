"""The port's VLM family (qwen2-vl) against the JAX package, on the CPU.

Reduced qwen2-vl-2b: 2 full-attention layers (4 query and 2 kv heads of
64, d 256, QKV biases, tied embeddings), M-RoPE over sections (16, 8, 8)
and 16 patch embeddings.  The reference's params, with numpy noise on the
leaves it makes zero (norm scales, QKV biases), are carried across by
``params_from_jax``; tokens, patch embeddings (the stubbed vision tower's
output) and the three position streams come from numpy seeds.  The
patches sit on a 4 x 4 grid (temporal 0, height the row, width the
column); the text after them continues on all three streams, as Qwen2-VL
numbers a prompt.  The reference runs its jax paths
(``kernel_interpret=False``).

Covered: ``mrope_angles``; the training forward, loss and ``make_loss_fn``'s
gradient with ``patch_embeds`` and ``mrope_positions``, and without them
(1-D RoPE); serving on 1-D RoPE, as the reference's decode and prefill
serve this family: ``decode_step`` step by step, ``prefill_cache``,
``ChunkedPrefill``, the runner with prefix sharing behind the scheduler,
the launcher.  Tolerances are ``tests/test_torch_zoo.py``'s: angles and
hidden states 1e-5, logits 1e-4 (decode 2e-4), caches 1e-5, gradients
2e-5 + 1e-3 relative.
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
from repro.models import layers as jL  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.train.step import make_loss_fn as jax_make_loss_fn  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models import decode as tdec  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models.transformer import (RunCtx, forward_hidden,  # noqa: E402
                                            lm_loss)
from repro_torch.train.step import make_loss_fn  # noqa: E402
from repro_torch.tree import leaves, unflatten  # noqa: E402

ARCH = "qwen2-vl-2b"
JCTX = jtf.RunCtx(remat=False, chunk_q=8, chunk_k=8, loss_chunk=8,
                  kernel_interpret=False)
TCTX = RunCtx(remat=False, loss_chunk=8, device="cpu")
NOISY = ("'scale'", "'bq'", "'bk'", "'bv'")
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


def _vision(cfg, b, s, seed):
    """(patch embeddings (b, np, d), M-RoPE positions (3, b, s)): np
    patches on a sqrt(np) grid, then text numbered on from the grid's
    largest position; the second row's text starts 3 later."""
    npk = cfg.num_patch_tokens
    side = int(round(npk ** 0.5))
    patches = (0.5 * np.random.default_rng(seed).standard_normal(
        (b, npk, cfg.d_model))).astype(np.float32)
    grid = np.arange(npk)
    pos = np.zeros((3, b, s), np.int32)
    pos[1, :, :npk] = grid // side
    pos[2, :, :npk] = grid % side
    for row in range(b):
        text = side + 3 * row + np.arange(s - npk)
        pos[:, row, npk:] = text
    return patches, pos


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


# ---------------------------------------------------------------------------
# M-RoPE


@pytest.mark.parametrize("arch", [ARCH, None])
def test_mrope_angles_match_jax(arch):
    """cos and sin over the three streams within 1e-5, at the reduced
    config's sections (16, 8, 8) and the full config's (16, 24, 24) at hd
    128, theta 1e6."""
    cfg = get_config(ARCH)
    if arch is not None:
        cfg = cfg.reduced()
    _, pos = _vision(cfg.reduced(), 2, 40, seed=1)
    hd = cfg.resolved_head_dim
    jc, js = jL.mrope_angles(jnp.asarray(pos), hd, cfg.mrope_sections,
                             cfg.rope_theta)
    tc, ts = tL.mrope_angles(torch.from_numpy(pos), hd, cfg.mrope_sections,
                             cfg.rope_theta)
    assert tuple(tc.shape) == (2, 40, hd // 2)
    _close(tc, jc, 1e-5)
    _close(ts, js, 1e-5)
    with pytest.raises(ValueError, match="sum"):
        tL.mrope_angles(torch.from_numpy(pos), hd, (8, 8, 8), cfg.rope_theta)


# ---------------------------------------------------------------------------
# training forward


@pytest.mark.parametrize("vision", [True, False])
def test_forward_loss_and_grad_match_jax(model, vision):
    """With patch embeddings and M-RoPE positions (and, without, on 1-D
    RoPE): hidden states within 1e-5, the loss and ``make_loss_fn``'s total
    within 1e-6 relative, its gradient within 2e-5 + 1e-3 relative."""
    jcfg, jp, tcfg, tp = model
    b, s = 2, 32
    toks = _tokens(tcfg, b, s)
    labels = np.roll(toks, -1, axis=1)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks).long(),
          "labels": torch.from_numpy(labels).long()}
    if vision:
        patches, pos = _vision(tcfg, b, s, seed=2)
        jb.update(patch_embeds=jnp.asarray(patches),
                  mrope_positions=jnp.asarray(pos))
        tb.update(patch_embeds=torch.from_numpy(patches),
                  mrope_positions=torch.from_numpy(pos))
    extra = {k: v for k, v in jb.items() if k not in ("tokens", "labels")}
    jh, _ = jtf.forward_hidden(jp, jb["tokens"], jcfg, JCTX, **extra)
    th, _ = forward_hidden(tp, tb["tokens"], tcfg, TCTX,
                           **{k: tb[k] for k in extra})
    _close(th, jh, 1e-5)
    jl = jtf.lm_loss(jp, jh, jb["labels"], jcfg, JCTX)
    tl = lm_loss(tp, th, tb["labels"], tcfg, TCTX)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    (jt, _), jg = jax.value_and_grad(jax_make_loss_fn(jcfg, JCTX),
                                     has_aux=True)(jp, jb)
    live = [p.clone().requires_grad_() for p in leaves(tp)]
    tt, _ = make_loss_fn(tcfg, dataclasses.replace(TCTX, remat=True))(
        unflatten(tp, live), tb)
    tt.backward()
    np.testing.assert_allclose(tt.item(), float(jt), rtol=1e-6)
    for p, g in zip(live, jax.tree.leaves(jg)):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), atol=2e-5,
                                   rtol=1e-3)


def test_patches_replace_the_first_embeddings(model):
    """The first ``num_patch_tokens`` rows of the stream are the patches:
    their token ids do not reach the output, the rest's do."""
    _, _, tcfg, tp = model
    b, s = 1, 24
    toks = torch.from_numpy(_tokens(tcfg, b, s, seed=3)).long()
    patches, pos = _vision(tcfg, b, s, seed=4)
    kw = dict(patch_embeds=torch.from_numpy(patches),
              mrope_positions=torch.from_numpy(pos))
    with torch.no_grad():
        h, _ = forward_hidden(tp, toks, tcfg, TCTX, **kw)
        other = toks.clone()
        other[:, :tcfg.num_patch_tokens] = 0
        assert torch.equal(forward_hidden(tp, other, tcfg, TCTX, **kw)[0], h)
        other[:, -1] = (other[:, -1] + 1) % tcfg.vocab_size
        assert not torch.equal(forward_hidden(tp, other, tcfg, TCTX, **kw)[0],
                               h)


# ---------------------------------------------------------------------------
# serving (1-D RoPE, as the reference serves this family)


def test_decode_steps_match_jax(model):
    """20 tokens one step at a time: logits within 2e-4, caches 1e-5."""
    jcfg, jp, tcfg, tp = model
    b, s = 2, 20
    toks = _tokens(tcfg, b, s, seed=5)
    jc = jdec.init_cache(jcfg, b, s, JCTX)
    tc = tdec.init_cache(tcfg, b, s, TCTX)
    step = jax.jit(lambda c, t: jdec.decode_step(jp, c, t, jcfg, JCTX))
    for t in range(s):
        jl, jc = step(jc, jnp.asarray(toks[:, t:t + 1]))
        tl, tc = tdec.decode_step(tp, tc, torch.from_numpy(
            toks[:, t:t + 1]).long(), tcfg, TCTX)
        _close(tl, jl, DECODE_TOL, f"step {t}")
    _close_cache(tc, jc, 1e-5)


def test_prefill_and_chunked_prefill_match_jax(model):
    """Fused prefill of 19 tokens into a 24-token cache and a chunked one
    (chunks of 8): logits within 1e-4, caches within 1e-5, then the two
    port prefills against each other at atol 4e-6, rtol 1e-5."""
    jcfg, jp, tcfg, tp = model
    toks = _tokens(tcfg, 1, 19, seed=6)
    jl, jc = jdec.prefill_cache(jp, jnp.asarray(toks),
                                jdec.init_cache(jcfg, 1, 24, JCTX), jcfg,
                                JCTX)
    tl, tc = tdec.prefill_cache(tp, torch.from_numpy(toks).long(),
                                tdec.init_cache(tcfg, 1, 24, TCTX), tcfg,
                                TCTX)
    _close(tl, jl, 1e-4)
    _close_cache(tc, jc, 1e-5)
    jcp = jdec.ChunkedPrefill(jp, jnp.asarray(toks),
                              jdec.init_cache(jcfg, 1, 24, JCTX), jcfg, JCTX)
    tcp = tdec.ChunkedPrefill(tp, torch.from_numpy(toks).long(),
                              tdec.init_cache(tcfg, 1, 24, TCTX), tcfg, TCTX)
    while not tcp.done:
        assert tcp.step(8) == jcp.step(8)
    cl, cc = tcp.finish()
    jl2, jc2 = jcp.finish()
    _close(cl, jl2, 1e-4)
    _close_cache(cc, jc2, 1e-5)
    np.testing.assert_allclose(cl.numpy(), tl.numpy(), atol=4e-6, rtol=1e-5)


def test_real_runner_with_prefix_sharing_matches_jax(model):
    """A template trace through the scheduler with chunked prefill: the
    port's fixed-slot and paged runners with prefix sharing (every layer
    full attention, so this family shares) and the reference's runner fed
    the same prompts generate the same greedy tokens."""
    jcfg, jp, tcfg, tp = model

    def run(pkg, params, cfg, ctx, prompts=None, **kw):
        runner = pkg.SlotRunner(params, cfg, ctx, 2, 48, **kw)
        if prompts is not None:
            runner.prompt_tokens = prompts
        trace = pkg.RequestStream(dist="S1", n_clients=4, prompt_lens=(8, 24),
                                  max_new_tokens=6, slo_ttft_s=2.0,
                                  slo_tpot_s=0.5, seed=0, n_templates=2,
                                  template_prefix_len=16).generate(2.0)
        cost = pkg.StepCostModel(decode_step_s=0.01, prefill_token_s=5e-4,
                                 prefill_base_s=1e-3)
        _, s = pkg.Scheduler(2, cost, runners=[runner],
                             chunk_tokens=8).run(trace, horizon_s=2.0)
        assert s["conservation_ok"]
        return runner, s

    fixed, _ = run(tserve, tp, tcfg, TCTX)
    shared, s = run(tserve, tp, tcfg, TCTX, page_size=8, num_pages=16,
                    prefix_sharing=True)
    assert shared.prefix_index is not None
    assert s["prefix_sharing"]["hits"] > 0
    ref, _ = run(jserve, jp, jcfg, JCTX, prompts=lambda req: jnp.asarray(
        fixed.prompt_tokens(req).numpy().astype(np.int32)))
    assert len(fixed.generated) > 2
    assert shared.generated == fixed.generated
    assert ref.generated == fixed.generated


def test_offline_launcher_serves_on_cpu():
    args = launch.parse_args(["--arch", ARCH, "--reduced", "--device", "cpu",
                              "--batch", "2", "--prompt-len", "16", "--gen",
                              "4", "--temperature", "0"])
    res = launch.run_offline(args)
    assert res["tokens"].shape == (2, 4)
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
