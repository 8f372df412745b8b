"""The port's serving slice against the JAX package, end to end on the CPU.

Reduced qwen2-0.5b: the reference's params, with numpy noise on the QKV
biases and norm scales (the reference initialises them to zero, which would
leave the bias and ``(1 + scale)`` paths unexercised), are carried across by
``params_from_jax``; both packages then prefill the same prompts and decode
greedily.  Logits agree to 1e-4 (the reference's own decode-backend bound,
tests/test_kernels_decode.py), K/V caches to 1e-5, greedy tokens exactly.
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
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import decode as tdec  # noqa: E402
from repro_torch.models import (RunCtx, decode_step, init_cache,  # noqa: E402
                                init_params, init_slot_cache, prefill_cache,
                                slot_evict, slot_insert)

JCTX = JaxCtx(remat=False, chunk_q=8, chunk_k=8)
TCTX = RunCtx(chunk_q=8, chunk_k=8, device="cpu")


def _cfgs(window=None):
    jcfg = jax_get_config("qwen2-0.5b").reduced()
    tcfg = get_config("qwen2-0.5b").reduced()
    if window is not None:
        jcfg = dataclasses.replace(jcfg, long_context_variant_window=window)
        tcfg = dataclasses.replace(tcfg, long_context_variant_window=window)
    return jcfg, tcfg


def _noisy_params(jcfg, tcfg, seed=0):
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


def _prompts(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s),
                                                dtype=np.int32)


def _assert_cache_close(jc, tc):
    for part in ("unit", "rest"):
        for layer, cl in jc[part].items():
            for name, a in cl.items():
                np.testing.assert_allclose(
                    tc[part][layer][name].numpy(), np.asarray(a), atol=1e-5,
                    err_msg=f"{part}.{layer}.{name}")
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("long_context", [False, True])
def test_prefill_and_greedy_decode_match_jax(long_context):
    """Default pattern, and the long-context pattern with a prompt longer
    than its window: prefill folds the prompt into the ring, and decode
    keeps wrapping it."""
    jcfg, tcfg = _cfgs(window=16 if long_context else None)
    jp, tp = _noisy_params(jcfg, tcfg)
    jpat = jcfg.pattern_for_long_context() if long_context else None
    tpat = tcfg.pattern_for_long_context() if long_context else None
    b, plen, gen = 2, (24 if long_context else 12), 8
    cache_len = plen + gen
    toks = _prompts(jcfg, b, plen, 3)

    jl, jc = jdec.prefill_cache(jp, jnp.asarray(toks),
                                jdec.init_cache(jcfg, b, cache_len, JCTX,
                                                pattern=jpat),
                                jcfg, JCTX, pattern=jpat)
    tl, tc = prefill_cache(tp, torch.from_numpy(toks),
                           init_cache(tcfg, b, cache_len, TCTX, pattern=tpat),
                           tcfg, TCTX, pattern=tpat)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    _assert_cache_close(jc, tc)
    if long_context:
        assert tc["unit"]["p0"]["k"].shape[2] == 16 < plen  # ring folded

    jstep = jax.jit(lambda c, t: jdec.decode_step(jp, c, t, jcfg, JCTX,
                                                  pattern=jpat))
    for _ in range(gen):
        jt = np.asarray(jnp.argmax(jl, axis=-1))
        tt = torch.argmax(tl, dim=-1)
        np.testing.assert_array_equal(tt.numpy(), jt)
        jl, jc = jstep(jc, jnp.asarray(jt)[:, None])
        tl, tc = decode_step(tp, tc, tt[:, None], tcfg, TCTX, pattern=tpat)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    _assert_cache_close(jc, tc)


def test_slot_insert_evict_reinsert_matches_jax():
    """Mixed-age continuous batching: three requests of different prompt
    lengths share a per-slot cache; slot 1 is evicted mid-flight and
    re-admitted with a new request.  Per-slot kv_len reaches decode."""
    jcfg, tcfg = _cfgs()
    jp, tp = _noisy_params(jcfg, tcfg)
    max_batch, cache_len = 4, 32

    def admit(jc, tc, slot, plen, seed):
        toks = _prompts(jcfg, 1, plen, seed)
        _, jsrc = jdec.prefill_cache(
            jp, jnp.asarray(toks), jdec.init_cache(jcfg, 1, cache_len, JCTX),
            jcfg, JCTX)
        _, tsrc = prefill_cache(tp, torch.from_numpy(toks),
                                init_cache(tcfg, 1, cache_len, TCTX),
                                tcfg, TCTX)
        return jdec.slot_insert(jc, slot, jsrc), slot_insert(tc, slot, tsrc)

    jc = jdec.init_slot_cache(jcfg, max_batch, cache_len, JCTX)
    tc = init_slot_cache(tcfg, max_batch, cache_len, TCTX)
    for slot, plen in enumerate([5, 11, 3]):
        jc, tc = admit(jc, tc, slot, plen, 10 + slot)
    _assert_cache_close(jc, tc)

    jstep = jax.jit(lambda c, t: jdec.decode_step(jp, c, t, jcfg, JCTX))
    tok = np.array([[3], [7], [1], [0]], np.int32)
    for i in range(7):
        jl, jc = jstep(jc, jnp.asarray(tok))
        tl, tc = decode_step(tp, tc, torch.tensor(tok), tcfg, TCTX)
        np.testing.assert_allclose(tl.numpy()[:3], np.asarray(jl)[:3],
                                   atol=1e-4)
        tok = np.asarray(jnp.argmax(jl, axis=-1), np.int32)[:, None]
        if i == 2:
            jc, tc = jdec.slot_evict(jc, 1), slot_evict(tc, 1)
            assert int(tc["pos"][1]) == 0
            assert not tc["unit"]["p0"]["k"][:, 1].any()
            jc, tc = admit(jc, tc, 1, 7, 99)
    _assert_cache_close(jc, tc)


def test_offline_launcher_on_cpu():
    """The launcher's offline mode runs the slice end to end on the CPU,
    deterministically from its seed."""
    argv = ["--reduced", "--device", "cpu", "--batch", "2", "--prompt-len",
            "8", "--gen", "4", "--temperature", "0"]
    a = serve.run_offline(serve.parse_args(argv))
    b = serve.run_offline(serve.parse_args(argv))
    assert a["tokens"].shape == (2, 4)
    assert torch.isfinite(a["last_logits"]).all()
    assert torch.equal(a["tokens"], b["tokens"])
    sampled = serve.run_offline(serve.parse_args(argv[:-1] + ["1.0"]))
    assert sampled["tokens"].shape == (2, 4)


def test_params_from_jax_rejects_mismatch():
    jcfg, tcfg = _cfgs()
    tree = jax.tree.map(np.asarray,
                        jax_init_params(jax.random.PRNGKey(1), jcfg))
    bad_shape = dict(tree, embed=tree["embed"][:, :8])
    with pytest.raises(ValueError, match="embed"):
        params_from_jax(bad_shape, tcfg, device="cpu")
    missing = dict(tree, final_norm={})
    with pytest.raises(ValueError, match="final_norm"):
        params_from_jax(missing, tcfg, device="cpu")


def test_params_from_jax_keeps_bf16():
    """bf16 reference params (ml_dtypes arrays in numpy) arrive as bf16
    tensors with the same values."""
    jcfg, tcfg = _cfgs()
    tree = jax.tree.map(np.asarray, jax_init_params(
        jax.random.PRNGKey(2), jcfg, dtype=jnp.bfloat16))
    tp = params_from_jax(tree, tcfg, device="cpu")
    w = tp["unit"]["p0"]["attn"]["wq"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w.float().numpy(),
        tree["unit"]["p0"]["attn"]["wq"].astype(np.float32))


@pytest.mark.parametrize("arch", ["whisper-base", "xlstm-125m",
                                  "qwen2-vl-2b"])
def test_new_families_build_the_reference_trees(arch):
    """``init_params`` and ``init_cache`` (fixed and paged) build the
    reference's trees for the xLSTM, audio and VLM families: every leaf's
    name, shape and dtype (whisper's ``encoder`` and cross leaves, the
    mLSTM/sLSTM params and f32 states)."""
    def spec(tree, strip=""):
        return jax.tree.map(lambda a: (tuple(a.shape),
                                       str(a.dtype).replace(strip, "")), tree)

    jcfg = jax_get_config(arch).reduced()
    tcfg = get_config(arch).reduced()
    jparams = jax.eval_shape(lambda k: jax_init_params(k, jcfg),
                             jax.random.PRNGKey(0))
    assert spec(jparams) == spec(init_params(None, tcfg, device="meta"),
                                 "torch.")
    assert (spec(jdec.init_cache(jcfg, 2, 24, JCTX, as_spec=True))
            == spec(init_cache(tcfg, 2, 24, TCTX), "torch."))
    jpaged = jdec.init_paged_cache(jcfg, 3, 32, JCTX, page_size=8,
                                   num_pages=6)
    tpaged = tdec.init_paged_cache(tcfg, 3, 32, TCTX, page_size=8,
                                   num_pages=6)
    assert spec(jpaged) == spec(tpaged, "torch.")
    # params_from_jax takes that tree and refuses one leaf more or less
    tree = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), jparams)
    params_from_jax(tree, tcfg, device="cpu")
    block = tree["unit"]["p0"]
    block["extra"] = np.zeros((1,), np.float32)
    with pytest.raises(ValueError, match="extra"):
        params_from_jax(tree, tcfg, device="cpu")
    del block["extra"]
    block.pop(sorted(k for k in block if k.startswith("norm"))[0])
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(tree, tcfg, device="cpu")
