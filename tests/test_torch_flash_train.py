"""The port's training attention, ``chunked_attention(backend="torch")`` (the
chunked flash with its own backward), against the reference's
``chunked_attention`` (its jax path, the custom-VJP ``_flash``), on the CPU.

The same numpy inputs from a seed go through both.  Cases: causal, swa
(windows 16 and 24) and bidir; g 1/2/4; hd 16-64; chunks 8/16/32 and ones
that do not divide the sequence and snap to ``gcd(min(chunk, s), s)``;
q_offset 0 and 8 (keys before the queries, as in chunked prefill); static
int offsets and tensor offsets (mask only).  Bars: the forward within 1e-5,
gradients of ``sum(sin(o))`` (``torch.autograd.grad`` against ``jax.grad``,
as ``tests/test_attention.py``) within 1e-4 rel + 1e-5 abs.  Also:
``_extent`` equal to the reference's on a grid; the tensor offset against
the static one; what the function keeps for its backward; the ``swa``
refusal; and ``make_loss_fn``'s loss and gradient on reduced qwen2-0.5b and
whisper-base at chunks of 16 over 64 tokens (4 query chunks a layer, remat
on) at ``tests/test_torch_train.py``'s bar.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.train.step import make_loss_fn as jax_make_loss_fn  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import RunCtx  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.train.step import make_loss_fn  # noqa: E402
from repro_torch.tree import leaves, unflatten  # noqa: E402

B, SQ = 2, 64
# (kind, window, h, kv, hd, chunk_q, chunk_k, q_offset, static)
CASES = [
    ("causal", 0, 2, 2, 16, 8, 8, 0, True),
    ("causal", 0, 4, 2, 32, 16, 32, 8, True),
    ("causal", 0, 8, 2, 64, 32, 16, 8, False),
    ("causal", 0, 4, 2, 16, 24, 40, 8, True),        # both snap: 8 and 8
    ("swa", 16, 4, 2, 16, 16, 16, 0, True),
    ("swa", 16, 4, 1, 32, 8, 32, 8, True),
    ("swa", 16, 4, 2, 32, 16, 16, 8, False),
    ("swa", 24, 2, 2, 64, 32, 32, 0, True),
    ("swa", 24, 4, 2, 16, 24, 12, 8, True),          # snap: 8 and 4
    ("swa", 24, 8, 2, 16, 16, 16, 0, False),
    ("bidir", 0, 8, 2, 16, 32, 8, 0, True),
    ("bidir", 0, 4, 2, 64, 48, 16, 0, True),         # snap: 16
]


def _ids(case):
    kind, window, h, kvh, hd, cq, ck, off, static = case
    return (f"{kind}{window or ''}-g{h // kvh}-hd{hd}-c{cq}x{ck}-off{off}-"
            f"{'static' if static else 'tensor'}")


def _inputs(h, kvh, hd, sk, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, SQ, h, hd)).astype(np.float32),
            rng.standard_normal((B, sk, kvh, hd)).astype(np.float32),
            rng.standard_normal((B, sk, kvh, hd)).astype(np.float32))


def _jax_run(q, k, v, **kw):
    def f(q, k, v):
        return jattn.chunked_attention(q, k, v, **kw)

    args = tuple(jnp.asarray(x) for x in (q, k, v))
    out = jax.jit(f)(*args)
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(jnp.sin(f(*a))),
                             argnums=(0, 1, 2)))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _torch_run(q, k, v, **kw):
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = tattn.chunked_attention(*ts, backend="torch", **kw)
    grads = torch.autograd.grad(torch.sin(out).sum(), ts)
    return out.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_chunked_flash_matches_reference(case):
    kind, window, h, kvh, hd, cq, ck, off, static = case
    q, k, v = _inputs(h, kvh, hd, SQ + off, seed=CASES.index(case))
    kw = dict(kind=kind, window=window, chunk_q=cq, chunk_k=ck,
              static_offset=static)
    jo, jg = _jax_run(q, k, v, q_offset=off, **kw)
    to, tg = _torch_run(q, k, v, q_offset=off if static else torch.tensor(off),
                        **kw)
    np.testing.assert_allclose(to, jo, rtol=0, atol=1e-5)
    for t, j, name in zip(tg, jg, "qkv"):
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-5,
                                   err_msg=f"d{name}")


def test_extent_matches_reference_on_a_grid():
    n = 0
    for kind in ("causal", "swa", "bidir"):
        for window in (0, 16, 24):
            for chunk_k in (8, 16, 32):
                for sk in (64, 72, 96):
                    for q_lo in range(0, 96, 8):
                        for chunk_q in (8, 16, 32):
                            for static in (True, False):
                                args = (kind, q_lo, q_lo + chunk_q, sk,
                                        window, chunk_k, static)
                                assert (tattn._extent(*args)
                                        == jattn._extent(*args)), args
                                n += 1
    assert n == 3 * 3 * 3 * 3 * 12 * 3 * 2


@pytest.mark.parametrize("kind,window", [("causal", 0), ("swa", 16)])
def test_tensor_offset_agrees_with_static(kind, window):
    """The traced offset masks the blocks the static one skips; both give
    the same output and gradients within f32 summation noise."""
    q, k, v = _inputs(4, 2, 32, SQ + 8, seed=5)
    kw = dict(kind=kind, window=window, chunk_q=16, chunk_k=16)
    so, sg = _torch_run(q, k, v, q_offset=8, **kw)
    to, tg = _torch_run(q, k, v, q_offset=torch.tensor(8),
                        static_offset=False, **kw)
    io, ig = _torch_run(q, k, v, q_offset=8, static_offset=False, **kw)
    for other, og in ((to, tg), (io, ig)):
        np.testing.assert_allclose(other, so, rtol=0, atol=1e-6)
        for a, b in zip(og, sg):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_backward_keeps_q_k_v_o_and_lse_only():
    """What autograd holds for the backward: the grouped q, k, v, the
    output and the (b, kv, g, sq) log-sum-exp; no score-sized tensor."""
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    q, k, v = (torch.tensor(x, requires_grad=True)
               for x in _inputs(4, 2, 16, SQ, seed=6))
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = tattn.chunked_attention(q, k, v, kind="causal", chunk_q=16,
                                      chunk_k=16, backend="torch")
    assert sorted(saved) == sorted([(B, SQ, 2, 2, 16), (B, SQ, 2, 16),
                                    (B, SQ, 2, 16), (B, 2, 2, SQ, 16),
                                    (B, 2, 2, SQ)])
    assert out.shape == (B, SQ, 4, 16)


def test_swa_window_that_holds_no_key_is_refused():
    q, k, v = (torch.tensor(x) for x in _inputs(2, 2, 16, SQ, seed=7))
    with pytest.raises(ValueError, match="no key"):
        tattn.chunked_attention(q, k[:, :8], v[:, :8], kind="swa", window=8,
                                q_offset=8, backend="torch")
    with pytest.raises(ValueError, match="no key"):
        tattn.chunked_attention(q, k[:, :8], v[:, :8], kind="swa", window=8,
                                q_offset=8, static_offset=False,
                                backend="torch")
    # just inside: the last query's window reaches the last key
    tattn.chunked_attention(q, k, v, kind="swa", window=8, q_offset=7,
                            chunk_q=16, chunk_k=16, backend="torch")


def _noisy(arch, names):
    jcfg, tcfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    tree = jax.tree.map(np.asarray, jtf.init_params(jax.random.PRNGKey(1),
                                                    jcfg))
    rng = np.random.default_rng(0)

    def noise(path, a):
        if any(n in jax.tree_util.keystr(path) for n in names):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(noise, tree)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            params_from_jax(tree, tcfg, device="cpu"))


@pytest.mark.parametrize("arch,noisy", [
    ("qwen2-0.5b", ("'bq'", "'bk'", "'bv'", "'scale'")),
    ("whisper-base", ("'scale'", "'bias'"))])
def test_loss_and_gradient_through_the_chunked_flash(arch, noisy):
    """``make_loss_fn``'s total within 1e-6 relative and its gradient
    within 2e-5 + 1e-3 relative (``tests/test_torch_train.py``'s bar),
    chunks of 16 over 64 tokens on both sides, remat on in the port."""
    jcfg, tcfg, jp, tp = _noisy(arch, noisy)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tcfg.vocab_size, (2, SQ), dtype=np.int32)
    labels = np.roll(toks, -1, axis=1)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks).long(),
          "labels": torch.from_numpy(labels).long()}
    if tcfg.encoder_layers:
        feats = rng.standard_normal(
            (2, tcfg.encoder_seq_len, tcfg.d_model)).astype(np.float32)
        jb["audio_feats"] = jnp.asarray(feats)
        tb["audio_feats"] = torch.from_numpy(feats)
    jctx = jtf.RunCtx(remat=False, chunk_q=16, chunk_k=16, loss_chunk=16,
                      kernel_interpret=False)
    tctx = RunCtx(remat=True, chunk_q=16, chunk_k=16, loss_chunk=16,
                  device="cpu")
    (jt, _), jg = jax.value_and_grad(jax_make_loss_fn(jcfg, jctx),
                                     has_aux=True)(jp, jb)
    live = [p.clone().requires_grad_() for p in leaves(tp)]
    tt, _ = make_loss_fn(tcfg, tctx)(unflatten(tp, live), tb)
    tt.backward()
    np.testing.assert_allclose(tt.item(), float(jt), rtol=1e-6)
    for p, g in zip(live, jax.tree.leaves(jg)):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), atol=2e-5,
                                   rtol=1e-3)
    # the same loss with the chunks at the sequence: one block a layer
    whole = dataclasses.replace(tctx, chunk_q=SQ, chunk_k=SQ)
    np.testing.assert_allclose(
        make_loss_fn(tcfg, whole)(tp, tb)[0].item(), tt.item(), rtol=1e-6)
