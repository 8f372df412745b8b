"""The port's RG-LRU block (``repro_torch/models/rglru.py``) against the JAX
package's ``repro/models/rglru.py``, on the CPU.

The reference's params (``init_rglru`` at reduced recurrentgemma width,
r 256) are carried across leaf by leaf, with numpy noise on ``conv_b``,
``b_a`` and ``b_i`` (the reference makes them zero).  Covered: the chunked
recurrence across three chunks (chunk 8, s 24), the single-scan fallback
(chunk 8, s 20), a continued sequence from ``h0``/``conv0``, and
``rglru_decode_step`` stepped over the sequence against the block.  All
within 1e-5 of the reference: the port's Hillis-Steele scan and the
reference's associative scan add the same terms in different orders.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import rglru as jrg  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import rglru as trg  # noqa: E402

ATOL = 1e-5
NOISY = ("conv_b", "b_a", "b_i")


def _params(seed=0):
    jcfg = jax_get_config("recurrentgemma-2b").reduced()
    tree = jax.tree.map(np.asarray,
                        jrg.init_rglru(jax.random.PRNGKey(5), jcfg))
    rng = np.random.default_rng(seed)
    for name in NOISY:
        tree[name] = (tree[name] + 0.1 * rng.standard_normal(
            tree[name].shape)).astype(tree[name].dtype)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}
    return jcfg, jp, tp


def _x(cfg, b, s, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=0)


def test_noise_reaches_the_zero_leaves():
    _, jp, _ = _params()
    for name in NOISY:
        assert float(jnp.abs(jp[name]).max()) > 0, name


@pytest.mark.parametrize("s,chunk", [(24, 8), (20, 8), (24, 1024), (1, 8)],
                         ids=["three-chunks", "fallback", "one-chunk",
                              "one-token"])
def test_rglru_block_matches_jax(s, chunk):
    cfg, jp, tp = _params()
    x = _x(cfg, 2, s)
    jy, (jh, jc) = jrg.rglru_block(jp, jnp.asarray(x), return_state=True,
                                   chunk=chunk)
    ty, (th, tc) = trg.rglru_block(tp, torch.from_numpy(x),
                                   return_state=True, chunk=chunk)
    _close(ty, jy)
    _close(th, jh)
    _close(tc, jc)
    assert th.dtype == torch.float32


@pytest.mark.parametrize("chunk", [8, 1024])
def test_rglru_block_continues_from_state(chunk):
    """A 16-token prefix, then 24 tokens from its (h, conv) state: the same
    as the reference's continuation, and as the 40 tokens in one call."""
    cfg, jp, tp = _params()
    x = _x(cfg, 2, 40, seed=2)
    _, (jh0, jc0) = jrg.rglru_block(jp, jnp.asarray(x[:, :16]),
                                    return_state=True, chunk=chunk)
    _, (th0, tc0) = trg.rglru_block(tp, torch.from_numpy(x[:, :16]),
                                    return_state=True, chunk=chunk)
    jy, (jh, jc) = jrg.rglru_block(jp, jnp.asarray(x[:, 16:]), h0=jh0,
                                   conv0=jc0, return_state=True, chunk=chunk)
    ty, (th, tc) = trg.rglru_block(tp, torch.from_numpy(x[:, 16:]), h0=th0,
                                   conv0=tc0, return_state=True, chunk=chunk)
    _close(ty, jy)
    _close(th, jh)
    _close(tc, jc)
    whole, (hw, _) = trg.rglru_block(tp, torch.from_numpy(x),
                                     return_state=True, chunk=chunk)
    np.testing.assert_allclose(ty.numpy(), whole[:, 16:].numpy(), atol=ATOL)
    np.testing.assert_allclose(th.numpy(), hw.numpy(), atol=ATOL)


def test_rglru_decode_steps_match_block_and_jax():
    cfg, jp, tp = _params()
    s = 24
    x = _x(cfg, 3, s, seed=3)
    ty_block, (th_block, tc_block) = trg.rglru_block(
        tp, torch.from_numpy(x), return_state=True, chunk=8)
    h, conv = trg.init_state(cfg, 3, device="cpu")
    jh, jc = jrg.init_state(cfg, 3)
    _close(h, jh)
    _close(conv, jc)
    assert (h.dtype, conv.dtype) == (torch.float32, torch.float32)
    for t in range(s):
        xt = x[:, t:t + 1]
        ty, h, conv = trg.rglru_decode_step(tp, torch.from_numpy(xt), h,
                                            conv)
        jy, jh, jc = jrg.rglru_decode_step(jp, jnp.asarray(xt), jh, jc)
        _close(ty, jy)
        _close(h, jh)
        np.testing.assert_allclose(ty.numpy(), ty_block[:, t:t + 1].numpy(),
                                   atol=ATOL)
    _close(conv, jc)
    np.testing.assert_allclose(h.numpy(), th_block.numpy(), atol=ATOL)
    np.testing.assert_allclose(conv.numpy(), tc_block.numpy(), atol=ATOL)


def test_init_rglru_matches_jax_shapes_and_lambda_range():
    jcfg = jax_get_config("recurrentgemma-2b").reduced()
    tcfg = get_config("recurrentgemma-2b").reduced()
    jp = jax.eval_shape(lambda k: jrg.init_rglru(k, jcfg),
                        jax.random.PRNGKey(0))
    tp = trg.init_rglru(torch.Generator().manual_seed(0), tcfg,
                        torch.float32, "cpu")
    assert ({k: (tuple(v.shape), str(v.dtype)) for k, v in jp.items()}
            == {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in tp.items()})
    # a = exp(-8 softplus(lam)) at a fully open gate is the uniform draw the
    # reference inverts, in (0.9^2, 0.999^2)
    a = torch.exp(-8.0 * torch.nn.functional.softplus(tp["lam"]))
    assert float(a.min()) > 0.9 ** 2 - 1e-6
    assert float(a.max()) < 0.999 ** 2 + 1e-6
