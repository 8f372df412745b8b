"""The port's paper CNN (``models/cnn.py``) against the reference, on the CPU.

* Params cross over from the reference's ``init_cnn`` through
  ``convert.cnn_params_from_jax``, which checks every leaf against
  ``init_cnn(None, cfg, device="meta")`` and refuses a wrong key, shape
  or list length.
* At a reduced config (2 stages, base 8, d_ff 16) on NHWC images made
  with numpy from a seed: logits against ``jax.jit(cnn_forward)``, the
  loss against ``cnn_loss`` and every gradient leaf against
  ``jax.grad(cnn_loss)``, each within 1e-5 of the reference's largest
  magnitude (both sum f32 products in different orders).
* ``init_cnn``'s meta shapes equal the reference's at full paper-cnn width
  (about 1.03 M params) and at the reduced one, and a flat vector of the
  port's params (``tree.ravel``) is ``ravel_pytree``'s.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.flatten_util import ravel_pytree

from repro.configs import get_config as jax_get_config
from repro.models import cnn as jcnn
from repro_torch.configs import get_config
from repro_torch.convert import cnn_params_from_jax
from repro_torch.models import cnn_forward, cnn_loss, init_cnn
from repro_torch.tree import leaves, ravel, tree_map

TOL = 1e-5
SMALL = dict(num_layers=2, d_model=8, d_ff=16)


def _cfgs(**kw):
    return (dataclasses.replace(jax_get_config("paper-cnn"), **kw),
            dataclasses.replace(get_config("paper-cnn"), **kw))


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _close(port, ref, what):
    ref = np.asarray(ref)
    err = float(np.max(np.abs(np.asarray(port) - ref)))
    scale = max(float(np.max(np.abs(ref))), 1.0)
    assert err <= TOL * scale, (what, err, scale)


def _pair(seed, **kw):
    jcfg, tcfg = _cfgs(**kw)
    jp = jcnn.init_cnn(jax.random.PRNGKey(seed), jcfg)
    tp = cnn_params_from_jax(_numpy(jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def _batch(seed, b, classes=10):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, classes, b).astype(np.int32)
    return x, y


@pytest.mark.parametrize("seed,b", [(0, 6), (1, 3), (2, 16)])
def test_forward_and_loss_match_reference(seed, b):
    jcfg, tcfg, jp, tp = _pair(seed, **SMALL)
    x, y = _batch(seed + 10, b)
    logits = cnn_forward(tp, torch.from_numpy(x), tcfg)
    ref = jax.jit(lambda p, im: jcnn.cnn_forward(p, im, jcfg))(
        jp, jnp.asarray(x))
    assert logits.shape == (b, 10) and logits.dtype == torch.float32
    _close(logits.numpy(), ref, "logits")
    loss = cnn_loss(tp, torch.from_numpy(x), torch.from_numpy(y), tcfg)
    jloss = jcnn.cnn_loss(jp, jnp.asarray(x), jnp.asarray(y), jcfg)
    _close(float(loss), float(jloss), "loss")


@pytest.mark.parametrize("seed", [0, 3])
def test_gradients_match_reference(seed):
    jcfg, tcfg, jp, tp = _pair(seed, **SMALL)
    x, y = _batch(seed + 20, 8)
    live = tree_map(lambda t: t.clone().requires_grad_(True), tp)
    loss = cnn_loss(live, torch.from_numpy(x), torch.from_numpy(y), tcfg)
    grads = torch.autograd.grad(loss, leaves(live))
    jg = jax.grad(jcnn.cnn_loss)(jp, jnp.asarray(x), jnp.asarray(y), jcfg)
    jleaves = jax.tree.leaves(jg)
    assert len(grads) == len(jleaves) == 3 * 2 + 2
    for i, (g, r) in enumerate(zip(grads, jleaves)):
        assert g.shape == r.shape
        _close(g.numpy(), r, f"grad leaf {i}")


def test_convolution_backward_is_autograd_s():
    """The f32 convolution's hand-written backward gives what autograd
    gives for ``F.conv2d`` (the CPU has no TF32 to turn off)."""
    _, tcfg, _, tp = _pair(5, **SMALL)
    x, y = _batch(6, 4)

    def plain(p, im):
        h = im.permute(0, 3, 1, 2)
        for c in p["conv"]:
            h = F.max_pool2d(torch.relu(F.conv2d(
                h, c["w"].permute(3, 2, 0, 1), c["b"], padding=1)), 2)
        h = torch.relu(h.mean(dim=(2, 3)) @ p["fc1"]["w"] + p["fc1"]["b"])
        return h @ p["fc2"]["w"] + p["fc2"]["b"]

    outs = []
    for fwd in (lambda p, im: cnn_forward(p, im, tcfg), plain):
        live = tree_map(lambda t: t.clone().requires_grad_(True), tp)
        im = torch.from_numpy(x).requires_grad_(True)
        logits = fwd(live, im)
        loss = F.cross_entropy(logits, torch.from_numpy(y).long())
        outs.append((logits.detach(), torch.autograd.grad(
            loss, leaves(live) + [im])))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=1e-6)
    for a, b in zip(outs[0][1], outs[1][1]):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-6 * max(float(b.abs().max()), 1))


@pytest.mark.parametrize("kw", [SMALL, {}], ids=["reduced", "paper-cnn"])
def test_meta_shapes_equal_reference(kw):
    jcfg, tcfg = _cfgs(**kw)
    ref = jax.eval_shape(lambda k: jcnn.init_cnn(k, jcfg),
                         jax.random.PRNGKey(0))
    meta = init_cnn(None, tcfg, device="meta")
    assert [tuple(t.shape) for t in leaves(meta)] == \
        [tuple(s.shape) for s in jax.tree.leaves(ref)]
    assert all(t.device.type == "meta" for t in leaves(meta))
    n = sum(t.numel() for t in leaves(meta))
    if not kw:
        # widths 3 -> 64 -> 128 -> 256 -> 256, fc 256 -> 256 -> 10
        assert n == 1_029_258
    assert len(meta["conv"]) == tcfg.num_layers


def test_flat_vector_keeps_jax_leaf_order():
    _, _, jp, tp = _pair(7, **SMALL)
    flat, unravel = ravel(tp)
    jflat, _ = ravel_pytree(jp)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    back = unravel(flat)
    assert isinstance(back["conv"], list) and len(back["conv"]) == 2
    torch.testing.assert_close(back["conv"][1]["w"], tp["conv"][1]["w"],
                               rtol=0, atol=0)


def test_conversion_checks_every_leaf():
    jcfg, tcfg = _cfgs(**SMALL)
    good = _numpy(jcnn.init_cnn(jax.random.PRNGKey(0), jcfg))
    out = cnn_params_from_jax(good, tcfg, device="cpu")
    out["conv"][0]["w"] += 1            # a private copy
    assert float(good["conv"][0]["w"][0, 0, 0, 0]) != float(
        out["conv"][0]["w"][0, 0, 0, 0])
    bad_shape = _numpy(jcnn.init_cnn(jax.random.PRNGKey(0), jcfg))
    bad_shape["fc1"]["w"] = bad_shape["fc1"]["w"][:, :-1]
    with pytest.raises(ValueError, match=r"fc1\.w: shape"):
        cnn_params_from_jax(bad_shape, tcfg, device="cpu")
    bad_key = _numpy(jcnn.init_cnn(jax.random.PRNGKey(0), jcfg))
    bad_key["conv"][1]["bias"] = bad_key["conv"][1].pop("b")
    with pytest.raises(ValueError, match=r"conv\[1\]: keys"):
        cnn_params_from_jax(bad_key, tcfg, device="cpu")
    short = _numpy(jcnn.init_cnn(jax.random.PRNGKey(0), jcfg))
    short["conv"] = short["conv"][:1]
    with pytest.raises(ValueError, match="conv: expected a list of 2"):
        cnn_params_from_jax(short, tcfg, device="cpu")
    extra = _numpy(jcnn.init_cnn(jax.random.PRNGKey(0), jcfg))
    extra["fc3"] = extra["fc2"]
    with pytest.raises(ValueError, match="params: keys"):
        cnn_params_from_jax(extra, tcfg, device="cpu")
    wrong_cfg = _cfgs(num_layers=3, d_model=8, d_ff=16)[1]
    with pytest.raises(ValueError):
        cnn_params_from_jax(good, wrong_cfg, device="cpu")


def test_init_cnn_is_seeded_and_he_scaled():
    _, tcfg = _cfgs()
    a = init_cnn(torch.Generator().manual_seed(3), tcfg, device="cpu")
    b = init_cnn(torch.Generator().manual_seed(3), tcfg, device="cpu")
    for x, y in zip(leaves(a), leaves(b)):
        assert torch.equal(x, y)
    # conv w ~ N(0, 2 / (9 Cin)); biases zero, as the reference
    for i, cin in enumerate((3, 64, 128, 256)):
        std = float(a["conv"][i]["w"].std())
        assert std == pytest.approx((2.0 / (9 * cin)) ** 0.5, rel=0.1)
        assert not a["conv"][i]["b"].any()
    assert float(a["fc2"]["w"].std()) == pytest.approx(256 ** -0.5, rel=0.1)
