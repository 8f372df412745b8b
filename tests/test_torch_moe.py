"""The port's MoE FFN (``repro_torch/models/moe.py``) against the JAX
package's ``repro/models/moe.py``, on the CPU.

The reference's expert params (``init_moe`` at a key) are carried across
leaf by leaf; activations come from numpy at a seed.  Reduced mixtral
(4 experts, top-2, groups of 64, capacity 40) and reduced llama4 (4 experts,
top-1, one shared expert, capacity 20), each at a length of two groups:
mixtral's routing stays within capacity there, llama4's overflows it; one
case whose small group and capacity factor drop many; a decode-shaped call
(one token; the reference keeps the group size's capacity, the port clamps
it to the call's group).  Each case holds the expert choices equal, ``y``
within 1e-5 and the aux loss within 1e-6 relative.

Then the port against itself: ``moe_ffn`` clamps a call's capacity to
``min(C, S)`` for a group of S tokens, and must match the layout with the
configured C built from ``_route`` and ``_experts``: the same routed
(token, expert) pairs, ``y`` and the aux loss within 1e-6.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

ATOL_Y = 1e-5
RTOL_AUX = 1e-6


def _cfgs(arch, **moe_kw):
    jcfg = jax_get_config(arch).reduced()
    tcfg = get_config(arch).reduced()
    if moe_kw:
        jcfg = dataclasses.replace(jcfg,
                                   moe=dataclasses.replace(jcfg.moe, **moe_kw))
        tcfg = dataclasses.replace(tcfg,
                                   moe=dataclasses.replace(tcfg.moe, **moe_kw))
    return jcfg, tcfg


def _params(jcfg, seed=3):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jp, tp


def _x(cfg, b, s, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def _jax_choices(jp, x, jcfg):
    """The reference's routing, as ``moe_ffn`` computes it."""
    S = min(jcfg.moe.group_size, x.shape[1])
    xg = jnp.asarray(x).reshape(x.shape[0], -1, S, x.shape[2])
    logits = jnp.einsum("bgsd,de->bgse", xg, jp["router"],
                        preferred_element_type=jnp.float32)
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), jcfg.moe.top_k)
    return np.asarray(idx)


def _torch_choices(tp, x, tcfg):
    S = min(tcfg.moe.group_size, x.shape[1])
    xg = torch.from_numpy(x).reshape(x.shape[0], -1, S, x.shape[2])
    probs = torch.softmax(torch.matmul(xg, tp["router"]), dim=-1)
    return torch.topk(probs, tcfg.moe.top_k, dim=-1)[1].numpy()


def _dispatched(idx, cfg):
    """Tokens each expert receives per group, before capacity."""
    E = cfg.moe.num_experts
    return np.stack([(idx == e).sum(axis=(2, 3)) for e in range(E)], -1)


def _check(jcfg, tcfg, b, s, seed=0):
    jp, tp = _params(jcfg)
    x = _x(tcfg, b, s, seed)
    ji = _jax_choices(jp, x, jcfg)
    np.testing.assert_array_equal(_torch_choices(tp, x, tcfg), ji)
    jy, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    ty, taux = tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL_Y,
                               rtol=0)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=RTOL_AUX)
    return ji


@pytest.mark.parametrize("arch,drops", [("mixtral-8x22b", False),
                                        ("llama4-maverick-400b-a17b", True)])
def test_moe_ffn_matches_jax(arch, drops):
    jcfg, tcfg = _cfgs(arch)
    C = tmoe.capacity(tcfg.moe)
    assert C == jmoe.capacity(jcfg.moe)
    idx = _check(jcfg, tcfg, b=2, s=2 * tcfg.moe.group_size)
    # whether some expert overflows its capacity in some group
    assert (_dispatched(idx, tcfg).max() > C) == drops


def test_moe_ffn_small_capacity_drops_tokens():
    jcfg, tcfg = _cfgs("mixtral-8x22b", group_size=16, capacity_factor=0.5)
    C = tmoe.capacity(tcfg.moe)
    assert C == 4
    idx = _check(jcfg, tcfg, b=3, s=48, seed=1)
    assert _dispatched(idx, tcfg).max() >= 2 * C


@pytest.mark.parametrize("arch", ["mixtral-8x22b",
                                  "llama4-maverick-400b-a17b"])
def test_moe_ffn_decode_shape_matches_jax(arch):
    """One token a row: the group is that token.  The reference runs it
    over ``group_size``'s capacity, the port over one capacity row an
    expert (an expert takes at most one row a token); the outputs agree."""
    jcfg, tcfg = _cfgs(arch)
    _check(jcfg, tcfg, b=5, s=1, seed=2)


def test_moe_ffn_refuses_a_ragged_group():
    _, tcfg = _cfgs("mixtral-8x22b")
    _, tp = _params(_cfgs("mixtral-8x22b")[0])
    x = torch.zeros((1, tcfg.moe.group_size + 1, tcfg.d_model))
    with pytest.raises(ValueError, match="group"):
        tmoe.moe_ffn(tp, x, tcfg)


@pytest.mark.parametrize("arch", ["mixtral-8x22b",
                                  "llama4-maverick-400b-a17b"])
def test_init_moe_shapes_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jp = jax.eval_shape(lambda k: jmoe.init_moe(k, jcfg),
                        jax.random.PRNGKey(0))
    tp = tmoe.init_moe(None, tcfg, torch.float32, "meta")
    assert (jax.tree.map(lambda a: tuple(a.shape), jp)
            == jax.tree.map(lambda a: tuple(a.shape), tp))
    assert tp["router"].dtype == torch.float32


# (arch, MoE fields replaced, b, s): decode, a short chunk and full groups at
# mixtral's 1.25 and 4.0; llama4 (top-1, a shared expert) and its 4-row
# floor (C = 4 from groups of 8, above a chunk of 2); the dropping case above
EXACT_CASES = {
    "mixtral-decode": ("mixtral-8x22b", {}, 5, 1),
    "mixtral-chunk": ("mixtral-8x22b", {}, 2, 20),
    "mixtral-groups": ("mixtral-8x22b", {}, 2, 128),
    "mixtral-4.0-decode": ("mixtral-8x22b", {"capacity_factor": 4.0}, 5, 1),
    "mixtral-4.0-chunk": ("mixtral-8x22b", {"capacity_factor": 4.0}, 2, 20),
    "mixtral-4.0-groups": ("mixtral-8x22b", {"capacity_factor": 4.0}, 2, 128),
    "llama4-decode": ("llama4-maverick-400b-a17b", {}, 5, 1),
    "llama4-chunk": ("llama4-maverick-400b-a17b", {}, 2, 20),
    "llama4-groups": ("llama4-maverick-400b-a17b", {}, 2, 128),
    "llama4-floor-chunk": ("llama4-maverick-400b-a17b", {"group_size": 8},
                           3, 2),
    "llama4-floor-groups": ("llama4-maverick-400b-a17b", {"group_size": 8},
                            3, 16),
    "drops-groups": ("mixtral-8x22b",
                     {"group_size": 16, "capacity_factor": 0.5}, 3, 48),
    "drops-chunk": ("mixtral-8x22b",
                    {"group_size": 16, "capacity_factor": 0.5}, 3, 2),
}


@pytest.mark.parametrize("case", list(EXACT_CASES))
def test_moe_ffn_clamped_capacity_matches_the_configured_layout(
        case, monkeypatch):
    arch, moe_kw, b, s = EXACT_CASES[case]
    jcfg, tcfg = _cfgs(arch, **moe_kw)
    moe = tcfg.moe
    _, tp = _params(jcfg)
    x = torch.from_numpy(_x(tcfg, b, s, seed=4))
    S = min(moe.group_size, s)
    C = tmoe.capacity(moe)

    calls = []
    route = tmoe._route

    def recorded(xg, router, moe_, C_):
        out = route(xg, router, moe_, C_)
        calls.append(out[0])
        return out

    monkeypatch.setattr(tmoe, "_route", recorded)
    y, aux = tmoe.moe_ffn(tp, x, tcfg)
    (combine,) = calls
    assert combine.shape[-1] == min(C, S)

    # the configured layout: E x C capacity rows a group
    xg = x.reshape(b, s // S, S, tcfg.d_model)
    full, probs, first = route(xg, tp["router"], moe, C)
    y_full = tmoe._experts(xg, (full > 0).to(x.dtype), full, tp["we_gate"],
                           tp["we_up"], tp["we_down"]).reshape(x.shape)
    if "shared" in tp:
        y_full = y_full + tmoe.L.mlp(tp["shared"], x)
    aux_full = moe.num_experts * torch.sum(torch.mean(first, dim=(0, 1, 2))
                                           * torch.mean(probs, dim=(0, 1, 2)))

    assert torch.equal((combine > 0).any(-1), (full > 0).any(-1))
    torch.testing.assert_close(y, y_full, atol=1e-6, rtol=0)
    torch.testing.assert_close(aux, aux_full, atol=1e-6, rtol=0)
