"""The benchmark's weights: made on the device from the seed, in a few calls.

A configuration file (``bench/configs/<name>.json``, Hugging Face keys)
gives the shapes.  :func:`layout` lists every leaf in the nested-dict layout
that the program under test and the plain reference both read (the
layers of a uniform decoder stacked on axis 0), with the scale of its
random init.  :func:`make` draws every leaf from one normal fill of a flat
buffer by a generator on the device, then scales each leaf's view in
place: the same seed on the same device gives the same bits, so the
reference can make its own copy after the program's state is freed.

Norm weights are stored as an offset from 1 (the layer multiplies by
``1 + scale``), as the program stores them; the reference reads them so.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

# the scale of the norms' random offsets and of the biases
NORM_SCALE = 0.1
BIAS_SCALE = 0.02
EMBED_SCALE = 0.02


def dims(cfg: dict) -> Dict[str, int]:
    """The sizes that shape a uniform decoder, from a configuration file."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    return {"d": d, "h": h, "kv": cfg["num_key_value_heads"],
            "hd": cfg.get("head_dim") or d // h,
            "ff": cfg["intermediate_size"], "L": cfg["num_hidden_layers"],
            "V": cfg["vocab_size"], "E": cfg.get("num_local_experts", 0),
            "top_k": cfg.get("num_experts_per_tok", 0)}


def layout(cfg: dict) -> List[Tuple[Tuple[str, ...], Tuple[int, ...], float]]:
    """(path, shape, init scale) of every leaf, in a fixed order.  Weights
    are (d_in, d_out) and scaled by d_in ** -0.5."""
    z = dims(cfg)
    d, h, kv, hd, ff, L, V, E = (z[k] for k in
                                 ("d", "h", "kv", "hd", "ff", "L", "V", "E"))
    unit = ("unit", "p0")
    out = [(("embed",), (V, d), EMBED_SCALE),
           (("final_norm", "scale"), (d,), NORM_SCALE)]
    if not cfg["tie_word_embeddings"]:
        out.append((("lm_head",), (d, V), d ** -0.5))
    out += [(unit + ("norm1", "scale"), (L, d), NORM_SCALE),
            (unit + ("attn", "wq"), (L, d, h * hd), d ** -0.5),
            (unit + ("attn", "wk"), (L, d, kv * hd), d ** -0.5),
            (unit + ("attn", "wv"), (L, d, kv * hd), d ** -0.5),
            (unit + ("attn", "wo"), (L, h * hd, d), (h * hd) ** -0.5),
            (unit + ("norm2", "scale"), (L, d), NORM_SCALE)]
    if cfg.get("attention_bias"):
        out += [(unit + ("attn", "bq"), (L, h * hd), BIAS_SCALE),
                (unit + ("attn", "bk"), (L, kv * hd), BIAS_SCALE),
                (unit + ("attn", "bv"), (L, kv * hd), BIAS_SCALE)]
    if E:
        out += [(unit + ("moe", "router"), (L, d, E), d ** -0.5),
                (unit + ("moe", "we_gate"), (L, E, d, ff), d ** -0.5),
                (unit + ("moe", "we_up"), (L, E, d, ff), d ** -0.5),
                (unit + ("moe", "we_down"), (L, E, ff, d), ff ** -0.5)]
    else:
        out += [(unit + ("mlp", "w_gate"), (L, d, ff), d ** -0.5),
                (unit + ("mlp", "w_up"), (L, d, ff), d ** -0.5),
                (unit + ("mlp", "w_down"), (L, ff, d), ff ** -0.5)]
    return out


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for stream ``stream`` of the run seed ``seed`` (any
    whole number: negative and large ones included)."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), stream])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


WEIGHTS_STREAM = 1


def make(cfg: dict, seed: int, device) -> Dict:
    """The weights as a nested dict of views of one flat f32 buffer, made
    on ``device``: one normal fill and one in-place scale per leaf."""
    leaves = layout(cfg)
    total = sum(int(np.prod(shape)) for _, shape, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(
        sub_seed(seed, WEIGHTS_STREAM))
    flat = torch.empty((total,), dtype=torch.float32, device=device)
    flat.normal_(generator=gen)
    tree: Dict = {"rest": {}}
    at = 0
    for path, shape, scale in leaves:
        n = int(np.prod(shape))
        view = flat[at:at + n].view(shape)
        view.mul_(scale)
        at += n
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = view
    return tree


def flat_leaves(tree, prefix=()) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    """(path, tensor) of every leaf, keys sorted."""
    out = []
    for key in sorted(tree):
        v = tree[key]
        if isinstance(v, dict):
            out += flat_leaves(v, prefix + (key,))
        else:
            out.append((prefix + (key,), v))
    return out


def check_against(tree, template) -> None:
    """Raise unless ``template`` (the program's own tree of shapes, e.g. on
    the meta device) has the same leaves with the same shapes."""
    mine = {p: tuple(t.shape) for p, t in flat_leaves(tree)}
    theirs = {p: tuple(t.shape) for p, t in flat_leaves(template)}
    if mine != theirs:
        only = sorted(set(mine.items()) ^ set(theirs.items()))
        raise ValueError(f"the program's parameter tree differs from the "
                         f"benchmark's layout: {only[:6]}")
