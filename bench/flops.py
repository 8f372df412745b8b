"""Model flops from a configuration's shapes: what the model needs, counted
as 2 operations per multiply-add of its products, without recomputation
(the program's activation checkpointing is its own cost, not the model's).

A token's pass through one layer multiplies by the q, k, v and o
projections and by its FFN's weights (the top-k experts' and the router
for an MoE layer), and attends over its context: 4 h hd operations per key
(QK and PV), over the unmasked keys only.  The head is d V per position
whose logits are taken.  A training step is three forward passes: the
forward and the two products of each backward.
"""
from __future__ import annotations

from bench.weights import dims


def layer_weights(cfg: dict) -> int:
    """Weights one token multiplies by in one layer."""
    z = dims(cfg)
    d, h, kv, hd, ff = z["d"], z["h"], z["kv"], z["hd"], z["ff"]
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    if z["E"]:
        return attn + z["top_k"] * 3 * d * ff + d * z["E"]
    return attn + 3 * d * ff


def context(cfg: dict, pos: int) -> int:
    """Keys a query at 0-based position ``pos`` attends to (causal, within
    the window if the configuration has one)."""
    window = (cfg.get("sliding_window") if cfg.get("use_sliding_window", True)
              else None)
    return min(pos + 1, window) if window else pos + 1


def attention(cfg: dict, n_keys: int) -> int:
    z = dims(cfg)
    return 4 * z["h"] * z["hd"] * n_keys


def head(cfg: dict) -> int:
    z = dims(cfg)
    return 2 * z["d"] * z["V"]


def forward(cfg: dict, seq: int, rows: int = 1, logits: int = None) -> int:
    """One forward pass over ``rows`` sequences of ``seq`` tokens, logits at
    ``logits`` positions of each (every position if None)."""
    z = dims(cfg)
    keys = sum(context(cfg, i) for i in range(seq))
    per_row = z["L"] * (2 * layer_weights(cfg) * seq + attention(cfg, keys))
    per_row += head(cfg) * (seq if logits is None else logits)
    return rows * per_row


def train_step(cfg: dict, batch: int, seq: int) -> int:
    return 3 * forward(cfg, seq, batch)


def prefill(cfg: dict, prompt: int) -> int:
    """A prompt's prefill, logits at its last position."""
    return forward(cfg, prompt, 1, logits=1)


def decode_token(cfg: dict, kv_len: int) -> int:
    """One decoded token that attends to ``kv_len`` cached keys (its own
    included)."""
    z = dims(cfg)
    return z["L"] * (2 * layer_weights(cfg) + attention(cfg, kv_len)) \
        + head(cfg)
