"""The plain reference: a decoder-only transformer in plain PyTorch, f32.

It follows the published architectures of the benchmark's configurations,
read from a configuration file's Hugging Face keys: Qwen2 (grouped-query
attention with a q/k/v bias, a gated SiLU MLP, tied embeddings) and Mixtral
(the same attention without a bias, a sparse MoE FFN whose router takes
the top-k of a softmax over the experts and renormalises their gates, and
routes every token: no capacity, nothing dropped).  RMSNorm, rotary
embeddings on the two halves of each head, causal attention (windowed
where the configuration gives a ``sliding_window``).

It imports nothing of the program under test and takes nothing it made:
the weights are the benchmark's own (``bench/weights.py``), as a nested
dict; norm weights are stored as an offset from 1.

``precision="tf32"`` rounds both operands of every product to TF32 (10
mantissa bits, round to nearest even) and accumulates in f32, as a TF32
tensor core does, in the forward and the backward: the control that
``correct`` has to reject.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

PRECISIONS = ("f32", "tf32")


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x (f32) rounded to TF32: the low 13 mantissa bits cleared, rounding
    to nearest, ties to even."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & -8192
    return bits.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(tf32_round(a), tf32_round(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        ga = torch.matmul(g, tf32_round(b).transpose(-1, -2))
        gb = torch.matmul(tf32_round(a).transpose(-1, -2), g)
        # undo broadcasting over leading dims
        while ga.ndim > a.ndim:
            ga = ga.sum(0)
        while gb.ndim > b.ndim:
            gb = gb.sum(0)
        return ga, gb


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Decoder:
    """The reference model over ``weights`` (leaves stacked over layers)."""

    def __init__(self, cfg: dict, weights: Dict, precision: str = "f32",
                 flip_below=None):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        _no_tf32()
        self.cfg, self.w, self.precision = cfg, weights, precision
        self.flip_below = flip_below
        d, h = cfg["hidden_size"], cfg["num_attention_heads"]
        self.d, self.h = d, h
        self.kv = cfg["num_key_value_heads"]
        self.hd = cfg.get("head_dim") or d // h
        self.L = cfg["num_hidden_layers"]
        self.eps = cfg["rms_norm_eps"]
        self.theta = float(cfg["rope_theta"])
        self.window = cfg.get("sliding_window") if cfg.get(
            "use_sliding_window", True) else None
        self.E = cfg.get("num_local_experts", 0)
        self.top_k = cfg.get("num_experts_per_tok", 0)
        # per MoE layer of the last forward: each row's router logits, the
        # experts it chose, and the margin of its choice (its k-th router
        # logit over the next)
        self.router_logits, self.routes, self.margins = [], [], []

    # -- products ---------------------------------------------------------
    def mm(self, a, b):
        if self.precision == "tf32":
            return _TF32MatMul.apply(a, b)
        return torch.matmul(a, b)

    # -- layers -----------------------------------------------------------
    def norm(self, x, offset):
        var = torch.mean(x * x, dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.eps) * (1.0 + offset)

    def rope(self, x, pos):
        """x (b, s, n, hd) rotated at positions pos (s,): the two halves of
        each head as (real, imaginary) parts."""
        half = self.hd // 2
        inv = self.theta ** (-torch.arange(half, dtype=torch.float32,
                                           device=x.device) / half)
        ang = pos.float()[:, None] * inv[None]
        cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def attention(self, a, x, li, pos):
        b, s, _ = x.shape
        h, kv, hd = self.h, self.kv, self.hd
        q = self.mm(x, a["wq"][li])
        k = self.mm(x, a["wk"][li])
        v = self.mm(x, a["wv"][li])
        if "bq" in a:
            q, k, v = q + a["bq"][li], k + a["bk"][li], v + a["bv"][li]
        q = self.rope(q.reshape(b, s, h, hd), pos)
        k = self.rope(k.reshape(b, s, kv, hd), pos)
        v = v.reshape(b, s, kv, hd)
        # query head i reads key/value head i // (h / kv)
        k = k.repeat_interleave(h // kv, dim=2).transpose(1, 2)
        v = v.repeat_interleave(h // kv, dim=2).transpose(1, 2)
        q = q.transpose(1, 2)                                   # (b, h, s, hd)
        scores = self.mm(q, k.transpose(-1, -2)) * hd ** -0.5
        allowed = pos[None, :] <= pos[:, None]
        if self.window:
            allowed &= pos[None, :] > pos[:, None] - self.window
        scores = scores.masked_fill(~allowed, float("-inf"))
        o = self.mm(torch.softmax(scores, dim=-1), v)           # (b, h, s, hd)
        o = o.transpose(1, 2).reshape(b, s, h * hd)
        return self.mm(o, a["wo"][li])

    def mlp(self, m, x, li):
        g = self.mm(x, m["w_gate"][li])
        u = self.mm(x, m["w_up"][li])
        return self.mm(F.silu(g) * u, m["w_down"][li])

    def moe(self, m, x, li):
        """Every token to its top-k experts, gates renormalised over them.
        With ``flip_below`` a row whose k-th router logit lies less than
        that above the next takes the next expert in place of the k-th:
        the routing that rounding may give it."""
        b, s, d = x.shape
        rows = x.reshape(b * s, d)
        logits = self.mm(rows, m["router"][li])
        ranked, order = torch.topk(logits, self.top_k + 1, dim=-1)
        margin = ranked[:, -2] - ranked[:, -1]
        idx = order[:, :-1].clone()
        if self.flip_below is not None:
            near = margin < self.flip_below
            idx[near, -1] = order[near, -1]
        self.router_logits.append(logits)
        self.margins.append(margin)
        gate = torch.softmax(logits, dim=-1).gather(-1, idx)
        gate = gate / gate.sum(dim=-1, keepdim=True)
        out = torch.zeros_like(rows)
        for e in range(self.E):
            tok, slot = torch.nonzero(idx == e, as_tuple=True)
            if tok.numel() == 0:
                continue
            xe = rows[tok]
            he = F.silu(self.mm(xe, m["we_gate"][li, e])) * self.mm(
                xe, m["we_up"][li, e])
            ye = self.mm(he, m["we_down"][li, e])
            out = out.index_add(0, tok, ye * gate[tok, slot][:, None])
        self.routes.append(idx)
        return out.reshape(b, s, d)

    # -- model ------------------------------------------------------------
    def hidden(self, tokens):
        """tokens (b, s) -> hidden states (b, s, d) after the final norm."""
        w = self.w
        unit = w["unit"]["p0"]
        x = w["embed"][tokens]
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        self.router_logits, self.routes, self.margins = [], [], []
        for li in range(self.L):
            x = x + self.attention(unit["attn"],
                                   self.norm(x, unit["norm1"]["scale"][li]),
                                   li, pos)
            hx = self.norm(x, unit["norm2"]["scale"][li])
            x = x + (self.moe(unit["moe"], hx, li) if self.E
                     else self.mlp(unit["mlp"], hx, li))
        return self.norm(x, w["final_norm"]["scale"])

    def head(self):
        w = self.w
        return (w["embed"].transpose(0, 1) if self.cfg["tie_word_embeddings"]
                else w["lm_head"])

    def logits(self, tokens):
        """tokens (b, s) -> logits (b, s, V) f32."""
        return self.mm(self.hidden(tokens), self.head())

    def loss(self, tokens, labels):
        """Mean cross-entropy of next-token prediction over every token."""
        logits = self.logits(tokens)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1))
