"""Config system: architecture + input-shape + run configs.

Every assigned architecture gets one module in this package exporting
``CONFIG`` (a :class:`ModelConfig`).  ``repro_torch.configs.registry`` collects them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# Layer kinds used in ``layer_pattern``.
ATTN_FULL = "attn_full"          # global causal attention
ATTN_SWA = "attn_swa"            # sliding-window causal attention
ATTN_LOCAL = "attn_local"        # local (windowed) attention, RecurrentGemma style
RECURRENT = "recurrent"          # RG-LRU block
SLSTM = "slstm"                  # xLSTM sLSTM block (sequential scan)
MLSTM = "mlstm"                  # xLSTM mLSTM block (matrix memory)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    num_shared_experts: int = 0
    # tokens are dispatched in groups of this size (GShard-style grouping keeps
    # the one-hot dispatch tensor small; see models/moe.py)
    group_size: int = 1024
    # MoE every Nth layer (Llama-4 interleaves MoE with dense layers)
    layer_step: int = 1
    # d_ff of the dense (non-MoE) layers when layer_step > 1
    dense_d_ff: int = 0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm | cnn
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // num_heads
    # attention layout --------------------------------------------------
    layer_pattern: Optional[Tuple[str, ...]] = None  # len == num_layers; None => all ATTN_FULL
    window_size: int = 4096          # for ATTN_SWA / ATTN_LOCAL layers
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    use_mrope: bool = False          # Qwen2-VL multimodal RoPE (t/h/w sections)
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # head_dim/2 split
    logit_softcap: Optional[float] = None
    # MoE ---------------------------------------------------------------
    moe: Optional[MoEConfig] = None
    # encoder-decoder (audio) --------------------------------------------
    encoder_layers: int = 0          # >0 => enc-dec; decoder uses num_layers
    encoder_seq_len: int = 0         # e.g. whisper audio frames (stub frontend)
    # frontends that are stubbed per the brief ---------------------------
    frontend_stub: Optional[str] = None   # "audio_conv" | "vision_patches" | None
    num_patch_tokens: int = 0        # VLM: patch embeddings prepended to text
    # misc ---------------------------------------------------------------
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    citation: str = ""
    # recurrent block width (RG-LRU); defaults to d_model
    lru_dim: Optional[int] = None
    # dense archs are full-attention; this flag enables the sliding-window
    # VARIANT used only to make long_500k decode sub-quadratic (DESIGN.md §4)
    long_context_variant_window: int = 8192

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def padded_vocab_size(self) -> int:
        """Vocab padded to a multiple of 128 so it shards over any mesh axis."""
        return _round_up(self.vocab_size, 128)

    @property
    def pattern(self) -> Tuple[str, ...]:
        if self.layer_pattern is not None:
            assert len(self.layer_pattern) == self.num_layers, self.name
            return self.layer_pattern
        return tuple([ATTN_FULL] * self.num_layers)

    def pattern_for_long_context(self) -> Tuple[str, ...]:
        """Sub-quadratic pattern used by the ``long_500k`` decode shape.

        Full-attention layers become sliding-window layers (window
        ``long_context_variant_window``); recurrent/local layers unchanged.
        """
        return tuple(ATTN_SWA if k == ATTN_FULL else k for k in self.pattern)

    # Parameter count (embedding included once; tied embeddings counted once).
    def param_count(self, active_only: bool = False) -> int:
        d, h, kv, hd = self.d_model, self.num_heads, self.num_kv_heads, self.resolved_head_dim
        n_attn = d * h * hd + 2 * d * kv * hd + h * hd * d  # q,k,v,o
        if self.qkv_bias:
            n_attn += (h + 2 * kv) * hd
        n_ffn = 3 * d * self.d_ff  # gated MLP (gate, up, down)
        total = 0
        for li, kind in enumerate(self.pattern):
            if kind in (SLSTM, MLSTM):
                # xLSTM block: qkv + gates + up/down proj (~4 d^2 equivalent)
                total += 4 * d * d + 8 * d
                continue
            if kind == RECURRENT:
                lru = self.lru_dim or d
                total += 2 * d * lru + lru * d + 2 * lru  # in-proj x2, out-proj, gates
            else:
                total += n_attn
            is_moe_layer = (self.moe is not None and kind != RECURRENT
                            and (li % self.moe.layer_step == self.moe.layer_step - 1))
            if is_moe_layer:
                e = self.moe.top_k + self.moe.num_shared_experts if active_only \
                    else self.moe.num_experts + self.moe.num_shared_experts
                total += e * n_ffn + d * self.moe.num_experts  # experts + router
            elif self.moe is not None and self.moe.dense_d_ff and kind != RECURRENT:
                total += 3 * d * self.moe.dense_d_ff
            elif self.d_ff > 0:
                total += n_ffn
            total += 2 * d  # norms
        total += self.padded_vocab_size * d  # embedding
        if not self.tie_embeddings:
            total += self.padded_vocab_size * d  # lm head
        if self.encoder_layers:
            total += self.encoder_layers * (n_attn + n_ffn + 2 * d)
            total += self.num_layers * (n_attn + 2 * d)  # decoder cross-attn
        return int(total)

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: <=2 layers, d_model<=512, <=4 experts."""
        d = min(self.d_model, 256)
        heads = min(self.num_heads, 4)
        kv = min(self.num_kv_heads, heads)
        # keep the *family* structure: take the first layers of the pattern but
        # make sure every distinct block kind in the arch appears
        kinds = list(dict.fromkeys(self.pattern))[:2]
        if len(kinds) == 1:
            kinds = kinds * 2
        moe = None
        if self.moe:
            moe = dataclasses.replace(
                self.moe, num_experts=min(4, self.moe.num_experts),
                top_k=min(self.moe.top_k, 2), group_size=64,
                dense_d_ff=min(self.moe.dense_d_ff, 512))
        return dataclasses.replace(
            self, name=self.name + "-reduced", num_layers=2,
            layer_pattern=tuple(kinds), d_model=d, num_heads=heads,
            num_kv_heads=kv, head_dim=64 if self.head_dim else None,
            d_ff=min(self.d_ff, 512), vocab_size=min(self.vocab_size, 1024),
            moe=moe, encoder_layers=min(self.encoder_layers, 2),
            encoder_seq_len=min(self.encoder_seq_len, 64),
            num_patch_tokens=min(self.num_patch_tokens, 16),
            lru_dim=min(self.lru_dim, 256) if self.lru_dim else None,
            window_size=min(self.window_size, 64),
            long_context_variant_window=64,
            mrope_sections=(16, 8, 8),
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
