"""Mixtral-8x22B [arXiv:2401.04088] — sparse MoE (8 experts, top-2), GQA, SWA."""
from repro_torch.configs.base import ATTN_SWA, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32_768,
    layer_pattern=tuple(["attn_swa"] * 56),
    window_size=4096,
    moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=1.25),
    rope_theta=1_000_000.0,
    citation="arXiv:2401.04088",
)
