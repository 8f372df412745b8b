"""Qwen2-VL-2B [arXiv:2409.12191] — VLM; M-RoPE; vision tower STUBBED.

``input_specs`` supplies precomputed patch embeddings (dynamic-resolution ViT
output) that are prepended to the text tokens; positions are 3-component
(temporal, height, width) M-RoPE ids split over head_dim sections.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151_936,
    qkv_bias=True,
    tie_embeddings=True,
    use_mrope=True,
    mrope_sections=(16, 24, 24),   # head_dim/2 = 64 = 16+24+24
    frontend_stub="vision_patches",
    num_patch_tokens=256,          # patch embeddings prepended per sample
    rope_theta=1_000_000.0,
    citation="arXiv:2409.12191",
)
