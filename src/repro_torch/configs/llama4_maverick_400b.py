"""Llama-4 Maverick 400B-A17B [hf:meta-llama/Llama-4-Scout-17B-16E family].

MoE with 128 routed experts (top-1) + 1 shared expert; GQA (40 q / 8 kv);
chunked local attention on 3 of every 4 layers with a full-attention layer
every 4th (the full layers become sliding-window in the long_500k variant).
Early-fusion multimodal frontend is STUBBED as precomputed token embeddings.
"""
from repro_torch.configs.base import ATTN_FULL, ATTN_SWA, ModelConfig, MoEConfig

_pattern = tuple(ATTN_FULL if (i + 1) % 4 == 0 else ATTN_SWA for i in range(48))

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202_048,
    layer_pattern=_pattern,
    window_size=8192,          # chunked-local window
    # group_size 256: with 4k seq sequence-sharded 16-way, the group dim
    # (4096/256 = 16) aligns with the TP shards, so GShard dispatch lowers to
    # a clean all-to-all onto the expert-parallel axis (DESIGN.md §5)
    moe=MoEConfig(num_experts=128, top_k=1, capacity_factor=1.25,
                  num_shared_experts=1, layer_step=2, dense_d_ff=16384,
                  group_size=256),
    rope_theta=500_000.0,
    citation="hf:meta-llama/Llama-4-Scout-17B-16E",
)
