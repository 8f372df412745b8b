"""InternLM2-20B [arXiv:2403.17297] — dense decoder, GQA (48 q / 8 kv heads)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92_544,
    rope_theta=1_000_000.0,
    citation="arXiv:2403.17297",
)
