"""Whisper-base [arXiv:2212.04356] — encoder-decoder; conv/mel frontend STUBBED.

Per the brief, ``input_specs`` supplies precomputed frame embeddings of shape
(batch, frames, d_model); the encoder attends over them bidirectionally and the
decoder autoregresses with cross-attention.  Frames padded 1500 -> 1536 so the
encoder sequence shards over the 16-way model axis (DESIGN.md §4).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,            # decoder layers
    encoder_layers=6,
    encoder_seq_len=1536,    # 1500 mel frames padded to a shardable multiple
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51_865,
    frontend_stub="audio_conv",
    tie_embeddings=True,
    citation="arXiv:2212.04356",
)
