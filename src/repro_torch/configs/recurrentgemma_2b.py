"""RecurrentGemma-2B [arXiv:2402.19427] — hybrid RG-LRU + local attention (1:2).

Griffin block pattern: two recurrent (RG-LRU) blocks followed by one local
(sliding-window) attention block.  26 layers, MQA (1 kv head), GeGLU MLP.
"""
from repro_torch.configs.base import ATTN_LOCAL, RECURRENT, ModelConfig

_pattern = []
while len(_pattern) < 26:
    _pattern += [RECURRENT, RECURRENT, ATTN_LOCAL]
_pattern = tuple(_pattern[:26])

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    layer_pattern=_pattern,
    window_size=2048,
    lru_dim=2560,
    tie_embeddings=True,
    citation="arXiv:2402.19427",
)
