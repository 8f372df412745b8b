"""xLSTM-125M [arXiv:2405.04517] — alternating sLSTM / mLSTM blocks.

sLSTM has a true sequential recurrence (lax.scan); mLSTM is a gated
matrix-memory block parallelised as chunked linear attention.  d_ff=0: xLSTM
blocks carry their own up/down projections instead of a separate MLP.
"""
from repro_torch.configs.base import MLSTM, SLSTM, ModelConfig

_pattern = tuple(MLSTM if i % 2 == 0 else SLSTM for i in range(12))

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50_304,
    layer_pattern=_pattern,
    tie_embeddings=True,
    citation="arXiv:2405.04517",
)
