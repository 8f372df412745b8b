from repro_torch.configs.base import (  # noqa: F401
    ATTN_FULL, ATTN_LOCAL, ATTN_SWA, INPUT_SHAPES, MLSTM, RECURRENT, SLSTM,
    InputShape, ModelConfig, MoEConfig,
)
from repro_torch.configs.registry import (  # noqa: F401
    ASSIGNED_ARCHS, all_configs, get_config, get_shape,
)
