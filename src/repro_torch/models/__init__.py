from repro_torch.models.transformer import (  # noqa: F401
    RunCtx, check_supported, forward_hidden, init_params, layer_sigs,
    lm_loss, logits_fn, stack_plan,
)
from repro_torch.models.decode import (  # noqa: F401
    decode_step, init_cache, init_slot_cache, prefill_cache, slot_evict,
    slot_insert,
)
