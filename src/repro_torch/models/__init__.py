from repro_torch.models.transformer import (  # noqa: F401
    RunCtx, check_supported, forward_hidden, init_params, layer_sigs,
    lm_loss, logits_fn, stack_plan,
)
from repro_torch.models.decode import (  # noqa: F401
    ChunkedPrefill, decode_step, gather_prefix_kv, init_cache,
    init_paged_cache, init_slot_cache, pages_needed, paged_evict,
    paged_insert, prefill_cache, prefix_sharing_supported, slot_evict,
    slot_insert,
)
from repro_torch.models.paging import (  # noqa: F401
    PagePool, PrefixIndex, PrefixMatch, page_keys,
)
