"""repro_torch.dist — the distribution layer (DESIGN.md §7).

Counterpart of ``repro/dist``.  ``sharding``: mesh plans, the partition
spec rules for every parameter / batch / decode-cache tree of the model zoo
(FSDP over ``data``, TP over ``model``, stacked layers get a leading
``None``) and their DTensor placements.
"""
from repro_torch.dist import sharding  # noqa: F401
from repro_torch.dist.sharding import (MeshPlan, NamedSharding, P,  # noqa: F401
                                       PartitionSpec, attn_mode_for,
                                       batch_specs, cache_specs, distribute,
                                       make_plan, make_run_ctx, named,
                                       param_specs)
