"""repro_torch.dist — the distribution and counting layer (DESIGN.md §7).

Counterpart of ``repro/dist``.  Four pieces:

* ``sharding``     — mesh plans, the partition spec rules for every
  parameter / batch / decode-cache tree of the model zoo (FSDP over
  ``data``, TP over ``model``, stacked layers get a leading ``None``) and
  their DTensor placements.
* ``hlo_cost``     — records the aten program one call executes (on fake
  CPU tensors, per rank under a mesh) and counts its flops, bytes and
  collective wire bytes, loops trip by trip.
* ``hlo_analysis`` — collective wire factors, the three-term roofline
  against one H100, and MODEL_FLOPS references.
* ``calibrate``    — records the dense/compressed DDP programs on a fake
  process group and turns their collective wire bytes into the fleet
  engine's comm-bytes model.
"""
from repro_torch.dist import hlo_analysis, hlo_cost, sharding  # noqa: F401
from repro_torch.dist.hlo_analysis import (CollectiveOp,  # noqa: F401
                                           collective_bytes, model_flops,
                                           roofline)
from repro_torch.dist.hlo_cost import analyze, record  # noqa: F401
from repro_torch.dist.sharding import (MeshPlan, NamedSharding, P,  # noqa: F401
                                       PartitionSpec, attn_mode_for,
                                       batch_specs, cache_specs, distribute,
                                       make_plan, make_run_ctx, named,
                                       param_specs)
