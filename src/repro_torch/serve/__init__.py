"""Continuous-batching streaming inference of the port on the event core.

Exports as the reference's ``repro.serve``, less its ``control`` module
(the ``ServeController`` waits for the port of ``fleet/control.py``).
"""
from repro_torch.serve.engine import (  # noqa: F401
    DEADLINE, REQUEST_ARRIVAL, ContinuousBatchingServer, PrefixSimRunner,
    SlotRunner, StaticBatchingServer, StepCostModel, measured_cost_model,
)
from repro_torch.serve.metrics import (  # noqa: F401
    RequestRecord, RollingWindow, summarize,
)
from repro_torch.serve.requests import (  # noqa: F401
    BurstyRequestStream, Request, RequestStream, assign_templates,
)
from repro_torch.serve.scheduler import (  # noqa: F401
    PRIORITIES, PRIORITY_DECODE_FIRST, PRIORITY_PREFILL_FIRST, Scheduler,
)
