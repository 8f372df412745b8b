# repro_torch.fleet: discrete-event heterogeneous edge-fleet simulation,
# carried over from repro/fleet/ with its numpy logic unchanged.
from repro_torch.fleet.control import (  # noqa: F401
    ControlAction, HillClimbController, SyncController, make_controller,
)
from repro_torch.fleet.devices import (  # noqa: F401
    ASYNC, AUTO, BACKUP_WORKERS, BOUNDED_STALENESS, CARRY_POLICIES, FULL_SYNC,
    LOCKSTEP, PER_DEVICE, PRESETS, SEMI_SYNC, DeviceProfile, FleetConfig,
    is_homogeneous, make_fleet,
)
from repro_torch.fleet.engine import (  # noqa: F401
    FleetEngine, RoundResult, RoundTelemetry,
)
from repro_torch.fleet.events import (  # noqa: F401
    COMM_DONE, COMPUTE_DONE, DEVICE_DOWN, STREAM_READY, Event, EventQueue,
)
from repro_torch.fleet.policies import (  # noqa: F401
    Async, BackupWorkers, BoundedStaleness, ChurnProcess, CommitPlan,
    FullSync, SemiSync, SyncPolicy, make_policy,
)
