"""Observability of the port: run trackers, per-round trainer and fleet
records, MFU, serving event hooks, profiler capture windows, the spans and
counters at the program's layer boundaries (``spans``) and the
perf-regression gate."""
from repro_torch.obs.callbacks import (FLEET_ROUND, SERVE_EVENT,  # noqa: F401
                                       SERVE_SUMMARY, TRAIN_ROUND,
                                       TRAIN_SUMMARY, RoundObserver,
                                       fleet_round_record,
                                       ring_wire_bytes_per_device,
                                       serve_event)
from repro_torch.obs.mfu import (DEVICE_PEAK_FLOPS,  # noqa: F401
                                 counted_flops, lowered_flops, mfu)
from repro_torch.obs.profile import (capture, capture_step,  # noqa: F401
                                     profiler_available)
from repro_torch.obs import spans  # noqa: F401
from repro_torch.obs.regress import (GateReport, MetricSpec,  # noqa: F401
                                     compare, load_baseline, save_baseline,
                                     write_report)
from repro_torch.obs.tracker import (NOOP, SCHEMA_VERSION,  # noqa: F401
                                     CompositeTracker, JsonTracker,
                                     MemoryTracker, NoopTracker, Tracker,
                                     config_hash, git_sha, json_clean,
                                     ledger_metrics, read_ledger, run_stamp)
