"""Observability of the port: run trackers and serving event hooks."""
from repro_torch.obs.callbacks import (SERVE_EVENT,  # noqa: F401
                                       SERVE_SUMMARY, serve_event)
from repro_torch.obs.tracker import (NOOP, SCHEMA_VERSION,  # noqa: F401
                                     CompositeTracker, JsonTracker,
                                     MemoryTracker, NoopTracker, Tracker,
                                     config_hash, git_sha, json_clean,
                                     ledger_metrics, read_ledger, run_stamp)
