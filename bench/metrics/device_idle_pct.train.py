"""device_idle_pct.train: the share of an untraced step in which no
operation ran on the device, as a percentage: 1 - (device busy time a step,
the union of its kernel, copy and fill intervals over the traced span's
steps) / (wall time a step in the window).  Tracing costs this
launch-bound step host time of its own (a few microseconds a launch), so
the traced span's own idle share would count the tracer; its wall time is
not used."""


def read(record):
    prof = record.get("profile")
    if record.get("kind") != "train" or not prof or prof["busy_s"] <= 0:
        return None
    busy = prof["busy_s"] / prof["steps"]
    return 100.0 * (1.0 - busy / (record["window_s"] / record["steps"]))
