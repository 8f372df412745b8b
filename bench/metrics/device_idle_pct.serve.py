"""device_idle_pct.serve: the share of the traced span in which no operation ran
on the device (1 - the union of its kernel, copy and fill intervals over the
span, from the profiler), as a percentage."""


def read(record):
    prof = record.get("profile")
    if record.get("kind") != "serve" or not prof or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
