"""scatter_aggregate_roofline.train: the least time the card could take for
the compressed step's aggregate (its packet read and its dense output
written, at 3.35 TB/s) over the device time of the kernel's launches
(``zero_fill`` and ``add_packet``) in the traced span, as a percentage."""
from bench import roofline
from bench.trace import kernel_seconds


def read(record):
    prof = record.get("profile")
    if record.get("step") != "compressed" or not prof:
        return None
    seconds = kernel_seconds(prof, "zero_fill", "add_packet")
    if seconds <= 0:
        return None
    moved = prof["steps"] * roofline.scatter_aggregate_bytes(
        record["n"], record["k"])
    return roofline.share(moved, seconds)
