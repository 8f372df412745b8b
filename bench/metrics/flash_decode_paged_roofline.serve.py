"""flash_decode_paged_roofline.serve: the least time the card could take for
the decode attention of the traced span's steps (the K/V bytes each step's
kv_lens cover, with the queries and outputs, every layer, at 3.35 TB/s)
over the device time of ``flash_decode_kernel`` in the span, as a
percentage."""
from bench import roofline
from bench.trace import kernel_seconds
from bench.weights import dims


def read(record):
    prof = record.get("profile")
    if record.get("kind") != "serve" or not prof:
        return None
    seconds = kernel_seconds(prof, "flash_decode_kernel")
    if seconds <= 0:
        return None
    z = dims(record["cfg"])
    moved = z["L"] * sum(roofline.flash_decode_paged_bytes(
        lens, z["h"], z["kv"], z["hd"]) for lens in prof["kv_lens"])
    return roofline.share(moved, seconds)
