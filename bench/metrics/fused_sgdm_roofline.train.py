"""fused_sgdm_roofline.train: the least time the card could take for the
momentum-SGD update of every parameter (p, g, m read, p, m written, f32, at
3.35 TB/s) over the device time of the ``fused_sgdm`` kernels
(``sgdm_vec4``, ``sgdm_scalar``) in the traced span, as a percentage."""
from bench import roofline
from bench.trace import kernel_seconds


def read(record):
    prof = record.get("profile")
    if record.get("kind") != "train" or not prof:
        return None
    seconds = kernel_seconds(prof, "sgdm_vec4", "sgdm_scalar")
    if seconds <= 0:
        return None
    return roofline.share(prof["steps"] * roofline.fused_sgdm_bytes(
        record["n"]), seconds)
