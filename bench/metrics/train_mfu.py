"""train_mfu: the model flops of the window's steps (forward and backward
products from the configuration's shapes, no recomputation: bench/flops.py)
over the window's seconds times the card's f32 peak, 67 TFLOP/s, as a
percentage."""
from bench.roofline import PEAK_F32_FLOPS


def read(record):
    if record.get("kind") != "train":
        return None
    return 100.0 * record["flops"] / (record["window_s"] * PEAK_F32_FLOPS)
