"""aggregate_ms.train: device time of the training step's ``aggregate`` phase, CUDA
events at the program's ``on_phase`` marks (from the previous mark, or
the step's start), summed over the window's steps, over the steps."""


def read(record):
    ms = record.get("phase_ms", {}).get("aggregate")
    if ms is None or not record.get("phase_steps"):
        return None
    return ms / record["phase_steps"]
