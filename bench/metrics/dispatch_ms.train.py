"""dispatch_ms.train: host time a training step takes to queue its work on
the card (from the call of the step to its return, before the step's
synchronise), summed over the window's steps, over the steps.  Where it
reaches the step's wall time, the host paces the step."""


def read(record):
    if record.get("kind") != "train" or not record.get("steps"):
        return None
    return 1e3 * record["dispatch_host_s"] / record["steps"]
