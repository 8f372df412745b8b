"""train_tokens_per_s: tokens of all steps completed in the window over the
window's seconds (host clock; the window ends with its last step)."""


def read(record):
    if record.get("kind") != "train":
        return None
    return record["tokens"] / record["window_s"]
