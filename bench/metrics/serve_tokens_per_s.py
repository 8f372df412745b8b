"""serve_tokens_per_s: output tokens produced in the window over the
window's seconds (host clock)."""


def read(record):
    if record.get("kind") != "serve":
        return None
    return record["tokens"] / record["window_s"]
