"""setup_s: process start to the first timed step, on the host clock (imports,
the card's start, kernel builds or loads, weights, the first steps)."""


def read(record):
    return record.get("setup_s")
