"""prefill_ms.serve: host clock around each ``SlotRunner.admit`` (the whole
prompt's prefill, ended by a copy of its first token to the host) in the
window, over the admissions."""


def read(record):
    if record.get("kind") != "serve" or not record["admits"]:
        return None
    return 1e3 * record["admit_host_s"] / record["admits"]
