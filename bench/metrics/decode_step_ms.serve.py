"""decode_step_ms.serve: host clock around each ``SlotRunner.step`` (which
ends in a copy of the tokens to the host) in the window, over the steps."""


def read(record):
    if record.get("kind") != "serve" or not record["steps"]:
        return None
    return 1e3 * record["decode_host_s"] / record["steps"]
