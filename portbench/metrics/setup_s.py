"""setup_s: host seconds from the start of the run to the start of its
timed window: inputs, weights, the program's build and its warm-up."""


def read(record: dict):
    return record.get("setup_s")
