"""step_us: all timed steps over all their host time, in microseconds
(the fastest design's back-to-back replays, or the slowest rank's SpMV
steps)."""


def read(record: dict):
    if not record.get("steps"):
        return None
    return record["steps_s"] / record["steps"] * 1e6
