"""candidates_per_s: designs run, gated and timed in the window, over
the window's host seconds (rules and replay blocks included)."""


def read(record: dict):
    if not record.get("designs") or not record.get("window_s"):
        return None
    return record["designs"] / record["window_s"]
