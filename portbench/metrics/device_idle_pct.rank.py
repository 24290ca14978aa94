"""The device's idle share of the profiled stretch of the window, in
percent: 100 (1 - busy_s / window_s), busy_s the seconds in which an
operation ran on the device (averaged over the cards used)."""


def read(record: dict):
    s = record.get("stretch")
    if not s or not s["window_s"] or not s["busy_s"]:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
