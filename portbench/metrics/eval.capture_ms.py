"""eval.capture_ms: host milliseconds of a design's capture, mean over
the window's ``executor.capture`` spans (a graph runner's first call:
its warm-up run, the capture, the first replay). One a design, and one
for each replay block's runner of the fastest design."""


def read(record: dict):
    span = (record.get("spans") or {}).get("executor.capture")
    if not span or not span["count"]:
        return None
    return span["total_s"] / span["count"] * 1e3
