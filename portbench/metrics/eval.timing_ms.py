"""eval.timing_ms: host milliseconds of a design's timing, mean over the
window's ``engine.timing`` spans (the untimed warm-up calls and the
protocol's windows of back-to-back replays, each with its own warm-up
call and drains)."""


def read(record: dict):
    span = (record.get("spans") or {}).get("engine.timing")
    if not span or not span["count"]:
        return None
    return span["total_s"] / span["count"] * 1e3
