"""eval.gate_ms: host milliseconds of a design's gate, mean over the
window's ``engine.gate`` spans (reset, the gated run, drains, the
outputs' copies to the host, the compare; the reference's run inside
the first of each sweep)."""


def read(record: dict):
    span = (record.get("spans") or {}).get("engine.gate")
    if not span or not span["count"]:
        return None
    return span["total_s"] / span["count"] * 1e3
