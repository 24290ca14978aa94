"""eval.unspanned_ms: host milliseconds a design spends in the evaluator
outside every phase span, the self time of the window's
``engine.measure`` spans (one a design) over their count: what capture,
release, gate and timing leave out (the runner's construction, the
loop)."""


def read(record: dict):
    span = (record.get("spans") or {}).get("engine.measure")
    if not span or not span["count"] or span.get("self_s") is None:
        return None
    return span["self_s"] / span["count"] * 1e3
