"""eval.host_ms: host milliseconds a design spends in the evaluator
(the program's ``engine.measure`` spans, one a design) beyond the
protocol's timed windows: capture, gate, warm-up and drains."""


def read(record: dict):
    span = (record.get("spans") or {}).get("engine.measure")
    if not span or not span["count"]:
        return None
    windows = record["repeats"] * record["t_measure_s"]
    return (span["total_s"] / span["count"] - windows) * 1e3
