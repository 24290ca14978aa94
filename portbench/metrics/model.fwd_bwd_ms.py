"""model.fwd_bwd_ms: device milliseconds of a step's loss and gradients
(its start to the mark after the backward), median over the window's
steps."""
import statistics


def read(record: dict):
    ms = (record.get("parts") or {}).get("fwd_bwd")
    return statistics.median(ms) if ms else None
