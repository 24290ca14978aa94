"""pack_roofline: the least time of a step's pack (index, send buffer
and x, 4 bytes each, at the HBM's rate; frozen in _yardstick.py) over
its device time in a replay after an L2 flush, median over the traced
replays, in percent."""
import statistics

from portbench.metrics import _yardstick as Y


def read(record: dict):
    cold = [r["pack_us"] for r in record.get("replay_trace") or []
            if r["cold"] and r["pack_us"] > 0]
    if not cold:
        return None
    bound_us = Y.bound_s(Y.pack_bytes(record["parts"]["n"]), 0.0) * 1e6
    return 100.0 * bound_us / statistics.median(cold)
