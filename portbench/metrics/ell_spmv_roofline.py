"""ell_spmv_roofline: the least time of a step's two ell_spmv products
(their bytes, each read or written once, at the HBM's rate; frozen in
_yardstick.py) over their device time in a replay after an L2 flush,
median over the traced replays, in percent."""
import statistics

from portbench.metrics import _yardstick as Y


def read(record: dict):
    cold = [r["ell_spmv_us"] for r in record.get("replay_trace") or []
            if r["cold"] and r["ell_spmv_us"] > 0]
    if not cold:
        return None
    p = record["parts"]
    bound_us = Y.bound_s(Y.ell_spmv_bytes(p), Y.ell_spmv_flops(p)) * 1e6
    return 100.0 * bound_us / statistics.median(cold)
