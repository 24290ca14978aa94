"""rank_rho: Spearman's rho between the times of every design in the
window's first two whole sweeps (ranks by average over ties)."""
import numpy as np


def _ranks(a: np.ndarray) -> np.ndarray:
    order = np.argsort(a, kind="stable")
    r = np.empty(len(a))
    r[order] = np.arange(len(a), dtype=float)
    for v in np.unique(a):
        tie = a == v
        if tie.sum() > 1:
            r[tie] = r[tie].mean()
    return r


def read(record: dict):
    sweeps = record.get("sweeps") or []
    if len(sweeps) < 2:
        return None
    a, b = sweeps[0]["times"], sweeps[1]["times"]
    keys = [k for k in a if k in b]
    if len(keys) < 3:
        return None
    ra = _ranks(np.array([a[k] for k in keys]))
    rb = _ranks(np.array([b[k] for k in keys]))
    return float(np.corrcoef(ra, rb)[0, 1])
