"""spmv_step.mfu: the whole SpMV step's share of the card's peak: its
least time (the matrix, x, the halo and y counted once at the HBM's
rate, against 2 nnz operations at the float32 peak; bytes bound it)
over step_us, in percent."""
from portbench.metrics import _yardstick as Y


def read(record: dict):
    if not record.get("steps"):
        return None
    p = record["parts"]
    bound_s = Y.bound_s(Y.step_bytes(p), Y.ell_spmv_flops(p))
    return 100.0 * bound_s / (record["steps_s"] / record["steps"])
