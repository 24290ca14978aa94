"""flash_bf16_roofline: the bf16 flash kernel's share of its roofline in
the traced stretch, in percent: the least time of its launches (each
the larger of its bytes at 3.35 TB/s and its causal FLOPs at 989
TFLOP/s; frozen in _yardstick_models.py) over their device time
(``flash_fwd_bf16_kernel`` in the profiler's trace)."""
from portbench.metrics import _yardstick as Y
from portbench.metrics import _yardstick_models as M


def read(record: dict):
    f = record.get("flash")
    if not f or not f["launches"] or not f["device_s"]:
        return None
    least = Y.bound_s(
        M.flash_bytes(f["batch"], f["heads"], f["kv_heads"], f["seq"],
                      f["head_dim"]),
        M.flash_flops(f["batch"], f["heads"], f["seq"], f["head_dim"]),
        Y.BF16_FLOPS)
    return 100.0 * f["launches"] * least / f["device_s"]
