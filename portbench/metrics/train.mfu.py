"""train.mfu: the whole train step's share of the card's bf16 peak: the
model FLOPs of a step (6 N D on the active parameters plus the causal
attention term; frozen in _yardstick.py) over the window's time a step
at 989 TFLOP/s, in percent (the card's power limit is in the result's
device record)."""
from portbench.metrics import _yardstick as Y


def read(record: dict):
    if not record.get("steps"):
        return None
    flops = Y.model_flops(record["flops_config"], record["batch"],
                          record["seq"])
    step_s = record["window_s"] / record["steps"]
    return 100.0 * flops / (step_s * Y.BF16_FLOPS)
