"""prefill.mfu: the prefill's share of the card's bf16 peak: the model
FLOPs of a batch (2 N D on the layers' active parameters, the head at
each prompt's last position, the causal attention; frozen in
_yardstick_models.py) over the window's time a batch at 989 TFLOP/s, in
percent."""
from portbench.metrics import _yardstick as Y
from portbench.metrics import _yardstick_models as M


def read(record: dict):
    if not record.get("batches") or "flops_config" not in record:
        return None
    flops = M.prefill_flops(record["flops_config"], record["batch"],
                            record["seq"])
    batch_s = record["window_s"] / record["batches"]
    return 100.0 * flops / (batch_s * Y.BF16_FLOPS)
