"""train_mla.mfu: the latent-attention train step's share of the card's
bf16 peak: 6 N D on the active parameters plus 6 L B (S^2 / 2) H (d_qk +
d_v) of causal attention (frozen in _yardstick_models.py) over the
window's time a step at 989 TFLOP/s, in percent."""
from portbench.metrics import _yardstick as Y
from portbench.metrics import _yardstick_models as M


def read(record: dict):
    if not record.get("steps") or "mla_config" not in record:
        return None
    flops = M.mla_train_flops(record["mla_config"], record["batch"],
                              record["seq"])
    step_s = record["window_s"] / record["steps"]
    return 100.0 * flops / (step_s * Y.BF16_FLOPS)
