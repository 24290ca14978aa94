"""train.opt_ms: device milliseconds of a step's optimizer, from CUDA
events the step records after its backward and after AdamW's update
(``make_train_step``'s marks), median over the window's steps."""
import statistics


def read(record: dict):
    ms = (record.get("parts") or {}).get("opt")
    return statistics.median(ms) if ms else None
