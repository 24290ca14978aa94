"""The device's idle share of the profiled stretch of the prefill
window, in percent: ``device_idle_pct.train``'s reading of the same
``stretch`` record."""
from pathlib import Path

from portbench.harness import load_module

read = load_module(Path(__file__).with_name("device_idle_pct.train.py"),
                   "portbench_metric_device_idle_pct_train").read
