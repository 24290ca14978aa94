"""Evaluation backends: the memo-cache contract and the wall-clock
evaluator on real streams."""
from repro_torch.engine.base import EvaluatorBase
from repro_torch.engine.wallclock import (ExecutorEvaluator,
                                          assert_outputs_close,
                                          reference_schedule)

__all__ = ["EvaluatorBase", "ExecutorEvaluator", "assert_outputs_close",
           "reference_schedule"]
