"""Program model, sync insertion, enumeration, features, the analytic
machine model, the measurement protocol, the executor and the train-step
op-DAG.

The labels -> tree -> rules names of :mod:`repro_torch.rules` are
re-exported here (imported on first use), as the JAX package's
``repro.core`` does, so that
``import repro_torch.core as C`` serves the whole paper pipeline
(``C.label_times``, ``C.featurize``, ``C.algorithm1``, ...).
"""
from repro_torch.core.dag import (BoundOp, CommRole, Graph, Op, OpKind,
                                  Schedule, canonicalize_streams,
                                  halo3d_dag, spmv_dag, spmv_dag_fine,
                                  validate_schedule)
from repro_torch.core.costmodel import Machine, SimResult, makespan, simulate
from repro_torch.core.enumerate import count_schedules, enumerate_schedules
from repro_torch.core.features import (DegenerateFeatureSpaceError, Feature,
                                       FeatureBasis, FeatureMatrix,
                                       FeatureUniverse, apply_features,
                                       featurize, featurize_like)
from repro_torch.core.executor import build_runner, jit_runner, op_impl
from repro_torch.core.stepdag import (StepCosts, train_step_dag,
                                      with_comm_durations)
from repro_torch.core.sync import ExpandedItem, expand, expanded_names

# The rules names, by the module that defines them. They are imported on
# first use: repro_torch.rules imports repro_torch.space, whose base
# module imports this package, so an eager import here would make
# ``import repro_torch.space`` fail in a fresh process.
_RULES = {"Labeling": "labels", "label_times": "labels",
          "Rule": "rulesets", "RuleSet": "rulesets",
          "annotate_vs_canonical": "rulesets",
          "class_range_accuracy": "rulesets",
          "extract_rulesets": "rulesets", "render_rules_table": "rulesets",
          "rules_by_class": "rulesets", "DecisionTree": "trees",
          "TreeSearchTrace": "trees", "algorithm1": "trees"}


def __getattr__(name: str):
    if name in _RULES:
        import importlib

        return getattr(importlib.import_module(
            f"repro_torch.rules.{_RULES[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "BoundOp", "CommRole", "Graph", "Op", "OpKind", "Schedule",
    "canonicalize_streams", "halo3d_dag", "spmv_dag", "spmv_dag_fine",
    "validate_schedule", "count_schedules", "enumerate_schedules",
    "Machine", "SimResult", "makespan", "simulate",
    "DegenerateFeatureSpaceError", "Feature", "FeatureBasis",
    "FeatureMatrix", "FeatureUniverse", "apply_features", "featurize",
    "featurize_like", "build_runner", "jit_runner", "op_impl",
    "Labeling", "label_times",
    "DecisionTree", "TreeSearchTrace", "algorithm1",
    "Rule", "RuleSet", "annotate_vs_canonical", "class_range_accuracy",
    "extract_rulesets", "render_rules_table", "rules_by_class",
    "ExpandedItem", "expand", "expanded_names",
    "StepCosts", "train_step_dag", "with_comm_durations",
]
