"""Program model, sync insertion, enumeration, features, the analytic
machine model, the measurement protocol, the executor and the train-step
op-DAG."""
from repro_torch.core.dag import (BoundOp, CommRole, Graph, Op, OpKind,
                                  Schedule, canonicalize_streams,
                                  halo3d_dag, spmv_dag, spmv_dag_fine,
                                  validate_schedule)
from repro_torch.core.costmodel import Machine, SimResult, makespan, simulate
from repro_torch.core.enumerate import count_schedules, enumerate_schedules
from repro_torch.core.features import (DegenerateFeatureSpaceError, Feature,
                                       FeatureBasis, FeatureMatrix,
                                       FeatureUniverse, apply_features,
                                       featurize)
from repro_torch.core.stepdag import (StepCosts, train_step_dag,
                                      with_comm_durations)
from repro_torch.core.sync import ExpandedItem, expand, expanded_names

__all__ = [
    "BoundOp", "CommRole", "Graph", "Op", "OpKind", "Schedule",
    "canonicalize_streams", "halo3d_dag", "spmv_dag", "spmv_dag_fine",
    "validate_schedule", "count_schedules", "enumerate_schedules",
    "Machine", "SimResult", "makespan", "simulate",
    "DegenerateFeatureSpaceError", "Feature", "FeatureBasis",
    "FeatureMatrix", "FeatureUniverse", "apply_features", "featurize",
    "ExpandedItem", "expand", "expanded_names",
    "StepCosts", "train_step_dag", "with_comm_durations",
]
