"""Op-DAG adapters: the paper's technique applied to an LM train step.

The paper demonstrates schedule search on SpMV. Here the LM
``train_step`` is exposed as an op-DAG so the same MCTS + rules pipeline
discovers collective-overlap schedules ("reduce-scatter(l) before
bwd(l-2)", stream assignments), scored by the analytic machine model
(:mod:`repro_torch.core.costmodel`) under the H100 constants of
:mod:`repro_torch.launch.costs` (:func:`~repro_torch.launch.costs.
train_step_machine`).

Vertices per transformer layer l (data-parallel + tensor-parallel step):

  fwd_l  (GPU, compute)            layer forward
  bwd_l  (GPU, compute)            layer backward (~2x fwd flops)
  rs_l   (GPU, collective stream)  reduce-scatter of layer-l gradients
  [ag_l  (GPU, collective stream)] ZeRO-style param all-gather before fwd_l
  opt    (GPU, compute)            optimizer update (needs all rs_l)

"Streams" = 1 compute stream + ``n_channels`` CUDA streams that carry
NCCL-style collectives over NVLink. Collectives are asynchronous device
ops, so, unlike the paper's CPU-posted MPI, they are GPU-type vertices:
binding one to the compute stream models a non-overlapped (blocking)
collective, binding it to a collective stream models overlap.

The JAX package's ``repro/core/stepdag.py`` with its imports rewritten;
the graph and its math are the reference's.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.dag import Graph, Op, OpKind


@dataclasses.dataclass(frozen=True)
class StepCosts:
    """Per-layer cost terms (per GPU), derivable from a roofline cell."""

    fwd_flops: float
    bwd_flops: float
    fwd_bytes: float
    bwd_bytes: float
    grad_bytes: float           # reduce-scattered per layer per GPU
    param_gather_bytes: float = 0.0  # ZeRO all-gather per layer (0 = off)
    opt_bytes: float = 0.0


def train_step_dag(n_layers: int, costs: StepCosts,
                   zero_sharded: bool = False) -> Graph:
    """Build the train-step op-DAG for schedule search."""
    g = Graph()
    for l in range(n_layers):
        g.add_op(Op(f"fwd{l}", OpKind.GPU, flops=costs.fwd_flops,
                    bytes_hbm=costs.fwd_bytes))
        g.add_op(Op(f"bwd{l}", OpKind.GPU, flops=costs.bwd_flops,
                    bytes_hbm=costs.bwd_bytes))
        # Collectives carry their wire bytes as comm_bytes; their
        # duration is pinned by with_comm_durations, since the machine
        # model prices a GPU op by flops and HBM bytes only.
        g.add_op(Op(f"rs{l}", OpKind.GPU, flops=0.0, bytes_hbm=0.0,
                    comm_bytes=costs.grad_bytes))
        if zero_sharded and costs.param_gather_bytes:
            g.add_op(Op(f"ag{l}", OpKind.GPU, comm_bytes=
                        costs.param_gather_bytes))
    g.add_op(Op("opt", OpKind.GPU, flops=0.0, bytes_hbm=costs.opt_bytes))

    for l in range(n_layers):
        if l + 1 < n_layers:
            g.add_edge(f"fwd{l}", f"fwd{l + 1}")
        if zero_sharded and costs.param_gather_bytes:
            g.add_edge(f"ag{l}", f"fwd{l}")
            g.add_edge(f"ag{l}", f"bwd{l}")  # params needed again in bwd
        g.add_edge(f"bwd{l}", f"rs{l}")
        g.add_edge(f"rs{l}", "opt")
    g.add_edge(f"fwd{n_layers - 1}", f"bwd{n_layers - 1}")
    for l in range(n_layers - 1, 0, -1):
        g.add_edge(f"bwd{l}", f"bwd{l - 1}")
    return g.finalize()


def with_comm_durations(graph: Graph, link_bytes_per_s: float,
                        latency_s: float = 2e-6) -> Graph:
    """Materialize collective durations (wire time) as fixed op durations.

    The machine model treats GPU-op duration as max(flops, hbm) terms;
    collectives over NVLink are wire-limited, so we pin
    duration = latency + B/bw. Returns a new Graph with the same
    structure.
    """
    out = Graph.__new__(Graph)
    out.ops = {}
    out.preds = {k: set(v) for k, v in graph.preds.items()}
    out.succs = {k: set(v) for k, v in graph.succs.items()}
    out.version = 0  # fresh object: caches key on identity + version
    for name, op in graph.ops.items():
        if op.kind is OpKind.GPU and op.comm_bytes:
            dur = latency_s + op.comm_bytes / link_bytes_per_s
            out.ops[name] = dataclasses.replace(op, duration=dur)
        else:
            out.ops[name] = op
    return out
