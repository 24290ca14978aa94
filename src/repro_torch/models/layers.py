"""Shared neural layers: norms, MLP variants, rotary embeddings.

Plain functions on tensors, as in the reference (``repro/models/
layers.py``); ``p`` is a dict of tensors or a :class:`~.params.Params`.
The reference's ``constrain`` calls stand where it puts them: they place
activations on a mesh inside an ``activation_sharding`` context and
return their input unchanged outside one.
"""
from __future__ import annotations

import threading

import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.dist.sharding import constrain
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import Spec


# -- norms -------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """float32 inside, cast back, then ``* scale`` in x's dtype."""
    dt = x.dtype
    xf = x.float()
    rms = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * rms).to(dt) * scale.to(dt)


def norm_spec(d: int) -> Spec:
    return Spec((d,), ("d_model",), init="ones")


# -- rotary position embeddings ----------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: broadcastable to (..., S). Halves
    split (not interleaved); angles in float32."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].float() * freq         # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- MLP variants --------------------------------------------------------------

def mlp_specs(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp in ("swiglu", "geglu"):
        return {
            "wi": Spec((d, f), ("d_model", "d_ff")),
            "wg": Spec((d, f), ("d_model", "d_ff")),
            "wo": Spec((f, d), ("d_ff", "d_model")),
        }
    return {
        "wi": Spec((d, f), ("d_model", "d_ff")),
        "wo": Spec((f, d), ("d_ff", "d_model")),
    }


def mlp(p, x: torch.Tensor, kind: str, lead: tuple = ("batch", "seq"),
        keep_out: bool = False) -> torch.Tensor:
    """The reference casts each weight to x's dtype at every call.
    ``lead`` names x's leading dims for the constraints (the MoE experts'
    batched call passes ("experts", "batch"): the reference vmaps this
    function over the experts, so each expert's tokens keep the batch's
    placement). ``keep_out`` runs the output projection, with its
    constraint, through :func:`kept`."""
    h = x @ p["wi"].to(x.dtype)
    h = constrain(h, (*lead, "d_ff"))
    if kind == "swiglu":
        h = F.silu(x @ p["wg"].to(x.dtype)) * h
    elif kind == "geglu":
        h = F.gelu(x @ p["wg"].to(x.dtype), approximate="tanh") * h
    elif kind == "relu2":               # squared ReLU (Primer / nemotron)
        h = torch.square(F.relu(h))
    elif kind == "gelu":
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    else:
        raise ValueError(f"unknown mlp kind {kind!r}")
    wo = p["wo"].to(x.dtype)

    def out(h):
        return constrain(h @ wo, (*lead, "d_model"))

    return kept(out, h) if keep_out else out(h)


# -- kept products ------------------------------------------------------------

_keeping = threading.local()


class _Keep:
    """One side of :func:`keep_context`: the forward's (it records what
    :func:`kept` returns) or the recomputation's (it replays that)."""

    def __init__(self, outputs: list, replay: bool):
        self.outputs, self.replay, self.index = outputs, replay, 0

    def __enter__(self):
        self.before = getattr(_keeping, "state", None)
        self.index = 0
        _keeping.state = self
        return self

    def __exit__(self, *exc):
        _keeping.state = self.before


def keep_context():
    """``context_fn`` for ``torch.utils.checkpoint.checkpoint``: the
    checkpointed function's forward keeps the output of each
    :func:`kept` call, and its recomputation gets it back without
    computing; every other op is recomputed, as without a context."""
    outputs: list = []
    return _Keep(outputs, replay=False), _Keep(outputs, replay=True)


class _Answer(TorchDispatchMode):
    """Answers the one matrix product it sees with ``out`` (reshaped to
    the product's shape) instead of computing it."""

    def __init__(self, out):
        super().__init__()
        self.out = out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
            if self.out is None:
                raise RuntimeError("kept: a second product")
            out, self.out = self.out, None
            return out.reshape(*args[0].shape[:-1], args[1].shape[-1])
        return func(*args, **(kwargs or {}))


def kept(product, *args):
    """``product(*args)``, one matrix product and what follows it (views,
    constraints). Inside a checkpoint whose ``context_fn`` is
    :func:`keep_context`, the forward keeps its output (one activation)
    and the recomputation returns it: the product is still dispatched,
    so autograd saves its inputs as in the forward, and answered with
    the kept output, which already has its final placement (no
    collective either). Elsewhere it is ``product(*args)``."""
    state = getattr(_keeping, "state", None)
    if state is None:
        return product(*args)
    if not state.replay:
        out = product(*args)
        state.outputs.append(out.detach())
        return out
    out = state.outputs[state.index]
    state.index += 1
    with _Answer(out):
        return product(*args)


# -- embeddings ----------------------------------------------------------------

def embed_specs(cfg: ModelConfig) -> dict:
    d, v = cfg.d_model, cfg.vocab
    out = {"tokens": Spec((v, d), ("vocab", "d_model"), scale=1.0)}
    if not cfg.tie_embeddings:
        out["lm_head"] = Spec((d, v), ("d_model", "vocab"))
    if cfg.frontend is not None:
        out["frontend_proj"] = Spec(
            (cfg.frontend.d_frontend, d), ("d_frontend", "d_model"))
    return out


def embed_tokens(p, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Gather the rows, then cast: the reference casts the whole table
    first (the same values; at qwen2.5-32b a 1.57 GB copy per call). The
    gather is ``F.embedding``, which DTensor runs on a vocab-sharded
    table (each rank looks up its rows, a masked partial sum). There
    the local shard is cast first, as the reference does, so that the
    partial sum is reduced in ``dtype`` (every term but one is an exact
    zero: the same values)."""
    table = p["tokens"]
    if any(getattr(q, "dim", None) == 0
           for q in getattr(table, "placements", ())):
        return constrain(F.embedding(tokens, table.to(dtype)),
                         ("batch", "seq", "d_model"))
    return constrain(F.embedding(tokens, table).to(dtype),
                     ("batch", "seq", "d_model"))


def logits_out(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        out = x @ p["tokens"].to(x.dtype).T
    else:
        out = x @ p["lm_head"].to(x.dtype)
    return constrain(out, ("batch", "seq", "vocab"))
