"""Causal self-attention for training on the card: launch wrappers of
csrc/flash_attention_train.cu (a forward that keeps the log-sum-exp and
an f32 copy of o, FlashAttention-2's dQ pass and dK/dV pass) and the
``torch.autograd.Function`` over them.

Replaces no TPU kernel: the reference's Pallas kernel has no backward,
and the reference trains through its XLA streaming softmax
(``models/attention.py:_streaming`` here). On a CUDA tensor each wrapper
launches its kernel or raises; :class:`FlashTrain` takes the plain
versions (:func:`forward_plain`, :func:`backward_plain`, the same sums in
float32 PyTorch) for a tensor on the CPU. ``models/attention.py`` decides
which calls come here (``trains_on_kernel``).

Operands: q and k (B, S, H, D_QK), v (B, S, H, D_V), bfloat16, one kv
head a q head, at any strides with D contiguous and every other stride
and each base 16-byte aligned; keys at positions 0..S-1, all valid,
query i seeing keys j <= i; ``scale`` multiplies q . k.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels._launch import check_cuda_args, stream_handle

# (D_QK, D_V) the kernels are built for: deepseek-moe-16b's heads and
# Moonlight's latent attention.
TEMPLATES = ((128, 128), (192, 128))
# S is a multiple of the forward's 128-row query and key blocks (the
# backward's 64- and 32-row blocks divide it).
BLOCK = 128
NEG_INF = float("-inf")

_fns: dict = {}


def takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the kernels take these operands' shapes and dtypes: all
    bfloat16, q and k (B, S, H, D_QK), v (B, S, H, D_V), (D_QK, D_V) in
    :data:`TEMPLATES`, S a positive multiple of :data:`BLOCK`."""
    return (q.dim() == k.dim() == v.dim() == 4 and
            q.dtype == k.dtype == v.dtype == torch.bfloat16 and
            q.shape == k.shape and q.shape[:3] == v.shape[:3] and
            (q.shape[3], v.shape[3]) in TEMPLATES and
            q.shape[1] > 0 and q.shape[1] % BLOCK == 0)


def check(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          do: torch.Tensor | None = None) -> None:
    """Raise unless the kernels can read q, k, v (and ``do``, laid out as
    v) where they lie: ``TypeError`` for another dtype, ``ValueError``
    for another shape, device or layout."""
    more = () if do is None else (do,)
    if not all(t.dtype == torch.bfloat16 for t in (q, k, v, *more)):
        raise TypeError(f"{what}: q, k, v and dO must be bfloat16, got "
                        f"{[str(t.dtype) for t in (q, k, v, *more)]}")
    if not takes(q, k, v) or (do is not None and do.shape != v.shape):
        raise ValueError(
            f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)} do not fit (B, S, H, D_QK), (B, S, H, D_QK),"
            f" (B, S, H, D_V) with (D_QK, D_V) in {TEMPLATES} and S a "
            f"multiple of {BLOCK}" + ("" if do is None else
                                      f", dO {tuple(do.shape)} as v"))
    check_cuda_args(what, q, k, v, *more, contiguous=False)
    for t in (q, k, v, *more):
        if not readable(t):
            raise ValueError(
                f"{what}: D must be contiguous and every other stride and "
                f"the base 16-byte aligned, got strides {t.stride()}")


def readable(t: torch.Tensor) -> bool:
    """D contiguous, every other stride of a dimension above one nonzero
    and 16-byte aligned, the base 16-byte aligned: what the forward's
    tensor maps (no zero stride) and the backward's 16-byte copies
    take."""
    size = t.element_size()
    return t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
        st and st * size % 16 == 0
        for n, st in zip(t.shape[:-1], t.stride()[:-1]) if n > 1)


def ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` where the kernels can read it as it lies, else a copy."""
    return t if readable(t) else t.contiguous()


def _dims(q, k, v, do=None) -> ctypes.Array:
    """B, S, H, D_QK, D_V, then the (b, s, h) strides of q, k, v and dO
    (0 for a dimension of one)."""
    b, s, h, dq = q.shape
    strides = [st if n > 1 else 0
               for t in (q, k, v, do if do is not None else v)
               for n, st in zip(t.shape[:3], t.stride()[:3])]
    dims = [b, s, h, dq, v.shape[3]] + strides
    return (ctypes.c_longlong * len(dims))(*dims)


def _fn(name: str, n_ptr: int):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.library("flash_attention_train"), name)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + \
            [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
             ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            scale: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch: (o (B, S, H, D_V) bf16, o32 the same in float32, lse
    (B, H, S) float32, the log-sum-exp of each row's scaled scores)."""
    check("flash train forward", q, k, v)
    b, s, h, _ = q.shape
    o = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    o32 = torch.empty(v.shape, dtype=torch.float32, device=v.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    err = _fn("flash_train_fwd", 6)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        o32.data_ptr(), lse.data_ptr(), _dims(q, k, v), float(scale),
        stream_handle(q.device))
    build.check(err, "flash train forward")
    forward.launches += 1
    return o, o32, lse


def backward_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                do: torch.Tensor, o32: torch.Tensor, lse: torch.Tensor,
                scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch: (dq (B, S, H, D_QK) bf16, delta (B, H, S) float32,
    rowsum(dO * o32), which :func:`backward_dkdv` takes)."""
    check("flash train dq", q, k, v, do)
    b, s, h, _ = q.shape
    _check_saved("flash train dq", v, (o32, v.shape), (lse, (b, h, s)))
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    err = _fn("flash_train_bwd_dq", 8)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        o32.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        _dims(q, k, v, do), float(scale), stream_handle(q.device))
    build.check(err, "flash train dq")
    backward_dq.launches += 1
    return dq, delta


def backward_dkdv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                  scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch: (dk (B, S, H, D_QK), dv (B, S, H, D_V)), bf16."""
    check("flash train dkdv", q, k, v, do)
    b, s, h, _ = q.shape
    _check_saved("flash train dkdv", v, (lse, (b, h, s)), (delta, (b, h, s)))
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    err = _fn("flash_train_bwd_dkdv", 8)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _dims(q, k, v, do), float(scale), stream_handle(q.device))
    build.check(err, "flash train dkdv")
    backward_dkdv.launches += 1
    return dk, dv


forward.launches = 0
backward_dq.launches = 0
backward_dkdv.launches = 0


def _check_saved(what: str, v: torch.Tensor,
                 *saved: tuple[torch.Tensor, tuple]) -> None:
    """The forward's outputs as it wrote them: each (tensor, shape) of
    ``saved`` float32, contiguous, on v's device."""
    for t, shape in saved:
        if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) or \
                not t.is_contiguous() or t.device != v.device:
            raise ValueError(
                f"{what}: expected a contiguous float32 {tuple(shape)} on "
                f"{v.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """(B, H, S, S) float32 scale * q . k, keys after the query at -inf."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    n = q.shape[1]
    later = torch.arange(n, device=q.device)[None, :] > \
        torch.arange(n, device=q.device)[:, None]
    return s.masked_fill(later, NEG_INF)


def forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """:func:`forward` in float32 PyTorch."""
    s = _scores(q, k, scale)
    lse = torch.logsumexp(s, dim=-1)
    o32 = torch.einsum("bhqk,bkhd->bqhd", torch.exp(s - lse[..., None]),
                       v.float())
    return o32.to(v.dtype), o32, lse


def backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   do: torch.Tensor, o32: torch.Tensor, lse: torch.Tensor,
                   scale: float) -> tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """:func:`backward_dq` and :func:`backward_dkdv` in float32 PyTorch:
    P = exp(S - LSE), D = rowsum(dO * o32), dS = P (dO V^T - D), dq =
    scale dS K, dk = scale dS^T Q, dv = P^T dO."""
    dof = do.float()
    p = torch.exp(_scores(q, k, scale) - lse[..., None])
    delta = (dof * o32).sum(-1).transpose(1, 2)               # (B, H, S)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashTrain(torch.autograd.Function):
    """o = causal softmax(scale q k^T) v, its backward FlashAttention-2's:
    the kernels on a CUDA tensor, the plain versions on the CPU. Saves q,
    k, v (as the kernels read them), o32 and the log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        q, k, v = (ready(t) if t.is_cuda else t for t in (q, k, v))
        run = forward if q.is_cuda else forward_plain
        o, o32, lse = run(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o32, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o32, lse = ctx.saved_tensors
        if not q.is_cuda:
            return (*backward_plain(q, k, v, do, o32, lse, ctx.scale), None)
        do = ready(do)
        dq, delta = backward_dq(q, k, v, do, o32, lse, ctx.scale)
        dk, dv = backward_dkdv(q, k, v, do, lse, delta, ctx.scale)
        return dq, dk, dv, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> torch.Tensor:
    """Causal self-attention o (B, S, H, D_V) of q, k (B, S, H, D_QK) and
    v (B, S, H, D_V) through :class:`FlashTrain`."""
    return FlashTrain.apply(q, k, v, scale)
