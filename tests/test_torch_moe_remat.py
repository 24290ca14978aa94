"""The layer checkpoint of a MoE layer with shared experts, on the CPU.

A checkpointed layer's recomputation (non-reentrant) runs the layer's
forward again until the tensors its backward saved are rebuilt. The
layer ends in two products, the routed experts' combine and the shared
experts' output projection, and the backward reads neither's output:
XLA's program drops both from its recomputation, and so must the port
(the routed combine is the last op that saves a tensor, and the shared
projection's output is kept from the forward, ``layers.kept``). This
holds for both dispatches, and the checkpoint changes no value.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint, noop_context_fn

from repro_torch.configs import get_reduced
from repro_torch.models.layers import keep_context, kept
from repro_torch.models.model import LM

B, S = 2, 96
DISPATCHES = ["einsum", "gather"]
aten = torch.ops.aten


def _config(dispatch: str, remat: bool = True):
    cfg = get_reduced("deepseek-moe-16b")
    return dataclasses.replace(cfg, remat=remat, moe=dataclasses.replace(
        cfg.moe, dispatch=dispatch))


def moe_product_runs(model, batch) -> dict:
    """How often each MoE layer's two final products run in one
    plain-route loss and in its backward: the routed experts' combine
    (the einsum dispatch's (B, S, E*C) x (B, E*C, d) product, the gather
    dispatch's scatter-add of the weighted slots to their tokens) and
    the shared experts' output projection, (B*S, d_shared) x (d_shared,
    d); and, to show that the count sees the layer checkpoint's
    recomputation, the routed experts' input products (wi and wg, (E,
    B*C, d) x (E, d, d_expert)). A dispatch mode counts each when it
    runs with grad enabled: a forward op or one the recomputation runs
    again (a gradient's own products run without; the dispatch's input
    gradient has the combine's signature, the shared experts' input
    gradient the projection's)."""
    from repro_torch.models.moe import _capacity

    cfg = model.cfg
    mc = cfg.moe
    ec = mc.n_experts * _capacity(batch["tokens"].shape[1], mc)
    shared = (mc.d_expert * mc.n_shared, cfg.d_model)
    seen = {what: {"forward": 0, "backward": 0}
            for what in ("combine", "shared_out", "experts_in")}
    where = ["forward"]

    def what(packet, args):
        if packet in (aten.scatter_add, aten.scatter_add_):
            return "combine"
        if packet is aten.mm and tuple(args[1].shape) == shared:
            return "shared_out"
        if packet is aten.bmm:
            if args[0].shape[-1] == ec and \
                    tuple(args[1].shape[-2:]) == (ec, cfg.d_model):
                return "combine"
            if tuple(args[1].shape[-2:]) == (cfg.d_model, mc.d_expert):
                return "experts_in"
        return None

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kind = what(func._overloadpacket, args)
            if kind is not None and torch.is_grad_enabled():
                seen[kind][where[0]] += 1
            return func(*args, **(kwargs or {}))

    with Count():
        loss, _ = model.loss(batch, attention="plain")
        where[0] = "backward"
        torch.autograd.grad(loss, list(model.parameters()))
    return dict(seen, moe_layers=sum(d.moe for d in model.descs),
                shared_experts=mc.n_shared)


def moe_product_faults(runs: dict) -> list[str]:
    """What ``moe_product_runs`` saw that it should not have: each
    final product other than once per MoE layer in the forward or at all
    in the backward (the shared projection only where there are shared
    experts), the experts' input products not recomputed."""
    n = runs["moe_layers"]
    want = {"combine": {"forward": n, "backward": 0},
            "shared_out": {"forward": n if runs["shared_experts"] else 0,
                           "backward": 0},
            "experts_in": {"forward": 2 * n, "backward": 2 * n}}
    return [f"{k} ran {runs[k]}, not {v}" for k, v in want.items()
            if runs[k] != v]


def _batch(vocab: int) -> dict:
    ids = np.random.default_rng(27).integers(0, vocab, size=(B, S + 1))
    return {"tokens": torch.as_tensor(ids[:, :-1], dtype=torch.int32),
            "labels": torch.as_tensor(ids[:, 1:], dtype=torch.int32)}


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_recomputation_runs_neither_final_product(dispatch):
    """Each MoE layer's two final products run once in the forward and
    not in the backward; the experts' input products run again in the
    recomputation."""
    cfg = _config(dispatch)
    model = LM(cfg, device="cpu", seed=0).requires_grad_(True)
    runs = moe_product_runs(model, _batch(cfg.vocab))
    assert runs == {"combine": {"forward": 2, "backward": 0},
                    "shared_out": {"forward": 2, "backward": 0},
                    # The recomputation runs and the count sees it.
                    "experts_in": {"forward": 4, "backward": 4},
                    "moe_layers": 2, "shared_experts": 1}
    assert moe_product_faults(runs) == []


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_layer_checkpoint_changes_no_value(dispatch):
    batch = _batch(get_reduced("deepseek-moe-16b").vocab)
    out = {}
    for remat in (True, False):
        model = LM(_config(dispatch, remat), device="cpu",
                   seed=0).requires_grad_(True)
        params = dict(model.named_parameters())
        loss, parts = model.loss(batch, attention="plain")
        grads = torch.autograd.grad(loss, list(params.values()))
        out[remat] = (loss, parts, dict(zip(params, grads)), params)
    (loss_r, parts_r, g_r, p_r), (loss_n, parts_n, g_n, p_n) = \
        out[True], out[False]
    assert all(torch.equal(p_r[k], p_n[k]) for k in p_n)
    assert torch.equal(loss_r, loss_n)
    assert all(torch.equal(parts_r[k], parts_n[k]) for k in parts_n)
    assert g_r.keys() == g_n.keys()
    for name in g_n:
        assert torch.equal(g_r[name], g_n[name]), name


@pytest.mark.parametrize("context, recomputed", [(keep_context, 1),
                                                 (noop_context_fn, 2)])
def test_keep_context_replays_only_what_kept_returns(context, recomputed):
    """Two chained products, the second through ``kept``: with
    ``keep_context`` the recomputation runs only the first (the second's
    output comes from the forward); without it, ``kept`` changes
    nothing. The gradients equal the unchecked function's."""
    gen = torch.Generator().manual_seed(5)
    x, w1, w2 = (torch.randn(*shape, generator=gen, requires_grad=True)
                 for shape in ((6, 8), (8, 8), (8, 4)))

    def f(x, w1, w2):
        h = torch.tanh(x @ w1)
        y = kept(lambda h: h @ w2, h)
        return torch.sigmoid(y).sum()

    runs = {"forward": 0, "backward": 0}
    phase = ["forward"]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is aten.mm.default and torch.is_grad_enabled():
                runs[phase[0]] += 1
            return func(*args, **(kwargs or {}))

    with Count():
        out = checkpoint(f, x, w1, w2, use_reentrant=False,
                         context_fn=context)
        phase[0] = "backward"
        grads = torch.autograd.grad(out, (x, w1, w2))
    want = torch.autograd.grad(f(x, w1, w2), (x, w1, w2))
    assert runs == {"forward": 2, "backward": recomputed}
    assert all(torch.equal(g, w) for g, w in zip(grads, want))
