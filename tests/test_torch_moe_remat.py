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


def _batch(vocab: int) -> dict:
    ids = np.random.default_rng(27).integers(0, vocab, size=(B, S + 1))
    return {"tokens": torch.as_tensor(ids[:, :-1], dtype=torch.int32),
            "labels": torch.as_tensor(ids[:, 1:], dtype=torch.int32)}


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_recomputation_runs_neither_final_product(dispatch):
    """``chip_smoke.py``'s count of the MoE layers' products, as its
    train_families phase gates it on the card."""
    from chip_smoke import moe_product_faults, moe_product_runs

    cfg = _config(dispatch)
    model = LM(cfg, device="cpu", seed=0).requires_grad_(True)
    runs = moe_product_runs(model, _batch(cfg.vocab), None)
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
