"""The plain references against float64 at small sizes, and against
the program in the program's float32 mode (the same mathematics)."""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from portbench import inputs
from portbench.harness import HERE, load_module
from portbench.reference import moe_lm, spmv

CFG = json.loads((HERE / "configs" / "deepseek-moe-16b.json").read_text())
SMALL = {"num_hidden_layers": 2, "hidden_size": 64,
         "num_attention_heads": 4, "num_key_value_heads": 4,
         "moe_intermediate_size": 32, "n_routed_experts": 8,
         "num_experts_per_tok": 2, "n_shared_experts": 1,
         "vocab_size": 2048}


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def small(**over):
    c = {**CFG, **SMALL, **over}
    s = moe_lm.sizes(c)
    shapes = moe_lm.leaf_shapes(s)
    return c, s, shapes, moe_lm.leaf_scales(shapes)


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 3])
def test_spmv_reference_against_the_dense_product(seed):
    n = 512
    vals, cols = inputs.band_matrix(n, 4096, 128, seed)
    dense = np.zeros((n, n))
    for i in range(n):
        np.add.at(dense[i], cols[i], vals[i].astype(np.float64))
    x = inputs.vectors(n, 1, seed)[0]
    want = dense @ x.astype(np.float64)
    assert np.allclose(spmv.matvec(vals, cols, x), want, rtol=0,
                       atol=1e-12 * np.abs(want).max())
    rows = slice(128, 256)
    assert np.array_equal(spmv.matvec(vals, cols, x, rows),
                          spmv.matvec(vals, cols, x)[rows])
    gap = spmv.rel_gap(spmv.matvec_bf16(vals, cols, x), want)
    assert 1e-4 < gap < 3e-2


def test_rel_gap_reads_infinite_where_y_is_not_finite_or_misshaped():
    y = np.ones(4)
    assert spmv.rel_gap(y, y) == 0.0
    assert spmv.rel_gap(np.array([1, np.nan, 1, 1.0]), y) == float("inf")
    assert spmv.rel_gap(np.ones(3), y) == float("inf")


def _batch(seed, s, seq=32, batch=2):
    return inputs.TokenStream(seed, batch, seq, s["vocab"], "cpu").next()


def test_moe_reference_float32_against_float64():
    c, s, shapes, scales = small()
    _, p32 = inputs.draw_weights(shapes, scales, 5, "cpu")
    p64 = {k: v.double().requires_grad_(True) for k, v in p32.items()}
    p32 = {k: v.clone().requires_grad_(True) for k, v in p32.items()}
    batch = _batch(5, s)
    l32, _ = moe_lm.loss(p32, batch, s)
    l64, _ = moe_lm.loss(p64, batch, s)
    assert float(l32.detach()) == pytest.approx(float(l64.detach()),
                                                rel=1e-6)
    g32 = torch.autograd.grad(l32, list(p32.values()))
    g64 = torch.autograd.grad(l64, list(p64.values()))
    for a, b in zip(g32, g64):
        assert torch.allclose(a.double(), b, rtol=0,
                              atol=1e-4 * float(b.abs().max()) + 1e-12)


def test_moe_reference_is_the_programs_mathematics_in_float32():
    """The program's step with float32 activations against the reference:
    the first step's loss, and each leaf's first gradient and change."""
    drv = load_module(HERE / "drivers" / "train_step.py", "drv_ref_test")
    from repro_torch.models.model import LM

    c, s, shapes, scales = small()
    t = {"batch": 2, "seq": 32, "checked_steps": 2}
    cfg = dataclasses.replace(drv.port_config(c), dtype="float32")
    orig = drv.port_config
    drv.port_config = lambda _c: cfg
    try:
        prog = drv.Program(c, shapes, scales, 9, "cpu")
    finally:
        drv.port_config = orig
    assert isinstance(prog.model, LM)
    stream = inputs.TokenStream(9, t["batch"], t["seq"], s["vocab"], "cpu")
    got = drv.checked_steps(prog, stream, t, shapes, scales, 9, "cpu")
    want = drv.check_steps(9, t, s, shapes, scales, "cpu")
    r = drv.readings(got, want)
    assert r["loss_gap"] < 1e-5
    assert r["grad_norm_gap"] < 1e-4
    assert r["change_norm_gap"] < 1e-4


def test_adamw_reference_is_the_programs_optimizer():
    from repro_torch.optim.adamw import AdamW, warmup_cosine

    o = load_module(HERE / "drivers" / "train_step.py",
                    "drv_opt_test").OPTIMIZER
    g = torch.Generator().manual_seed(4)
    params = {f"p{i}": torch.randn(33, 7, generator=g) for i in range(3)}
    grads = [{k: torch.randn(33, 7, generator=g) * 3 for k in params}
             for _ in range(3)]
    opt = AdamW(learning_rate=warmup_cosine(o["peak_lr"], o["warmup"],
                                            o["total"], o["final_frac"]),
                b1=o["b1"], b2=o["b2"], eps=o["eps"],
                weight_decay=o["weight_decay"], grad_clip_norm=o["clip"])
    mine = {k: v.clone() for k, v in params.items()}
    theirs = {k: v.clone() for k, v in params.items()}
    state = opt.init(theirs)
    ref_state = {"mu": {}, "nu": {}, "count": 0}
    for step in grads:
        opt.step(step, state, theirs)
        moe_lm.adamw(mine, step, ref_state, o)
    for k in params:
        assert torch.allclose(mine[k], theirs[k], rtol=1e-6, atol=1e-7)
        assert not torch.equal(mine[k], params[k])


def test_fp8_products_round_both_operands():
    g = torch.Generator().manual_seed(8)
    a = torch.randn(8, 16, generator=g)
    b = torch.randn(16, 4, generator=g)
    exact = a @ b
    low = moe_lm.matmul(a, b, "fp8")
    gap = float((low - exact).abs().max() / exact.abs().max())
    assert 1e-3 < gap < 0.2
    assert torch.equal(moe_lm.matmul(a, b, "float32"), exact)
