"""The frozen arithmetic and inputs hold today's values and the
program's own at this commit."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from portbench import inputs
from portbench.metrics import _yardstick as Y

PAPER = {"n": 150_000, "nnz": 1_500_000, "half_bandwidth": 37_500}


@pytest.fixture(scope="module")
def paper_parts():
    vals, cols = inputs.band_matrix(**PAPER, seed=0)
    return Y.spmv_parts(vals, cols, 4)


def test_peaks_are_the_data_sheet_and_the_programs():
    from repro_torch.launch import costs

    assert (Y.BF16_FLOPS, Y.F32_FLOPS, Y.HBM_BYTES, Y.NVLINK_BYTES) == \
        (989e12, 67e12, 3.35e12, 450e9)
    assert (costs.PEAK_FLOPS, costs.HBM_BW, costs.LINK_BW) == \
        (Y.BF16_FLOPS, Y.HBM_BYTES, Y.NVLINK_BYTES)


def test_kernel_bounds_at_the_papers_size(paper_parts):
    p = paper_parts
    assert p["nnz_local"] + p["nnz_remote"] == PAPER["nnz"]
    ell_us = Y.bound_s(Y.ell_spmv_bytes(p), Y.ell_spmv_flops(p)) * 1e6
    assert round(ell_us, 2) == 4.41
    assert round(Y.bound_s(Y.pack_bytes(p["n"]), 0.0) * 1e6, 2) == 0.54
    step_us = Y.bound_s(Y.step_bytes(p), Y.ell_spmv_flops(p)) * 1e6
    assert round(step_us, 2) == 4.30


def test_spmv_parts_count_what_the_programs_partition_holds():
    from repro_torch.spmv.matrix import EllMatrix, partition

    n, ranks = 4096, 4
    vals, cols = inputs.band_matrix(n, 40_960, n // 4, seed=3)
    p = Y.spmv_parts(vals, cols, ranks)
    parts = partition(EllMatrix(vals, cols, n), ranks)
    assert p["nnz_local"] == sum(int((q.local.vals != 0).sum())
                                 for q in parts)
    assert p["nnz_remote"] == sum(int((q.remote.vals != 0).sum())
                                  for q in parts)
    m = n // ranks
    local = {int(c) + q.rank * m for q in parts
             for c in q.local.cols[q.local.vals != 0]}
    halo = {int(c) + q.rank * 2 * m for q in parts
            for c in q.remote.cols[q.remote.vals != 0]}
    assert (p["x_local"], p["halo_remote"]) == (len(local), len(halo))


def test_the_band_matrix_is_a_frozen_copy_of_the_programs():
    from repro_torch.spmv.matrix import band_matrix

    vals, cols = inputs.band_matrix(2048, 20_000, 512, seed=11)
    theirs = band_matrix(2048, 20_000, 512,
                         seed=inputs.child_seed(11, 1))
    assert np.array_equal(vals, theirs.vals)
    assert np.array_equal(cols, theirs.cols)


@pytest.mark.parametrize("layers", [1, 4, 28])
def test_model_flops_are_the_programs_at_this_commit(layers):
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch.costs import model_flops

    cfg = dataclasses.replace(get_config("deepseek-moe-16b"),
                              n_layers=layers)
    c = {"layers": layers, "d_model": 2048, "heads": 16, "kv_heads": 16,
         "head_dim": 128, "vocab": 102_400, "d_expert": 1408,
         "experts": 64, "top_k": 6, "shared": 2}
    cell = SHAPES["train_4k"]
    want = model_flops(cfg, "train_4k") / cell.global_batch
    assert Y.model_flops(c, 1, cell.seq_len) == pytest.approx(want,
                                                              rel=1e-12)
    total, active = Y.moe_param_counts(c)
    assert (total, active) == (cfg.param_count(), cfg.active_param_count())


def test_child_seeds_take_seeds_past_32_bits():
    a = inputs.child_seed(2**31 + 5, 1)
    assert a == inputs.child_seed(2**31 + 5, 1) != inputs.child_seed(
        2**31 + 6, 1)
    assert 0 <= a < 2**63
    x = inputs.vectors(16, 2, 2**33 + 1)
    assert x.shape == (2, 16) and x.dtype == np.float32
