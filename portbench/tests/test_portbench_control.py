"""Each cell's control, the plain reference computed in the precision
below the configuration's, fails the cell's comparison: here at a size
the CPU holds (``control.py`` reads it on the card at the cell's own)."""
from __future__ import annotations

import pytest
import torch

from portbench import control, harness
from portbench.tests.tiny import tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny_root(tmp_path_factory.mktemp("portbench"))


@pytest.mark.parametrize("cell", ["spmv-paper.search-graph",
                                  "spmv-paper.rank4-nccl"])
@pytest.mark.parametrize("seed", [3, 4, 2**31 + 9])
def test_spmv_control_fails_the_limit(root, cell, seed):
    c = harness.load_cell(cell, root)
    got = control.spmv_control(c.config, seed, "cpu")
    limit = c.traffic["y_gap_limit"]
    assert got["y_gap"] > 30 * limit
    assert got["y_gap_by_rank"] > 30 * limit


@pytest.mark.parametrize("seed", [6, 7])
def test_train_control_fails_a_limit_the_program_meets(root, seed):
    cell = harness.load_cell("deepseek-moe-16b.train-4k", root)
    ctx = harness.Context(cell, seed, 0.0, False, device="cpu", root=root)
    got = control.train_readings(ctx, seed, "cpu", faults={})
    limits = {k: cell.traffic[f"{k}_limit"] for k in got["program"]
              if f"{k}_limit" in cell.traffic}
    assert set(limits) == {"grad_norm_gap", "grad_median_gap",
                           "change_norm_gap"}
    assert all(got["program"][k] <= lim for k, lim in limits.items()), got
    assert any(got["control"][k] > lim for k, lim in limits.items()), got
