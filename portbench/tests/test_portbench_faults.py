"""Each cell's run, its look for a card skipped, at a size the CPU
holds: sound, it reads correct; with the timed path broken underneath,
once for each fault the cell can have, it reads not correct."""
from __future__ import annotations

import contextlib
import os
import textwrap

import pytest
import torch

from portbench import control
from portbench.tests.tiny import run_tiny, tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("portbench"))


# -- the search cell: one process, faults planted in the program's ops --------

def _spmv_fault(name: str):
    from repro_torch.spmv.distributed import DistributedSpmv as D

    orig = {k: getattr(D, k) for k in ("multiply_local", "multiply_remote",
                                       "post_send")}

    def stale(self, halo):                  # yR returned as it was
        return self.yR

    def half(self, x):                      # half of the rows left out
        out = orig["multiply_local"](self, x)
        out[out.numel() // 2:] = 0.0
        return out

    def no_exchange(self, sendbuf):         # the halo never sent
        return None

    def altered(self, x):                   # one answer altered
        out = orig["multiply_local"](self, x)
        out[3] += 1.0
        return out

    return {"stale_state": ("multiply_remote", stale),
            "half_batch": ("multiply_local", half),
            "no_exchange": ("post_send", no_exchange),
            "altered_answer": ("multiply_local", altered)}[name]


@contextlib.contextmanager
def planted(owner, attr, fn):
    orig = getattr(owner, attr)
    setattr(owner, attr, fn)
    try:
        yield
    finally:
        setattr(owner, attr, orig)


def test_search_cell_reads_correct_when_sound(root):
    line = run_tiny(root, "spmv-paper.search-graph", seconds=0.5)
    assert line["correct"] is True, line.get("error")
    assert line["checks"]["y_gap"]["value"] < 1e-6
    assert set(line["metrics"]) == {"candidates_per_s", "rank_rho",
                                    "step_us", "setup_s"}


@pytest.mark.parametrize("fault", ["stale_state", "half_batch",
                                   "no_exchange", "altered_answer"])
def test_search_cell_reads_not_correct_with_a_fault(root, fault):
    from repro_torch.spmv.distributed import DistributedSpmv

    attr, fn = _spmv_fault(fault)
    with planted(DistributedSpmv, attr, fn):
        line = run_tiny(root, "spmv-paper.search-graph", seconds=0.5)
    assert line["correct"] is False
    # The program's gate holds every design to a canonical schedule run
    # by the same broken ops (NaN equal to NaN): only the reference sees.
    assert "error" not in line
    check = line["checks"]["y_gap"]
    assert not check["value"] <= check["limit"]


# -- the train cell: faults planted under the program's step -----------------

def _unchanged():
    from repro_torch.optim.adamw import AdamW

    return planted(AdamW, "step",
                   lambda self, grads, state, params: (params, state))


def _half_batch():
    from repro_torch.models.model import LM

    loss = LM.loss

    def half(self, batch, **kw):
        return loss(self, control.half_labels(batch), **kw)

    return planted(LM, "loss", half)


TRAIN_FAULTS = {"stale_state": _unchanged, "half_batch": _half_batch,
                "altered_answer": lambda: control.doubled_gradient(
                    "decoder.0.mlp.experts.wi")}


@pytest.mark.parametrize("seed", [6, 7])
def test_train_cell_reads_correct_when_sound(root, seed):
    line = run_tiny(root, "deepseek-moe-16b.train-4k", seed=seed,
                    seconds=0.5)
    assert line["correct"] is True, line["checks"]


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_train_cell_reads_not_correct_with_a_fault(root, fault):
    with TRAIN_FAULTS[fault]():
        line = run_tiny(root, "deepseek-moe-16b.train-4k", seed=6,
                        seconds=0.5)
    assert line["correct"] is False, line["checks"]


# -- the rank cell: four gloo processes, faults planted at their start --------

RANK_FAULTS = {
    "stale_state": "d._sliced_product = lambda a, x, out, use_kernel=True: out",
    "half_batch": """
        def half(a, x, out, use_kernel=True):
            out = orig(a, x, out, use_kernel)
            out[out.numel() // 2:] = 0.0
            return out
        d._sliced_product = half""",
    "no_exchange": """
        def none(x_block, group=None, out=None):
            return out, []
        d.halo_exchange = none""",
    "altered_answer": """
        def altered(a, x, out, use_kernel=True):
            out = orig(a, x, out, use_kernel)
            out[2] += 1.0
            return out
        d._sliced_product = altered"""}


def _rank_run(root, tmp_path, monkeypatch, fault=None):
    if fault is not None:
        site = tmp_path / "site"
        site.mkdir()
        (site / "sitecustomize.py").write_text(
            "import repro_torch.spmv.distributed as d\n"
            "orig = d._sliced_product\n" +
            textwrap.dedent(RANK_FAULTS[fault]) + "\n")
        monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
            [str(site), os.environ.get("PYTHONPATH", "")]))
    return run_tiny(root, "spmv-paper.rank4-nccl", seconds=0.3)


def test_rank_cell_reads_correct_when_sound(root, tmp_path, monkeypatch):
    line = _rank_run(root, tmp_path, monkeypatch)
    assert line["correct"] is True, line.get("error")
    assert line["device"]["count"] == 4


@pytest.mark.parametrize("fault", sorted(RANK_FAULTS))
def test_rank_cell_reads_not_correct_with_a_fault(root, tmp_path,
                                                  monkeypatch, fault):
    line = _rank_run(root, tmp_path, monkeypatch, fault)
    assert line["correct"] is False
    # The ranks ran to the end and their y failed the comparison.
    assert "error" not in line
    check = line["checks"]["y_gap"]
    assert not check["value"] <= check["limit"]


def test_faults_restore_the_program():
    from repro_torch.optim.adamw import AdamW

    step = AdamW.step
    with _unchanged():
        assert AdamW.step is not step
    assert AdamW.step is step
    assert torch.get_num_threads() >= 1


def test_rank_cell_survives_ranks_that_write_much(root, tmp_path,
                                                  monkeypatch):
    """A rank that writes more than a pipe holds (NCCL_DEBUG=INFO does)
    must not stop: its output goes to a file."""
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(
        "import sys\nsys.stderr.write('x' * 300_000 + '\\n')\n")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(site), os.environ.get("PYTHONPATH", "")]))
    line = run_tiny(root, "spmv-paper.rank4-nccl", seconds=0.3)
    assert line["correct"] is True, line.get("error")
