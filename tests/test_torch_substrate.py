"""The reference's substrate tests (tests/test_substrate.py: checkpoint,
restart, training, stragglers) on the port's ``checkpoint``, ``ft``,
``train`` and ``launch/train.py``, on the CPU; and a checkpoint
directory written by either package restored by the other."""
import contextlib
import io
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")

from repro.checkpoint.store import CheckpointStore as RStore  # noqa: E402
from repro_torch.checkpoint.store import CheckpointStore  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.data.pipeline import DataConfig, batch_for  # noqa: E402
from repro_torch.ft.restart import LoopConfig, TrainLoop  # noqa: E402
from repro_torch.ft.straggler import StragglerMonitor  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402


def state():
    return {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "nested": {"b": np.asarray(3), "t": torch.arange(4.0)},
            "seq": [np.ones(2, np.int32), torch.tensor(7)]}


# -- checkpoint -------------------------------------------------------------------

def test_checkpoint_roundtrip_and_gc(tmp_path):
    store = CheckpointStore(tmp_path, keep_last=2)
    for s in (10, 20, 30):
        store.save(s, state(), extra_meta={"note": s})
    assert store.steps() == [20, 30]          # gc keeps the last 2
    assert store.latest_step() == 30 and store.meta(30)["note"] == 30
    step, out = store.restore(state())
    assert step == 30
    np.testing.assert_array_equal(out["a"], state()["a"])
    np.testing.assert_array_equal(out["nested"]["b"], 3)
    assert torch.equal(out["nested"]["t"], torch.arange(4.0))
    assert isinstance(out["seq"], list) and int(out["seq"][1]) == 7
    with pytest.raises(FileNotFoundError):
        CheckpointStore(tmp_path / "empty").restore(state())


def test_checkpoint_async_then_wait_copies_before_returning(tmp_path):
    store = CheckpointStore(tmp_path)
    x = torch.ones(4, dtype=torch.bfloat16)
    store.save(1, {"x": x}, blocking=False)
    x.add_(1)                       # in place, while the writer may run
    store.wait()
    assert store.latest_step() == 1
    _, out = store.restore({"x": x})
    assert out["x"].dtype == torch.bfloat16
    assert torch.equal(out["x"], torch.ones(4, dtype=torch.bfloat16))


def test_a_directory_reads_across_packages(tmp_path):
    """The reference's store restores the port's files and the port's
    the reference's: the same npz keys, LATEST and meta.json."""
    ref_state = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
                 "nested": {"b": np.asarray(3, np.int32),
                            "c": np.ones((2, 2), np.float32)}}
    RStore(tmp_path / "r").save(5, ref_state)
    step, got = CheckpointStore(tmp_path / "r").restore(
        {"a": torch.zeros(2, 3), "nested": {"b": np.asarray(0, np.int32),
                                            "c": torch.zeros(2, 2)}})
    assert step == 5
    assert torch.equal(got["a"], torch.from_numpy(ref_state["a"]))
    assert int(got["nested"]["b"]) == 3
    CheckpointStore(tmp_path / "p").save(
        6, {"a": torch.from_numpy(ref_state["a"]),
            "nested": {"b": torch.tensor(3, dtype=torch.int32),
                       "c": torch.ones(2, 2)}})
    step, back = RStore(tmp_path / "p").restore(ref_state)
    assert step == 6
    for a, b in ((back["a"], ref_state["a"]),
                 (back["nested"]["c"], ref_state["nested"]["c"])):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert int(back["nested"]["b"]) == 3


# -- training -----------------------------------------------------------------------

def smollm():
    cfg = get_reduced("smollm-360m")
    return cfg, LM(cfg, device="cpu", seed=0)


def test_loss_decreases_under_training():
    cfg, m = smollm()
    opt = AdamW(learning_rate=3e-3)
    params = dict(m.named_parameters())
    ostate = opt.init(params)
    dcfg = DataConfig(seq_len=32, global_batch=4, vocab=cfg.vocab)
    step = make_train_step(m, opt)
    losses = []
    for s in range(12):
        params, ostate, metrics = step(params, ostate,
                                       batch_for(dcfg, s % 2, cfg))
        losses.append(float(metrics["loss"]))
    assert all(math.isfinite(x) for x in losses)
    assert min(losses[-4:]) < losses[0]


def test_restart_is_bit_exact(tmp_path):
    cfg, m = smollm()
    opt = AdamW(learning_rate=1e-3)
    start = {k: v.detach().clone() for k, v in m.named_parameters()}

    def fresh():
        p = {k: v.clone() for k, v in start.items()}
        return p, opt.init(p)

    step = make_train_step(m, opt)
    dcfg = DataConfig(seq_len=16, global_batch=4, vocab=cfg.vocab)

    def bf(s):
        return batch_for(dcfg, s, cfg)

    loop = TrainLoop(step, bf, CheckpointStore(tmp_path / "a"),
                     LoopConfig(total_steps=8, ckpt_every=3))
    with pytest.raises(RuntimeError, match="injected failure"):
        loop.run(*fresh(), fail_at=5)
    assert loop.store.latest_step() == 3
    p1, o1 = loop.resume(*fresh())
    p1 = {k: v.detach().clone() for k, v in p1.items()}
    ref = TrainLoop(step, bf, CheckpointStore(tmp_path / "b"),
                    LoopConfig(total_steps=8, ckpt_every=100))
    p2, o2 = ref.run(*fresh())
    assert int(o1["count"]) == int(o2["count"]) == 8
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k
    assert [h["loss"] for h in loop.history][-1] == \
        [h["loss"] for h in ref.history][-1]


# -- stragglers -----------------------------------------------------------------------

def test_straggler_monitor_flags_slow_rank():
    mon = StragglerMonitor(threshold=1.5, min_observations=3)
    for step in range(6):
        for rank in range(8):
            mon.record(rank, step, 0.1 if rank != 5 else 0.25)
    rep = mon.report()
    assert rep is not None
    assert list(rep.slow_ranks) == [5]


def test_straggler_monitor_quiet_when_uniform():
    mon = StragglerMonitor(min_observations=3)
    for step in range(5):
        for rank in range(4):
            mon.record(rank, step, 0.1)
    assert mon.report() is None


# -- the launcher -----------------------------------------------------------------------

def test_launch_train_on_the_cpu_prints_every_loss(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        hist = launch_train.main(["--arch", "smollm-360m", "--steps", "3",
                                  "--device", "cpu", "--batch", "2",
                                  "--seq", "16", "--ckpt-dir",
                                  str(tmp_path)])
    lines = [ln for ln in out.getvalue().splitlines() if "loss" in ln]
    assert len(lines) == 3 and [h["step"] for h in hist] == [1, 2, 3]
    assert all(math.isfinite(float(ln.split()[-1])) for ln in lines)
    assert CheckpointStore(tmp_path).latest_step() == 3


def test_launch_train_refuses_what_it_cannot_run(monkeypatch):
    # Item 9 is ported: --dry-run runs the train cell's dry run, here at
    # the reduced config on a 2x4 mesh over a fake process group.
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2.5-32b", "--dry-run", "--reduced", "--mesh", "2x4"],
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[OK] local2x4 qwen2.5-32b x train_4k:" in out.stdout
    # Every config trains (tests/test_torch_train_families.py); a name
    # that is none of them is refused.
    with pytest.raises(KeyError, match="no-such-arch"):
        launch_train.main(["--arch", "no-such-arch", "--device", "cpu",
                           "--steps", "1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", "smollm-360m", "--steps", "1"])
