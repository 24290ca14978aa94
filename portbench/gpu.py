"""The device side of a run: draining, the device record of the result,
the L2 flush, and the reading of ``torch.profiler`` traces. On the CPU
(the tests) the helpers time by the host clock and read no trace.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import tempfile
import time

import torch

# Written before a replay that must find the 50 MB L2 cold, as
# chip_smoke.py:time_cuda flushes it.
FLUSH_BYTES = 128 * 1024 * 1024
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
GAPS_NAMED = 200


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def power_limit_w() -> float | None:
    """The card's power limit from ``nvidia-smi`` (None without it)."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    out = subprocess.run([smi, "--query-gpu=power.limit",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=30)
    try:
        return float(out.stdout.split()[0])
    except (IndexError, ValueError):
        return None


def device_record(device, count: int = 1,
                  peak_bytes: int | None = None) -> dict:
    """The result's ``device``: platform, the card's name, the cards
    used and the peak of the fullest (``peak_bytes`` when the caller
    collected it over several processes)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev)
                                     if peak_bytes is None else peak_bytes),
            "power_limit_w": power_limit_w()}


class Profile:
    """A ``torch.profiler`` session between :meth:`start` and :meth:`stop`
    (or around a ``with`` block) of the device's activity and the CUDA
    calls the host makes; the host's operators are not traced, which
    would slow a step of many small launches by a quarter and show the
    card idle where it is not. :meth:`stop` returns
    ``{"events": the Chrome trace's events, "window_s": host seconds
    between the two, drained on both sides}``. On the CPU nothing is
    traced and ``events`` is empty."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.result: dict = {"events": [], "window_s": 0.0}
        self._prof = None
        self.running = False

    def start(self) -> None:
        self.running = True
        sync(self.device)
        if self.device.type == "cuda":
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> dict:
        self.running = False
        sync(self.device)
        self.result["window_s"] = time.perf_counter() - self._t0
        if self._prof is not None:
            self._prof.stop()
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                self._prof.export_chrome_trace(path)
                with open(path) as f:
                    self.result["events"] = json.load(f)["traceEvents"]
            self._prof = None
        return self.result

    def __enter__(self) -> dict:
        self.start()
        return self.result

    def __exit__(self, *exc) -> None:
        self.stop()


def device_events(events: list) -> list[dict]:
    """The device's operations (kernels, copies, sets), by start."""
    return sorted((e for e in events if e.get("cat") in DEVICE_CATS
                   and "dur" in e), key=lambda e: e["ts"])


def busy_intervals(dev_events: list) -> list[tuple[float, float]]:
    """The union of the device operations' [start, end) in µs."""
    out: list[list[float]] = []
    for e in dev_events:
        lo, hi = e["ts"], e["ts"] + e["dur"]
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def clusters(dev_events: list, gap_us: float) -> list[list[dict]]:
    """The device operations split where the device idles longer than
    ``gap_us``: one cluster per burst of work (a replay, a step)."""
    out: list[list[dict]] = []
    end = None
    for e in dev_events:
        if end is None or e["ts"] - end > gap_us:
            out.append([])
        out[-1].append(e)
        end = e["ts"] + e["dur"] if end is None else max(
            end, e["ts"] + e["dur"])
    return out


def _host_at(host: list[dict], t: float) -> str:
    """The innermost host operation running at ``t`` (µs)."""
    best, best_dur = "host idle", float("inf")
    for e in host:
        if e["ts"] <= t <= e["ts"] + e["dur"] and e["dur"] < best_dur:
            best, best_dur = e["name"], e["dur"]
    return best


def summarize(events: list, window_s: float, top: int = 10) -> dict:
    """From one profiled stretch: ``busy_s`` (the seconds in which an
    operation ran on the device), ``window_s``, the device operations
    that took most time and the longest idle gaps (the
    :data:`GAPS_NAMED` longest), summed by what the host was doing when
    each began (``breakdown``)."""
    dev = device_events(events)
    busy = busy_intervals(dev)
    busy_s = sum(hi - lo for lo, hi in busy) / 1e6
    by_op: dict[str, float] = {}
    for e in dev:
        by_op[e["name"]] = by_op.get(e["name"], 0.0) + e["dur"] / 1e6
    host = [e for e in events if e.get("ph") == "X" and "dur" in e and
            e.get("cat") in ("cpu_op", "user_annotation", "cuda_runtime",
                             "cuda_driver", "python_function")]
    # The longest gaps (at most GAPS_NAMED of them) named by the host's
    # innermost operation at their start, summed by name.
    idle = sorted(((start - end, end) for (_, end), (start, _)
                   in zip(busy, busy[1:])), reverse=True)[:GAPS_NAMED]
    gaps: dict[str, float] = {}
    for length, end in idle:
        name = _host_at(host, end + 1.0)
        gaps[name] = gaps.get(name, 0.0) + length / 1e6

    def largest(d: dict) -> list:
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                ][:top]

    return {"busy_s": busy_s, "window_s": window_s,
            "breakdown": {"device_ops": largest(by_op),
                          "idle_gaps": largest(gaps)}}
