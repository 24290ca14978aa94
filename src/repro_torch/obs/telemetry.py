"""The telemetry core: spans, counters, gauges, and the registry.

Search rounds, evaluator batches, store traffic and distillation
stages all report to :class:`Telemetry`, the one process-wide
registry:

* **Spans** — hierarchical begin/end intervals on the monotonic clock
  (``with obs.span("driver.round", round=i) as sp: ...``), nested via a
  thread-local stack, with arbitrary key/value attributes attached at
  open time or later through :meth:`Span.set`. Each span has an id and
  its parent's id (the span open around it on its thread), carried in
  its begin and end events as ``span_id`` and ``parent_id``. Finished
  spans stream to every attached exporter (:mod:`repro_torch.obs.
  exporters`) and fold into a per-name aggregate (count, total and
  self seconds, device seconds) for :meth:`Telemetry.spans_by_name`
  and :meth:`Telemetry.summary`.
* **Device intervals** — ``obs.span(name, device=dev)`` on a CUDA
  device also records a CUDA event on the current stream at entry and
  at exit: the interval in which the device reached the two, which
  holds the device work issued inside the span. The events are read
  when the registry is (:meth:`Telemetry.spans_by_name`), never inside
  the span, so a device span adds no synchronisation to the code it
  wraps.
* **Counters / gauges** — typed named values (`counter("engine.misses")
  .add(n)`, ``gauge("driver.best").set(t)``); counter/gauge updates are
  also streamed as Chrome-trace ``"C"`` events so Perfetto renders them
  as tracks under the span timeline. A counter also takes a tensor
  (``counter("moe.dropped").add(mask.sum())``): it is added up where
  the tensor lives and read once, when the counter is, so that no
  ``.item()`` runs inside a step.

**One clock.** Timestamps are offsets from the registry's zero, in
microseconds; :attr:`Telemetry.epoch_us` is the Unix time of that zero,
so ``ts + epoch_us`` is a Unix time in µs that lines up with another
process's registry, and :meth:`Telemetry.trace_ts` puts ``ts`` on the
clock of a ``torch.profiler`` Chrome trace (Unix µs less the trace's
``baseTimeNanoseconds``), where a span encloses the host's calls and
operators that ran inside it.

**Telemetry is a pure observer.** Nothing in this module is ever read
back by the instrumented code: timestamps never feed RNGs, cache keys,
or tie-breaks, so a search with an exporter attached is byte-identical
to one without (tests/test_torch_obs.py). The *disabled* registry
(the process default) reduces every instrumentation point to one
attribute check plus a no-op singleton — well under 1% of a
discrete-event simulation — and records no CUDA event and adds up no
tensor, so instrumented hot paths cost nothing until someone attaches
a real :class:`Telemetry`.

Usage::

    from repro_torch import obs

    tel = obs.Telemetry(exporters=[obs.PerfettoExporter("out.json")])
    with obs.use(tel):                       # or obs.set_current(tel)
        run_search(...)
    tel.close()                              # flush exporters
    print(tel.summary())                     # human table

The JAX package's ``repro/obs/telemetry.py`` with its imports
rewritten, and the shared clock, span ids, self time, device intervals
and tensor counters added.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.obs.exporters import Exporter


class Counter:
    """Monotonically increasing named value (events, bytes, hits).

    :meth:`add` takes a number or a tensor; a tensor is added up where
    it lives (one small kernel on a card) and read into :attr:`value`
    only when the value is read."""

    __slots__ = ("name", "_value", "_pending", "_tel")

    def __init__(self, name: str, tel: "Telemetry"):
        self.name = name
        self._value = 0.0
        self._pending = None     # the tensors' sum not yet read
        self._tel = tel

    def add(self, n: "float | torch.Tensor" = 1.0) -> None:
        if hasattr(n, "detach"):
            import torch

            n = n.detach()
            with self._tel._lock:
                if self._pending is None:
                    self._pending = n.to(torch.float64, copy=True)
                else:
                    self._pending.add_(n)
            return
        self._value += n
        self._tel._emit_value(self.name, self._value)

    @property
    def value(self) -> float:
        with self._tel._lock:
            pending, self._pending = self._pending, None
        if pending is not None:
            self._value += float(pending.item())
            self._tel._emit_value(self.name, self._value)
        return self._value


class Gauge:
    """Last-write-wins named value (best-so-far, pool size)."""

    __slots__ = ("name", "value", "_tel")

    def __init__(self, name: str, tel: "Telemetry"):
        self.name = name
        self.value = 0.0
        self._tel = tel

    def set(self, v: float) -> None:
        self.value = float(v)
        self._tel._emit_value(self.name, self.value)


class Span:
    """One begin/end interval on the monotonic clock.

    Context-manager only: ``__enter__`` stamps the begin and emits a
    ``"B"`` event; ``__exit__`` stamps the end, emits the matching
    ``"E"`` event (attributes attached to the end event, where
    late-``set`` values are visible), and folds the wall into the
    registry's per-name aggregate. Exceptions propagate untouched.
    ``id`` is unique in the registry, ``parent`` the id of the span
    open around this one on its thread (None at the top). With a
    CUDA ``device`` a timing event is recorded on its current stream
    after the begin and before the end stamp.
    """

    __slots__ = ("name", "attrs", "id", "parent", "_tel", "_t0",
                 "_child_ns", "_device", "_events")

    def __init__(self, name: str, tel: "Telemetry", attrs: dict,
                 device=None):
        self.name = name
        self.attrs = attrs
        self._tel = tel
        self._t0 = 0
        self._child_ns = 0       # wall of the spans directly inside
        self._device = device
        self._events = None
        self.id = self.parent = None

    def set(self, **attrs) -> None:
        """Attach attributes discovered mid-span (e.g. batch meters)."""
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        self._t0 = time.perf_counter_ns()
        self._tel._begin(self)
        if self._device is not None:
            import torch

            begin = torch.cuda.Event(enable_timing=True)
            begin.record(torch.cuda.current_stream(self._device))
            self._events = (begin, torch.cuda.Event(enable_timing=True))
        return self

    def __exit__(self, *exc) -> None:
        if self._events is not None:
            import torch

            self._events[1].record(torch.cuda.current_stream(self._device))
        self._tel._end(self, time.perf_counter_ns())


class _NullSpan:
    """The disabled singleton: every instrumentation point degrades to
    one method call on this object."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


class _NullValue:
    """Disabled counter/gauge: ``add``/``set`` are no-ops."""

    __slots__ = ()
    value = 0.0

    def add(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass


_NULL_SPAN = _NullSpan()
_NULL_VALUE = _NullValue()

def _cuda_device(device):
    """``device`` as a ``torch.device`` where it is a CUDA one, else
    None (no device interval)."""
    if device is None:
        return None
    import torch

    dev = torch.device(device)
    return dev if dev.type == "cuda" else None


class Telemetry:
    """Process-wide registry: spans + counters + gauges + exporters.

    ``exporters`` is any iterable of objects with an
    ``export(event: dict)`` method and a ``close()``
    (:mod:`repro_torch.obs.exporters` ships JSONL and Perfetto/Chrome-trace
    implementations; an empty list keeps everything in-memory for the
    :meth:`summary` table and the ``spans_by_name`` aggregate, which is
    how tests read it).

    Timestamps are ``time.perf_counter_ns`` offsets from registry
    construction, exported in microseconds and monotone within a
    process. :attr:`epoch_us` is the Unix time of that zero, read
    beside it, so ``ts + epoch_us`` compares across processes and
    :meth:`trace_ts` converts to a profiler trace's clock.
    """

    enabled = True

    def __init__(self, exporters: "list[Exporter] | tuple" = ()):
        self.exporters = list(exporters)
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        # name -> [count, total_s, self_s, device_s or None]
        self._span_agg: dict[str, list] = {}
        self._device_pending: list = []    # (name, begin, end) events
        a = time.perf_counter_ns()
        unix = time.time_ns()
        b = time.perf_counter_ns()
        self._t0 = (a + b) // 2
        self.epoch_us = unix / 1e3
        self._ids = 0
        self._pid = os.getpid()
        self._local = threading.local()
        self._lock = threading.Lock()

    def trace_ts(self, ts_us: float, base_time_ns: int = 0) -> float:
        """``ts_us`` of this registry on the clock of a Chrome trace
        whose ``baseTimeNanoseconds`` is ``base_time_ns`` (0: Unix µs)."""
        return ts_us + self.epoch_us - base_time_ns / 1e3

    # -- the instrumentation API ------------------------------------------
    def span(self, name: str, device=None, **attrs) -> Span:
        return Span(name, self, attrs, _cuda_device(device))

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name, self)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name, self)
        return g

    def event(self, name: str, **args) -> None:
        """A zero-duration instant event (round markers, truncations)."""
        self._export({"name": name, "ph": "i", "ts": self._ts_us(),
                      "pid": self._pid,
                      "tid": threading.get_ident() & 0xFFFFFFFF,
                      "s": "t", "args": args})

    # -- span plumbing -----------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _ts_us(self, t_ns: int | None = None) -> float:
        if t_ns is None:
            t_ns = time.perf_counter_ns()
        return (t_ns - self._t0) / 1e3

    def _begin(self, span: Span) -> None:
        st = self._stack()
        with self._lock:
            self._ids += 1
            span.id = self._ids
        span.parent = st[-1].id if st else None
        st.append(span)
        self._export({"name": span.name, "ph": "B",
                      "ts": self._ts_us(span._t0), "pid": self._pid,
                      "tid": threading.get_ident() & 0xFFFFFFFF,
                      "span_id": span.id, "parent_id": span.parent,
                      "args": dict(span.attrs)})

    def _end(self, span: Span, t1_ns: int) -> None:
        st = self._stack()
        if st and st[-1] is span:
            st.pop()
        dur_ns = t1_ns - span._t0
        if st and st[-1].id == span.parent:
            st[-1]._child_ns += dur_ns
        with self._lock:
            agg = self._span_agg.setdefault(span.name,
                                            [0, 0.0, 0.0, None])
            agg[0] += 1
            agg[1] += dur_ns / 1e9
            agg[2] += (dur_ns - span._child_ns) / 1e9
            if span._events is not None:
                self._device_pending.append((span.name, *span._events))
        self._export({"name": span.name, "ph": "E",
                      "ts": self._ts_us(t1_ns), "pid": self._pid,
                      "tid": threading.get_ident() & 0xFFFFFFFF,
                      "span_id": span.id, "parent_id": span.parent,
                      "args": dict(span.attrs)})

    def _read_device(self) -> None:
        """Fold the device intervals held into the aggregate, each once
        the device has reached its end event."""
        with self._lock:
            pending, self._device_pending = self._device_pending, []
        for name, begin, end in pending:
            end.synchronize()
            s = begin.elapsed_time(end) / 1e3
            with self._lock:
                agg = self._span_agg[name]
                agg[3] = (agg[3] or 0.0) + s

    def _emit_value(self, name: str, value: float) -> None:
        self._export({"name": name, "ph": "C", "ts": self._ts_us(),
                      "pid": self._pid, "tid": 0,
                      "args": {"value": value}})

    def _export(self, event: dict) -> None:
        for ex in self.exporters:
            ex.export(event)

    # -- read-side ---------------------------------------------------------
    def spans_by_name(self) -> dict[str, dict]:
        """Finished-span aggregate: name -> {count, total_s, self_s,
        device_s}. ``self_s`` is the wall no span directly inside
        covers; ``device_s`` sums the device intervals (None for a
        name that recorded none), read here, after the device has
        reached the end of each."""
        self._read_device()
        with self._lock:
            return {name: {"count": agg[0], "total_s": agg[1],
                           "self_s": agg[2], "device_s": agg[3]}
                    for name, agg in self._span_agg.items()}

    def counters(self) -> dict[str, float]:
        return {name: c.value for name, c in self._counters.items()}

    def gauges(self) -> dict[str, float]:
        return {name: g.value for name, g in self._gauges.items()}

    def summary(self) -> str:
        """The human table: spans (count/total/mean), counters, gauges."""
        lines = ["telemetry summary",
                 f"{'span':<28}{'count':>8}{'total_ms':>12}{'mean_us':>12}"]
        spans = self.spans_by_name()
        for name in sorted(spans):
            s = spans[name]
            mean_us = s["total_s"] / s["count"] * 1e6 if s["count"] else 0.0
            lines.append(f"{name:<28}{s['count']:>8}"
                         f"{s['total_s'] * 1e3:>12.2f}{mean_us:>12.1f}")
        if self._counters:
            lines.append(f"{'counter':<40}{'value':>20}")
            for name in sorted(self._counters):
                v = self._counters[name].value
                v = int(v) if float(v).is_integer() else v
                lines.append(f"{name:<40}{v:>20}")
        if self._gauges:
            lines.append(f"{'gauge':<40}{'value':>20}")
            for name in sorted(self._gauges):
                lines.append(f"{name:<40}{self._gauges[name].value:>20.6g}")
        return "\n".join(lines)

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        """Flush and close every exporter; idempotent."""
        for ex in self.exporters:
            ex.close()
        self.exporters = []

    def __enter__(self) -> "Telemetry":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _DisabledTelemetry(Telemetry):
    """The process default: every call returns a no-op singleton."""

    enabled = False

    def __init__(self):
        super().__init__()

    def span(self, name: str, device=None, **attrs):
        return _NULL_SPAN

    def counter(self, name: str):
        return _NULL_VALUE

    def gauge(self, name: str):
        return _NULL_VALUE

    def event(self, name: str, **args) -> None:
        pass


DISABLED = _DisabledTelemetry()
_current: Telemetry = DISABLED


def current() -> Telemetry:
    """The active registry (the disabled singleton by default)."""
    return _current


def set_current(tel: Telemetry | None) -> Telemetry:
    """Install ``tel`` process-wide; returns the previous registry.
    ``None`` restores the disabled default."""
    global _current
    prev = _current
    _current = DISABLED if tel is None else tel
    return prev


@contextlib.contextmanager
def use(tel: Telemetry | None):
    """Scoped :func:`set_current` (the test-friendly form)."""
    prev = set_current(tel)
    try:
        yield tel
    finally:
        set_current(prev)


# Module-level shorthands — what instrumented code calls. Each is one
# global read + one method call when telemetry is disabled.
def span(name: str, **attrs):
    return _current.span(name, **attrs)


def counter(name: str):
    return _current.counter(name)


def gauge(name: str):
    return _current.gauge(name)


def event(name: str, **args) -> None:
    _current.event(name, **args)


def enabled() -> bool:
    return _current.enabled
