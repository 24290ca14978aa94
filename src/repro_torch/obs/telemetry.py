"""The telemetry core: spans, counters, gauges, and the registry.

Search rounds, evaluator batches, store traffic and distillation
stages all report to :class:`Telemetry`, the one process-wide
registry:

* **Spans** — hierarchical begin/end intervals on the monotonic clock
  (``with obs.span("driver.round", round=i) as sp: ...``), nested via a
  thread-local stack, with arbitrary key/value attributes attached at
  open time or later through :meth:`Span.set`. Finished spans stream to
  every attached exporter (:mod:`repro_torch.obs.exporters`) and fold into a
  per-name (count, total seconds) aggregate for :meth:`Telemetry.
  summary`.
* **Counters / gauges** — typed named values (`counter("engine.misses")
  .add(n)`, ``gauge("driver.best").set(t)``); counter/gauge updates are
  also streamed as Chrome-trace ``"C"`` events so Perfetto renders them
  as tracks under the span timeline.

**Telemetry is a pure observer.** Nothing in this module is ever read
back by the instrumented code: timestamps never feed RNGs, cache keys,
or tie-breaks, so a search with an exporter attached is byte-identical
to one without (tests/test_torch_obs.py). The *disabled* registry
(the process default) reduces every instrumentation point to one
attribute check plus a no-op singleton — well under 1% of a
discrete-event simulation — so instrumented hot paths cost nothing
until someone attaches a real :class:`Telemetry`.

Usage::

    from repro_torch import obs

    tel = obs.Telemetry(exporters=[obs.PerfettoExporter("out.json")])
    with obs.use(tel):                       # or obs.set_current(tel)
        run_search(...)
    tel.close()                              # flush exporters
    print(tel.summary())                     # human table

The JAX package's ``repro/obs/telemetry.py`` with its imports rewritten.
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
    """Monotonically increasing named value (events, bytes, hits)."""

    __slots__ = ("name", "value", "_tel")

    def __init__(self, name: str, tel: "Telemetry"):
        self.name = name
        self.value = 0.0
        self._tel = tel

    def add(self, n: float = 1.0) -> None:
        self.value += n
        self._tel._emit_value(self.name, self.value)


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
    """

    __slots__ = ("name", "attrs", "_tel", "_t0")

    def __init__(self, name: str, tel: "Telemetry", attrs: dict):
        self.name = name
        self.attrs = attrs
        self._tel = tel
        self._t0 = 0

    def set(self, **attrs) -> None:
        """Attach attributes discovered mid-span (e.g. batch meters)."""
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        self._t0 = time.perf_counter_ns()
        self._tel._begin(self)
        return self

    def __exit__(self, *exc) -> None:
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


class Telemetry:
    """Process-wide registry: spans + counters + gauges + exporters.

    ``exporters`` is any iterable of objects with an
    ``export(event: dict)`` method and a ``close()``
    (:mod:`repro_torch.obs.exporters` ships JSONL and Perfetto/Chrome-trace
    implementations; an empty list keeps everything in-memory for the
    :meth:`summary` table and the ``spans_by_name`` aggregate, which is
    how tests and chip_smoke.py read it).

    Timestamps are ``time.perf_counter_ns`` offsets from registry
    construction, exported in microseconds — monotone within a process,
    meaningless across processes (worker pools report through their
    parent's meters, never their own registry).
    """

    enabled = True

    def __init__(self, exporters: "list[Exporter] | tuple" = ()):
        self.exporters = list(exporters)
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._span_agg: dict[str, list] = {}     # name -> [count, total_s]
        self._t0 = time.perf_counter_ns()
        self._pid = os.getpid()
        self._local = threading.local()
        self._lock = threading.Lock()

    # -- the instrumentation API ------------------------------------------
    def span(self, name: str, **attrs) -> Span:
        return Span(name, self, attrs)

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
        self._stack().append(span)
        self._export({"name": span.name, "ph": "B",
                      "ts": self._ts_us(span._t0), "pid": self._pid,
                      "tid": threading.get_ident() & 0xFFFFFFFF,
                      "args": dict(span.attrs)})

    def _end(self, span: Span, t1_ns: int) -> None:
        st = self._stack()
        if st and st[-1] is span:
            st.pop()
        dur_s = (t1_ns - span._t0) / 1e9
        with self._lock:
            agg = self._span_agg.setdefault(span.name, [0, 0.0])
            agg[0] += 1
            agg[1] += dur_s
        self._export({"name": span.name, "ph": "E",
                      "ts": self._ts_us(t1_ns), "pid": self._pid,
                      "tid": threading.get_ident() & 0xFFFFFFFF,
                      "args": dict(span.attrs)})

    def _emit_value(self, name: str, value: float) -> None:
        self._export({"name": name, "ph": "C", "ts": self._ts_us(),
                      "pid": self._pid, "tid": 0,
                      "args": {"value": value}})

    def _export(self, event: dict) -> None:
        for ex in self.exporters:
            ex.export(event)

    # -- read-side ---------------------------------------------------------
    def spans_by_name(self) -> dict[str, dict]:
        """Finished-span aggregate: name -> {count, total_s}."""
        with self._lock:
            return {name: {"count": agg[0], "total_s": agg[1]}
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

    def span(self, name: str, **attrs):
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
