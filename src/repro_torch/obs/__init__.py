"""Telemetry: spans, counters, gauges and Perfetto traces for the
search → engine → rules pipeline.

The search driver's round loop, the evaluator batch path, the
persistent store, the kernel autotune's build and timing phases and
the rules distillation stages emit hierarchical spans and typed
counters/gauges into one process-wide :class:`Telemetry` registry with
pluggable exporters (JSONL event log, Chrome trace-event / Perfetto
JSON, in-memory, plus a human
:meth:`~repro_torch.obs.telemetry.Telemetry.summary` table).

The evaluator's phases (``executor.capture``, ``engine.gate``,
``engine.timing``, ``executor.release``) and the train step's
(``train.forward``, ``train.backward``, ``train.optimizer``) are spans
too, and the MoE layer counts its routed, dropped and offered slots
(``moe.routed``, ``moe.dropped``, ``moe.slots``).

The default registry is *disabled*: instrumentation points cost one
attribute check + a no-op call, and telemetry never feeds back into
what it observes — search results are byte-identical with or without
an exporter attached (tests/test_torch_obs.py).

One clock: a span's ``ts`` plus the registry's ``epoch_us`` is a Unix
time in µs, comparable across processes, and
``Telemetry.trace_ts`` puts it on a ``torch.profiler`` trace's clock.
A span opened with ``device=`` a CUDA device also records a CUDA event
at entry and exit; its device time (``device_s`` of
``spans_by_name``) is read with the registry, never inside the span.
A counter takes a tensor too, added up on its device and read once,
when the counter is. The host time of a span around device work is
the device's only where the code it wraps synchronizes (the measuring
evaluators do).

The JAX package's ``repro/obs`` with its imports rewritten.
"""
from repro_torch.obs.exporters import (Exporter, JsonlExporter,
                                       MemoryExporter, PerfettoExporter,
                                       load_trace)
from repro_torch.obs.telemetry import (DISABLED, Counter, Gauge, Span,
                                       Telemetry, counter, current, enabled,
                                       event, gauge, set_current, span, use)

__all__ = [
    "Telemetry", "DISABLED", "Span", "Counter", "Gauge",
    "current", "set_current", "use", "span", "counter", "gauge",
    "event", "enabled",
    "Exporter", "JsonlExporter", "MemoryExporter", "PerfettoExporter",
    "load_trace",
]
