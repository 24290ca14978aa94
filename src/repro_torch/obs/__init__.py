"""Telemetry: spans, counters, gauges and Perfetto traces for the
search → engine → rules pipeline.

The search driver's round loop, the evaluator batch path, the
persistent store, the kernel autotune's build and timing phases and
the rules distillation stages emit hierarchical spans and typed
counters/gauges into one process-wide :class:`Telemetry` registry with
pluggable exporters (JSONL event log, Chrome trace-event / Perfetto
JSON, in-memory, plus a human
:meth:`~repro_torch.obs.telemetry.Telemetry.summary` table).

The default registry is *disabled*: instrumentation points cost one
attribute check + a no-op call, and telemetry never feeds back into
what it observes — search results are byte-identical with or without
an exporter attached (tests/test_torch_obs.py). Host clock only: a span
around device work measures it only where the code it wraps
synchronizes (the measuring evaluators do).

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
