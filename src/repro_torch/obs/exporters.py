"""Telemetry exporters: where the event stream lands.

Three formats, one contract — ``export(event: dict)`` per event plus a
``close()`` flush. Events are the Chrome trace-event shape the
registry emits (:mod:`repro_torch.obs.telemetry`): ``ph`` is ``"B"``/``"E"``
(span begin/end), ``"C"`` (counter/gauge sample), or ``"i"`` (instant);
``ts`` is microseconds on the process-monotonic clock from the
registry's zero (``Telemetry.epoch_us`` is that zero's Unix time); a
span's ``"B"`` and ``"E"`` carry its ``span_id`` and ``parent_id``.

:class:`PerfettoExporter`
    Chrome trace-event JSON (``{"traceEvents": [...]}``) loadable
    straight into https://ui.perfetto.dev — spans nest per thread
    track, counters render as value tracks. Buffered in memory, written
    atomically at :meth:`close`.
:class:`JsonlExporter`
    One JSON object per line, streamed as events happen — the
    grep/pandas-friendly event log, and the crash-tolerant one (a
    killed run keeps every line already flushed).
:class:`MemoryExporter`
    In-process event list, for tests and programmatic consumers.

The JAX package's ``repro/obs/exporters.py``.
"""
from __future__ import annotations

import json
import os
from typing import Protocol, runtime_checkable


@runtime_checkable
class Exporter(Protocol):
    """Consumer of telemetry events."""

    def export(self, event: dict) -> None: ...

    def close(self) -> None: ...


class MemoryExporter:
    """Keep every event in a list (tests, programmatic readers)."""

    def __init__(self):
        self.events: list[dict] = []

    def export(self, event: dict) -> None:
        self.events.append(event)

    def close(self) -> None:
        pass


class JsonlExporter:
    """Stream events as JSON lines to ``path`` (appending never; a new
    run truncates — one file is one run's event log)."""

    def __init__(self, path: "str | os.PathLike"):
        self.path = os.fspath(path)
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._f = open(self.path, "w")

    def export(self, event: dict) -> None:
        if self._f is not None:
            self._f.write(json.dumps(event) + "\n")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class PerfettoExporter:
    """Chrome trace-event / Perfetto JSON.

    Events buffer in memory and are written as one
    ``{"traceEvents": [...], "displayTimeUnit": "ms"}`` document at
    :meth:`close` (atomic rename, so a crashed run leaves no
    half-written trace — use :class:`JsonlExporter` alongside when
    crash-time events matter more than loadability).
    """

    def __init__(self, path: "str | os.PathLike"):
        self.path = os.fspath(path)
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._events: "list[dict] | None" = []

    def export(self, event: dict) -> None:
        if self._events is not None:
            self._events.append(event)

    def close(self) -> None:
        if self._events is None:
            return
        doc = {"traceEvents": self._events, "displayTimeUnit": "ms"}
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, self.path)
        self._events = None


def load_trace(path: "str | os.PathLike") -> list[dict]:
    """Read a trace back as an event list — both exporter formats.

    Accepts the Perfetto document shape (``{"traceEvents": [...]}``), a
    bare JSON array, or JSONL. (The JAX package's version parses any
    text that starts with ``{`` as one document, so it cannot read the
    JSONL its own exporter writes; here a JSONL file falls through to
    the line reader.) The schema test reads traces through
    this, so the check and the writer cannot drift apart.
    """
    with open(os.fspath(path)) as f:
        text = f.read()
    stripped = text.lstrip()
    if stripped.startswith("["):
        return json.loads(text)
    if stripped.startswith("{"):
        try:
            doc = json.loads(text)
        except json.JSONDecodeError:     # JSONL: one object per line
            doc = None
        if isinstance(doc, dict) and "traceEvents" in doc:
            return doc["traceEvents"]
    return [json.loads(line) for line in text.splitlines() if line]
