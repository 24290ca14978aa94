"""Acquisition-aware search driver subsystem.

* :class:`SearchDriver` (:mod:`repro_torch.driver.driver`) — the round
  loop (propose pool -> acquisition -> evaluate -> observe -> sinks);
  :func:`repro_torch.search.run_search` is its thin wrapper.
* :data:`ACQUISITIONS` (:mod:`repro_torch.driver.acquisitions`) — pool
  ranking: ``argmin_topk`` (the strategy's own screening), ``ucb``,
  ``expected_improvement``; uncertainty via ``predict_with_std``.
* :data:`SINKS` (:mod:`repro_torch.driver.sinks`) — streaming consumers
  of evaluated batches: ``dataset`` (incremental featurization +
  histogram for streaming distillation), ``histogram`` (out-of-core:
  compact encodings + count histograms, distills without ever
  materializing the feature matrix), ``trace`` (per-round choice
  stream), ``telemetry`` (round markers in the active
  :mod:`repro_torch.obs` registry).

``SearchDriver`` is loaded lazily: :mod:`repro_torch.driver.driver`
imports :mod:`repro_torch.search.pipeline` (for ``SearchResult``),
while :mod:`repro_torch.search.surrogate` imports
:mod:`repro_torch.driver.acquisitions` — eager loading here would make
this package's import order depend on who imports whom first. The JAX
package's ``repro/driver``.
"""
from repro_torch.driver.acquisitions import (ACQUISITIONS, AcquisitionFn,
                                             argmin_topk,
                                             expected_improvement,
                                             make_acquisition,
                                             predict_with_std,
                                             register_acquisition,
                                             resolve_acquisition, ucb)
from repro_torch.driver.sinks import (SINKS, DatasetSink, HistogramSink,
                                      Sink, StreamingHistogram,
                                      TelemetrySink, TraceSink, make_sink,
                                      register_sink)

__all__ = [
    "SearchDriver",
    "ACQUISITIONS", "AcquisitionFn", "argmin_topk",
    "expected_improvement", "make_acquisition", "predict_with_std",
    "register_acquisition", "resolve_acquisition", "ucb",
    "SINKS", "DatasetSink", "HistogramSink", "Sink",
    "StreamingHistogram", "TelemetrySink", "TraceSink", "make_sink",
    "register_sink",
]


def __getattr__(name: str):
    if name == "SearchDriver":
        from repro_torch.driver.driver import SearchDriver
        return SearchDriver
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
