"""Streaming telemetry of the port: spans, counters, metrics, SLOs.

Copies of the reference package's JAX-free ``obs`` layers:

* :mod:`repro_torch.obs.trace` — recorder primitives (the no-op
  :data:`NULL_RECORDER`, :class:`TraceRecorder` with its Chrome
  trace-event exporter, ``validate_chrome_trace``, the serving front
  end's :class:`LatencyHistogram`) and :class:`ObsConfig`, the
  ``CompileSpec`` field that turns telemetry on;
* :mod:`repro_torch.obs.stream` — :class:`StreamTracer`, the per-tick
  narrator of ``StreamingExecutor.run_traced``, and
  ``emit_spill_counters`` for the staged executor;
* :mod:`repro_torch.obs.modelcheck` — :class:`ModelCheck` via
  ``check_stream``: measured ticks, stage latencies and queue depths
  against Eq. 1/5/6;
* :mod:`repro_torch.obs.metrics` — :class:`MetricsRegistry`: labeled
  counters, gauges and histograms with Prometheus text exposition
  (``metrics_text`` and the strict ``parse_metrics_text``);
* :mod:`repro_torch.obs.slo` — :class:`SloEvaluator`: rolling-window
  pass/warn/breach scoring of fps, latency percentiles, stall ratio and
  spill bandwidth;
* :mod:`repro_torch.obs.flight` — :class:`FlightRecorder`: a bounded ring
  of recent events that dumps a Chrome trace on an SLO breach or a
  ModelCheck violation.
"""
from .flight import FlightRecorder
from .metrics import (REGISTRY, Counter, Gauge, Histogram, MetricsRegistry,
                      escape_label_value, parse_metrics_text)
from .modelcheck import (ContentionCheck, ModelCheck, QueueDepthCheck,
                         StageLatencyCheck, check_contention, check_stream)
from .slo import (BREACH, PASS, WARN, SloCheck, SloConfig, SloEvaluator,
                  SloReport)
from .stream import StreamTracer, emit_spill_counters
from .trace import (NULL_RECORDER, LatencyHistogram, NullRecorder, ObsConfig,
                    TraceRecorder, validate_chrome_trace)

__all__ = [
    "ObsConfig", "NullRecorder", "NULL_RECORDER", "TraceRecorder",
    "LatencyHistogram", "validate_chrome_trace", "StreamTracer",
    "emit_spill_counters", "ModelCheck", "StageLatencyCheck",
    "QueueDepthCheck", "ContentionCheck", "check_stream", "check_contention",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "escape_label_value", "parse_metrics_text", "SloConfig", "SloCheck",
    "SloReport", "SloEvaluator", "PASS", "WARN", "BREACH", "FlightRecorder",
]
