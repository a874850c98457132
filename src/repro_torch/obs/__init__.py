"""Streaming telemetry of the port: spans, counters, model-vs-measured.

Copies of the reference package's JAX-free ``obs`` layers that the
pipelined streamer needs:

* :mod:`repro_torch.obs.trace` — recorder primitives (the no-op
  :data:`NULL_RECORDER`, :class:`TraceRecorder` with its Chrome
  trace-event exporter);
* :mod:`repro_torch.obs.stream` — :class:`StreamTracer`, the per-tick
  narrator of ``StreamingExecutor.run_traced``;
* :mod:`repro_torch.obs.modelcheck` — :class:`ModelCheck` via
  ``check_stream``: measured ticks, stage latencies and queue depths
  against Eq. 1/5/6.

The metrics registry, SLO scoring and flight recorder come with the
serving front end (ROADMAP.md, Queue 1).  Import the submodules directly.
"""
