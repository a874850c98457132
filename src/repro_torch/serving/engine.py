"""The graph serving front end of the port: frames in, streams through the
pipelined executor, results out by ticket.

The counterpart of the reference package's ``serving/engine.py``
``GraphStreamServer``: a batched front end that packs submitted frames
into fixed-length microbatch streams and runs them through the pipelined
streaming executor (``runtime/streamer``).  The LM ``ServingEngine`` of
the same module is not ported yet (ROADMAP.md, Queue 1, item 11).

On a CUDA device a stream's frames are stacked into one tensor on the
card, and the host waits for the stream's results before it reads the
clock for the latency histogram and the SLO window: without that wait the
clock would read the launches, not the work.
"""
from __future__ import annotations

import collections
import time

import numpy as np
import torch

from ..obs.metrics import MetricsRegistry


class _RegistryStats:
    """Base for the registry-backed stats views.

    The :class:`~repro_torch.obs.metrics.MetricsRegistry` is the single
    source of truth and these views are *live reads* of it: each attribute
    maps to its metric sample, and ``report()`` is the registry snapshot
    filtered to this front end's namespace.
    """

    _PREFIX = "smof_"

    def __init__(self, registry: MetricsRegistry) -> None:
        self._registry = registry

    def _value(self, name: str, **labels) -> int:
        fam = self._registry.get(name)
        return int(fam.labels(**labels).value)

    def report(self) -> dict:
        """All of this front end's samples, from the registry snapshot."""
        return {k: v for k, v in self._registry.snapshot().items()
                if k.startswith(self._PREFIX)}

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.report()})"


class StreamServerStats(_RegistryStats):
    """Live view of the stream server's counters (see ``_RegistryStats``)."""

    _PREFIX = "smof_server_"

    @property
    def frames_in(self) -> int:
        return self._value("smof_server_frames_in_total")

    @property
    def frames_out(self) -> int:
        return self._value("smof_server_frames_out_total")

    @property
    def streams_run(self) -> int:
        return self._value("smof_server_streams_total")

    @property
    def padded_frames(self) -> int:
        # bubble frames added to fill the last stream
        return self._value("smof_server_padded_frames_total")


class GraphStreamServer:
    """Packs submitted frames into microbatch streams for the streamer.

    The pipelined executor runs a fixed stream length ``B``: this front end
    queues individual frames, cuts the queue into length-``B`` streams
    (zero-padding the tail — padding frames run as pipeline bubbles and are
    dropped), runs each stream through the executor once, and hands results
    back by ticket.

    It wraps a lowered ``StreamingExecutor``; ``Compiled.serve()`` builds
    one around a compiled design (re-lowering the plan pipelined when it
    has to) and shares the design's metrics registry with it.
    """

    def __init__(self, executor, *, metrics: MetricsRegistry | None = None,
                 resident_limit: int = 0):
        self.executor = executor
        self.microbatches = executor.microbatches
        self.device = executor.device
        # flushed-but-unclaimed results allowed to stay resident (the
        # executor's own tensors) before the oldest is evicted to the
        # byte-packed host store; 0 = unbounded.  Results are finished
        # outputs, so the eviction is lossless and the restore exact.
        self.resident_limit = resident_limit
        # registry-backed accounting (own registry by default; pass one to
        # share a scrape surface, e.g. Compiled.serve threads the artifact's)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        m = self.metrics
        self._c_frames_in = m.counter(
            "smof_server_frames_in_total", "frames submitted to the server")
        self._c_frames_out = m.counter(
            "smof_server_frames_out_total", "frames delivered by flush")
        self._c_streams = m.counter(
            "smof_server_streams_total",
            "fixed-length microbatch streams executed")
        self._c_padded = m.counter(
            "smof_server_padded_frames_total",
            "bubble frames padded onto stream tails")
        self._h_latency = m.histogram(
            "smof_server_frame_latency_seconds",
            "submit -> flush-delivery wall clock per frame")
        self._c_slo = m.counter(
            "smof_server_slo_evaluations_total",
            "per-flush SLO evaluations, by verdict", ("verdict",))
        self.stats = StreamServerStats(m)
        # submit -> flush-delivery wall clock per frame (log-bucketed):
        # queueing delay + padding bubbles + the stream's pipeline run; the
        # same LatencyHistogram the registry histogram exposes
        self.latency = self._h_latency.labels().hist
        self.slo = None                      # obs.slo.SloEvaluator | None
        self.flight = None                   # obs.flight.FlightRecorder | None
        # per stream executed, every spill record moves offchip_bits once
        # per microbatch in each direction (evict + restore) — the window
        # samples the SLO's spill-bandwidth objectives score, split by
        # direction so one-sided saturation stays visible
        self._one_way_bytes_per_stream = sum(
            r.offchip_bits // 8
            for r in getattr(executor.report, "spills", ())
        ) * self.microbatches
        self._c_evicted_results = m.counter(
            "smof_server_evicted_results_total",
            "flushed results spilled to the host store (resident_limit)")
        self._c_restored_results = m.counter(
            "smof_server_restored_results_total",
            "evicted results restored on claim (exact, byte-packed)")
        self._pending: list[tuple[int, torch.Tensor]] = []
        # ticket -> output, oldest-flushed first (the eviction order)
        self._results: "collections.OrderedDict[int, torch.Tensor]" = \
            collections.OrderedDict()
        # ticket -> (raw bytes, shape): the off-chip side of the resident
        # budget — exact restore by construction
        self._host_results: dict[int, tuple[bytes, tuple]] = {}
        self._submit_ts: dict[int, float] = {}
        self._next_ticket = 0

    @classmethod
    def autotuned(cls, *args, **kwargs) -> "GraphStreamServer":
        """Serve the autotuner's measured-best plan: not ported yet."""
        raise NotImplementedError(
            "GraphStreamServer.autotuned needs the closed-loop autotuner, "
            "which is not ported yet; see ROADMAP.md, Queue 1, item 8")

    @property
    def report(self):
        return self.executor.report

    def submit(self, frame) -> int:
        """Queue one (positions, channels) frame (a tensor or an array);
        returns a ticket id."""
        if isinstance(frame, np.ndarray):
            frame = torch.from_numpy(
                np.ascontiguousarray(frame, dtype=np.float32))
        self._pending.append((self._next_ticket,
                              frame.to(dtype=torch.float32)))
        self._submit_ts[self._next_ticket] = time.perf_counter()
        self._next_ticket += 1
        self._c_frames_in.inc()
        return self._next_ticket - 1

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def flush(self) -> dict[int, torch.Tensor]:
        """Run all queued frames; returns {ticket: output} for this flush.

        Every stream is one tensor on the executor's device, its tail
        zero-padded to ``B`` frames.  With an attached SLO evaluator
        (:meth:`enable_slo`), every stream run lands one window
        observation and is re-scored — breaches fire the evaluator's
        ``on_breach`` hooks (e.g. a flight-recorder dump) and the verdict
        counts into ``smof_server_slo_evaluations_total``.
        """
        out: dict[int, torch.Tensor] = {}
        B = self.microbatches
        while self._pending:
            chunk, self._pending = self._pending[:B], self._pending[B:]
            xs = torch.stack([f.to(self.device) for _, f in chunk])
            pad = B - len(chunk)
            if pad:
                xs = torch.cat([xs, xs.new_zeros((pad,) + xs.shape[1:])])
                self._c_padded.inc(pad)
            self._sync()
            t_run = time.perf_counter()
            ys = self.executor(xs)
            self._sync()            # the clock reads the stream's results
            now = time.perf_counter()
            run_s = now - t_run
            self._c_streams.inc()
            for (ticket, _), y in zip(chunk, ys):
                # a row of ys is a view of the whole (B, L) stream, bubble
                # rows included: the copy lets a dropped stream free its
                # memory, so resident_limit bounds what stays on the card
                out[ticket] = y.clone()
                self._c_frames_out.inc()
                t0 = self._submit_ts.pop(ticket, None)
                if t0 is not None:
                    self.latency.record(now - t0)
            if self.slo is not None:
                one_way = self._one_way_bytes_per_stream
                self.slo.observe(frames=len(chunk), seconds=run_s,
                                 spill_bytes=2 * one_way,
                                 evict_bytes=one_way, restore_bytes=one_way)
                verdict = self.slo.evaluate().verdict
                self._c_slo.labels(verdict=verdict).inc()
        self._results.update(out)
        if self.resident_limit > 0:
            while len(self._results) > self.resident_limit:
                # budget exceeded: spill the OLDEST unclaimed result to the
                # host, losslessly (finished outputs)
                ticket, y = self._results.popitem(last=False)
                self._host_results[ticket] = (
                    y.detach().cpu().numpy().tobytes(), tuple(y.shape))
                self._c_evicted_results.inc()
        return out

    # -- observability surface ------------------------------------------------
    def metrics_text(self) -> str:
        """Prometheus text exposition of this server's registry."""
        return self.metrics.metrics_text()

    def enable_slo(self, cfg=None, *, bw_gbps=None):
        """Attach a rolling-window SLO evaluator, re-scored on every flush.

        ``bw_gbps`` is the device's off-chip budget for the spill-bandwidth
        objective.  The fps objective's roofline is the served plan's Eq. 6
        bound, ``1 / (eq6_cycles * s_per_cycle)``, when the plan's
        provenance carries a calibrated ``s_per_cycle`` (DSE plans carry
        none, and the objective is then off).  The split evict/restore
        objectives are scored against the arbiter's per-kind grants when
        the plan was lowered with a channel model.  Returns the evaluator
        so callers can hook ``on_breach`` (e.g.
        ``FlightRecorder.on_slo_report``).
        """
        from ..obs.slo import SloEvaluator
        report = self.executor.report
        plan = getattr(self.executor, "plan", None)
        spc = plan.provenance.get("s_per_cycle") if plan is not None else None
        eq6 = getattr(report, "eq6_time", None)
        mem = getattr(report, "memory", None)
        self.slo = SloEvaluator(
            cfg, roofline_fps=1.0 / (eq6 * spc) if spc and eq6 else None,
            bw_gbps=bw_gbps, latency=self.latency,
            stream_budgets=mem.budget_gbps_by_kind() if mem is not None
            else None)
        return self.slo

    def result(self, ticket: int) -> torch.Tensor:
        """Claim a flushed output, on the executor's device (one-shot: the
        server does not keep delivered results, so a long-lived front end
        stays bounded).

        Results evicted under ``resident_limit`` restore bit-exactly from
        the host byte store."""
        if ticket in self._host_results:
            raw, shape = self._host_results.pop(ticket)
            self._c_restored_results.inc()
            host = torch.from_numpy(
                np.frombuffer(raw, dtype=np.float32).reshape(shape).copy())
            return host.to(self.device)
        return self._results.pop(ticket)
