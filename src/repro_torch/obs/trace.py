"""Span/counter tracing primitives and the Chrome trace-event exporter.

The whole observability layer funnels through one small ``Recorder``
contract: a *null* implementation (:data:`NULL_RECORDER`) whose every
method is a no-op — the default everywhere, so instrumented code paths
cost nothing when tracing is off — and :class:`TraceRecorder`, which
accumulates **spans** (named intervals on named tracks), **instants**
(point events, e.g. a queue stall), and **counters** (named running
series, e.g. per-edge spill bytes) and exports them in the Chrome
trace-event JSON format that ``chrome://tracing`` and Perfetto
(https://ui.perfetto.dev) open directly.

Design rules:

* recording never touches device computations — callers instrument at
  host-side boundaries (tick loops, flush calls, candidate evaluations),
  so outputs are bit-identical with tracing on or off;
* the clock is injectable (``TraceRecorder(clock=...)``), so tests drive
  the whole layer with a deterministic stub and golden traces are exact;
* timestamps are kept in seconds internally and converted to the Chrome
  format's microseconds only at export.

See ``docs/OBSERVABILITY.md`` for the span/counter taxonomy emitted by
the streamer, the serving engine, and the autotuner.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import pathlib
import time
from contextlib import contextmanager
from typing import Any, Callable

__all__ = [
    "ObsConfig", "NullRecorder", "TraceRecorder", "NULL_RECORDER",
    "LatencyHistogram", "validate_chrome_trace",
]


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """The observability knobs a :class:`~repro_torch.api.CompileSpec`
    carries.

    ``enabled`` switches tracing on inside the autotune loop (one span
    per candidate, ``optim.autotune``); ``trace_path`` is where
    ``Compiled.trace`` writes the Chrome trace JSON when set.  ``slo``
    carries the :class:`~repro_torch.obs.slo.SloConfig` targets the serving
    layer scores against; ``flight_capacity`` > 0 makes ``Compiled.trace``
    record into a bounded :class:`~repro_torch.obs.flight.FlightRecorder`
    ring that dumps to ``flight_path`` on a ModelCheck violation.  The
    config round-trips through ``Compiled.save``/``load`` (see
    ``to_dict``/``from_dict``), in the reference package's keys.
    """
    enabled: bool = False
    trace_path: str | None = None
    slo: Any = None                   # repro_torch.obs.slo.SloConfig | None
    flight_capacity: int = 0          # > 0 enables the flight recorder
    flight_path: str | None = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)  # SloConfig nests as a plain dict

    @classmethod
    def from_dict(cls, d: dict) -> "ObsConfig":
        # forward-compat: a newer writer's extra keys are ignored, same
        # policy as ExecutionPlan.from_json
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in known}
        if isinstance(kw.get("slo"), dict):
            from .slo import SloConfig
            kw["slo"] = SloConfig.from_dict(kw["slo"])
        return cls(**kw)


class NullRecorder:
    """The no-op recorder: every hook is a pass-through.

    This is the default recorder everywhere instrumentation is threaded,
    so with tracing disabled the instrumented paths do no bookkeeping,
    allocate nothing per event, and cannot perturb numerics.
    """

    enabled = False

    def now(self) -> float:
        return 0.0

    @contextmanager
    def span(self, name: str, *, track: str = "host", cat: str | None = None,
             args: dict | None = None):
        yield {}

    def add_span(self, name: str, ts: float, dur: float, *,
                 track: str = "host", cat: str | None = None,
                 args: dict | None = None) -> None:
        pass

    def instant(self, name: str, ts: float | None = None, *,
                track: str = "host", cat: str | None = None,
                args: dict | None = None) -> None:
        pass

    def counter(self, name: str, value: float, ts: float | None = None, *,
                track: str = "counters") -> None:
        pass

    def incr(self, name: str, delta: float = 1, ts: float | None = None, *,
             track: str = "counters") -> None:
        pass

    @property
    def totals(self) -> dict:
        return {}


NULL_RECORDER = NullRecorder()


class TraceRecorder(NullRecorder):
    """Accumulates spans/instants/counters; exports Chrome trace JSON.

    Tracks (the ``track`` argument) become Chrome *threads* under one
    process, named via metadata events, so Perfetto shows one lane per
    pipeline stage / queue / subsystem.  ``clock`` defaults to
    ``time.perf_counter``; inject a stub for deterministic traces.
    """

    enabled = True

    def __init__(self, clock: Callable[[], float] | None = None) -> None:
        self._clock = clock or time.perf_counter
        self._t0 = self._clock()
        self._events: list[dict] = []     # raw events, seconds-domain ts
        self._tracks: dict[str, int] = {}
        self._totals: dict[str, float] = {}

    # -- clock ----------------------------------------------------------------
    def now(self) -> float:
        """Seconds since the recorder was created (recorder-relative)."""
        return self._clock() - self._t0

    def _tid(self, track: str) -> int:
        return self._tracks.setdefault(track, len(self._tracks))

    # -- spans ----------------------------------------------------------------
    @contextmanager
    def span(self, name: str, *, track: str = "host", cat: str | None = None,
             args: dict | None = None):
        """Measure a host-side interval; yields a mutable args dict so the
        body can attach results (e.g. a measured fps) before the span
        closes."""
        span_args = dict(args or {})
        t0 = self.now()
        try:
            yield span_args
        finally:
            self.add_span(name, t0, self.now() - t0, track=track, cat=cat,
                          args=span_args)

    def add_span(self, name: str, ts: float, dur: float, *,
                 track: str = "host", cat: str | None = None,
                 args: dict | None = None) -> None:
        """Record an explicitly-timed interval (``ts``/``dur`` seconds)."""
        self._events.append({"ph": "X", "name": name, "ts": ts,
                             "dur": max(dur, 0.0), "tid": self._tid(track),
                             "cat": cat, "args": args})

    def instant(self, name: str, ts: float | None = None, *,
                track: str = "host", cat: str | None = None,
                args: dict | None = None) -> None:
        self._events.append({"ph": "i", "name": name,
                             "ts": self.now() if ts is None else ts,
                             "tid": self._tid(track), "cat": cat,
                             "args": args})

    # -- counters -------------------------------------------------------------
    def counter(self, name: str, value: float, ts: float | None = None, *,
                track: str = "counters") -> None:
        """Set the current value of a counter series (absolute)."""
        self._totals[name] = value
        self._events.append({"ph": "C", "name": name,
                             "ts": self.now() if ts is None else ts,
                             "tid": self._tid(track),
                             "args": {name.rsplit(":", 1)[-1]: value}})

    def incr(self, name: str, delta: float = 1, ts: float | None = None, *,
             track: str = "counters") -> None:
        """Bump a running counter and record the new running total."""
        self.counter(name, self._totals.get(name, 0) + delta, ts,
                     track=track)

    @property
    def totals(self) -> dict:
        """Final value per counter series (tests read conservation here)."""
        return dict(self._totals)

    # -- queries (tests and ModelCheck read these) ----------------------------
    def spans(self, track: str | None = None,
              cat: str | None = None) -> list[dict]:
        """Recorded spans in timestamp order, optionally filtered."""
        tid = self._tracks.get(track) if track is not None else None
        out = [e for e in self._events if e["ph"] == "X"
               and (tid is None or e["tid"] == tid)
               and (cat is None or e["cat"] == cat)]
        return sorted(out, key=lambda e: (e["ts"], e["tid"]))

    def track_name(self, tid: int) -> str:
        for name, t in self._tracks.items():
            if t == tid:
                return name
        raise KeyError(tid)

    # -- Chrome trace-event export --------------------------------------------
    def chrome_trace(self) -> dict:
        """The trace in Chrome trace-event JSON object form.

        Load it at ``chrome://tracing`` or https://ui.perfetto.dev.  All
        events live in one process (pid 0); tracks are threads with
        ``thread_name`` metadata; timestamps are microseconds.
        """
        events: list[dict] = [{
            "ph": "M", "name": "process_name", "pid": 0, "tid": 0,
            "args": {"name": "repro_torch.obs"},
        }]
        for track, tid in sorted(self._tracks.items(), key=lambda kv: kv[1]):
            events.append({"ph": "M", "name": "thread_name", "pid": 0,
                           "tid": tid, "args": {"name": track}})
            events.append({"ph": "M", "name": "thread_sort_index", "pid": 0,
                           "tid": tid, "args": {"sort_index": tid}})
        for e in self._events:
            out = {"ph": e["ph"], "name": e["name"], "pid": 0,
                   "tid": e["tid"], "ts": e["ts"] * 1e6}
            if e["ph"] == "X":
                out["dur"] = e["dur"] * 1e6
            if e.get("cat"):
                out["cat"] = e["cat"]
            if e["ph"] == "i":
                out["s"] = "t"                      # thread-scoped instant
            if e.get("args"):
                out["args"] = e["args"]
            elif e["ph"] == "C":
                out["args"] = {}
            events.append(out)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def save(self, path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.write_text(json.dumps(self.chrome_trace(), indent=1))
        return path


# =============================================================================
# Schema validation (tests + the CI smoke both go through this)
# =============================================================================

_PHASES = {"X", "i", "C", "M"}


def validate_chrome_trace(data: Any) -> dict:
    """Validate a Chrome trace-event JSON object; raise ``ValueError`` on
    the first violation.  Returns summary stats (event/span/counter/track
    counts) so callers can assert on trace shape."""
    if not isinstance(data, dict) or "traceEvents" not in data:
        raise ValueError("trace must be an object with a 'traceEvents' list")
    events = data["traceEvents"]
    if not isinstance(events, list) or not events:
        raise ValueError("'traceEvents' must be a non-empty list")
    stats = {"events": len(events), "spans": 0, "instants": 0,
             "counters": 0, "metadata": 0, "tracks": set()}
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            raise ValueError(f"event {i} is not an object")
        ph = e.get("ph")
        if ph not in _PHASES:
            raise ValueError(f"event {i}: unknown phase {ph!r}")
        if not isinstance(e.get("name"), str) or not e["name"]:
            raise ValueError(f"event {i}: missing/empty 'name'")
        if not isinstance(e.get("pid"), int) or not isinstance(
                e.get("tid"), int):
            raise ValueError(f"event {i}: 'pid'/'tid' must be integers")
        stats["tracks"].add((e["pid"], e["tid"]))
        if ph == "M":
            stats["metadata"] += 1
            continue
        ts = e.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            raise ValueError(f"event {i}: 'ts' must be a non-negative number")
        if ph == "X":
            stats["spans"] += 1
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(
                    f"event {i}: complete event needs non-negative 'dur'")
        elif ph == "C":
            stats["counters"] += 1
            args = e.get("args")
            if not isinstance(args, dict) or not all(
                    isinstance(v, (int, float)) for v in args.values()):
                raise ValueError(
                    f"event {i}: counter 'args' must map to numbers")
        else:
            stats["instants"] += 1
    stats["tracks"] = len(stats["tracks"])
    return stats


# =============================================================================
# Per-request latency histogram (the serving engines' front-end metric)
# =============================================================================

class LatencyHistogram:
    """Log2-bucketed latency histogram: cheap to record, stable to report.

    Buckets double from ``base`` seconds (default 1 µs); everything above
    the last edge lands in the overflow bucket.  Quantiles are read from
    the bucket upper edges, so they are conservative (<= one bucket off),
    then clamped into ``[min_s, max_s]`` so an estimate never lies
    outside the recorded range.
    """

    def __init__(self, base: float = 1e-6, n_buckets: int = 32) -> None:
        self.edges = [base * (2.0 ** i) for i in range(n_buckets)]
        self.counts = [0] * (n_buckets + 1)
        self.n = 0
        self.total_s = 0.0
        self.min_s = 0.0
        self.max_s = 0.0

    def record(self, seconds: float) -> None:
        self.counts[bisect.bisect_left(self.edges, seconds)] += 1
        self.min_s = seconds if not self.n else min(self.min_s, seconds)
        self.n += 1
        self.total_s += seconds
        self.max_s = max(self.max_s, seconds)

    def quantile(self, q: float) -> float:
        """Upper-edge estimate of the ``q`` quantile (0 < q <= 1)."""
        if not self.n:
            return 0.0
        need = q * self.n
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= need and c:
                edge = self.edges[i] if i < len(self.edges) else self.max_s
                return min(max(edge, self.min_s), self.max_s)
        return self.max_s

    def summary(self) -> dict:
        return {
            "count": self.n,
            "mean_s": self.total_s / self.n if self.n else 0.0,
            "p50_s": self.quantile(0.50),
            "p95_s": self.quantile(0.95),
            "p99_s": self.quantile(0.99),
            "min_s": self.min_s,
            "max_s": self.max_s,
        }
