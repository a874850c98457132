"""Serving-grade metrics: a labeled registry with Prometheus exposition.

The tracing layer answers "what happened during *this* run"; this
module answers "how healthy has the system been *over time*".  One
:class:`MetricsRegistry` holds labeled **counters** (monotone totals:
frames served, queue stalls, spill bytes), **gauges** (point-in-time
values: queue occupancy, best autotuned fps) and **histograms**
(distributions — reusing :class:`~repro_torch.obs.trace.LatencyHistogram`'s
log2 buckets, so the serving front-ends' per-request latencies and the
registry view are one data structure).

Three read paths:

* :meth:`MetricsRegistry.snapshot` — a flat ``{sample_key: value}`` dict
  (sample keys are exposition-style, ``name{label="v"}``), cheap to diff;
* :meth:`MetricsRegistry.delta_since` — per-sample change vs an earlier
  snapshot (what the SLO evaluator and the autotuner's per-candidate
  accounting read);
* :meth:`MetricsRegistry.metrics_text` — Prometheus text exposition
  (``# HELP`` / ``# TYPE`` + samples, label values escaped per the spec),
  what ``GraphStreamServer.metrics_text()`` / ``ServingEngine
  .metrics_text()`` serve to a scraper.

:func:`parse_metrics_text` is the matching strict parser — the round-trip
gate the tests and the CI smoke validate the exposition through (label
escaping, histogram bucket cumulativity, ``le="+Inf"`` == ``_count``).

Registries are cheap objects: each serving engine owns one by default so
tests never cross-talk, and :data:`REGISTRY` is the process-wide default
for code that wants exactly one scrape surface per process.
"""
from __future__ import annotations

import re
import threading

from .trace import LatencyHistogram

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "escape_label_value", "parse_metrics_text",
]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def escape_label_value(v: str) -> str:
    r"""Escape a label value per the Prometheus text format: backslash,
    double quote and newline become ``\\``, ``\"`` and ``\n``."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _sample_key(name: str, labels: tuple[tuple[str, str], ...]) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{escape_label_value(v)}"' for k, v in labels)
    return f"{name}{{{inner}}}"


def _fmt(v: float) -> str:
    """Exposition value formatting: integers without the trailing ``.0``."""
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


# =============================================================================
# Metric children (one per label combination)
# =============================================================================

class Counter:
    """A monotone total.  ``inc`` only — a counter that goes down is a bug
    (Prometheus rate() semantics depend on monotonicity)."""

    def __init__(self) -> None:
        self._value = 0.0

    @property
    def value(self) -> float:
        return self._value

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counters only go up, got inc({amount})")
        self._value += amount


class Gauge:
    """A point-in-time value: set/inc/dec freely."""

    def __init__(self) -> None:
        self._value = 0.0

    @property
    def value(self) -> float:
        return self._value

    def set(self, value: float) -> None:
        self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self._value -= amount


class Histogram:
    """A distribution over :class:`LatencyHistogram`'s log2 buckets.

    ``hist`` is the underlying histogram object — the serving engines
    expose it directly as their legacy ``.latency`` attribute, so the
    registry and the front-end read the *same* counts.
    """

    def __init__(self, base: float = 1e-6, n_buckets: int = 32) -> None:
        self.hist = LatencyHistogram(base=base, n_buckets=n_buckets)

    @property
    def value(self) -> float:          # uniform child surface: the count
        return float(self.hist.n)

    def observe(self, value: float) -> None:
        self.hist.record(value)

    def quantile(self, q: float) -> float:
        return self.hist.quantile(q)

    def summary(self) -> dict:
        return self.hist.summary()


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


# =============================================================================
# Metric family: one name, one kind, N label combinations
# =============================================================================

class MetricFamily:
    """All children of one metric name.

    ``labels(**kv)`` resolves (creating on first use) the child for one
    label-value combination; a label-less family proxies ``inc`` / ``set``
    / ``observe`` / ``value`` straight to its single child.
    """

    def __init__(self, name: str, kind: str, help: str = "",
                 labelnames: tuple[str, ...] = (), **child_kw) -> None:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln) or ln.startswith("__"):
                raise ValueError(f"invalid label name {ln!r}")
        if kind == "histogram" and "le" in labelnames:
            raise ValueError("'le' is reserved for histogram buckets")
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        self._child_kw = child_kw
        self._children: dict[tuple[str, ...], object] = {}

    def labels(self, **kv):
        if set(kv) != set(self.labelnames):
            raise ValueError(f"{self.name}: expected labels "
                             f"{self.labelnames}, got {tuple(sorted(kv))}")
        key = tuple(str(kv[ln]) for ln in self.labelnames)
        child = self._children.get(key)
        if child is None:
            child = self._children[key] = _KINDS[self.kind](**self._child_kw)
        return child

    def _default(self):
        if self.labelnames:
            raise ValueError(f"{self.name} is labeled {self.labelnames}; "
                             f"call .labels(...) first")
        return self.labels()

    # label-less convenience surface
    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default().dec(amount)

    def set(self, value: float) -> None:
        self._default().set(value)

    def observe(self, value: float) -> None:
        self._default().observe(value)

    @property
    def value(self) -> float:
        return self._default().value

    def children(self) -> dict[tuple[str, ...], object]:
        return dict(self._children)

    # -- sample emission ------------------------------------------------------
    def samples(self) -> list[tuple[str, float]]:
        """Flat ``(sample_key, value)`` pairs for every child, exposition
        order (labels in first-use order, histogram buckets cumulative)."""
        out: list[tuple[str, float]] = []
        for key, child in self._children.items():
            labels = tuple(zip(self.labelnames, key))
            if self.kind == "histogram":
                h = child.hist
                cum = 0
                for edge, c in zip(h.edges, h.counts):
                    cum += c
                    out.append((_sample_key(
                        f"{self.name}_bucket",
                        labels + (("le", _fmt(edge)),)), float(cum)))
                out.append((_sample_key(f"{self.name}_bucket",
                                        labels + (("le", "+Inf"),)),
                            float(h.n)))
                out.append((_sample_key(f"{self.name}_sum", labels),
                            h.total_s))
                out.append((_sample_key(f"{self.name}_count", labels),
                            float(h.n)))
            else:
                out.append((_sample_key(self.name, labels), child.value))
        return out


# =============================================================================
# The registry
# =============================================================================

class MetricsRegistry:
    """Named metric families; the scrape/snapshot surface.

    Registration is idempotent — asking for an existing name returns the
    existing family (so instrumented code paths can declare their metrics
    at use sites) and re-registering with a different kind or label set is
    an error (two subsystems fighting over one name).
    """

    def __init__(self) -> None:
        self._families: dict[str, MetricFamily] = {}
        self._lock = threading.Lock()

    def _register(self, name: str, kind: str, help: str,
                  labelnames: tuple[str, ...], **child_kw) -> MetricFamily:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as {fam.kind}"
                        f"{fam.labelnames}, cannot re-register as {kind}"
                        f"{tuple(labelnames)}")
                return fam
            fam = MetricFamily(name, kind, help, tuple(labelnames),
                               **child_kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: tuple[str, ...] = ()) -> MetricFamily:
        return self._register(name, "counter", help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: tuple[str, ...] = ()) -> MetricFamily:
        return self._register(name, "gauge", help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: tuple[str, ...] = (), *, base: float = 1e-6,
                  n_buckets: int = 32) -> MetricFamily:
        return self._register(name, "histogram", help, labelnames,
                              base=base, n_buckets=n_buckets)

    def get(self, name: str) -> MetricFamily:
        return self._families[name]

    def __contains__(self, name: str) -> bool:
        return name in self._families

    def families(self) -> list[MetricFamily]:
        return [self._families[n] for n in sorted(self._families)]

    # -- read paths -----------------------------------------------------------
    def snapshot(self) -> dict[str, float]:
        """Every sample as ``{exposition_sample_key: value}`` — counters and
        gauges one sample each, histograms their cumulative buckets plus
        ``_sum``/``_count``."""
        out: dict[str, float] = {}
        for fam in self.families():
            out.update(fam.samples())
        return out

    def delta_since(self, prev: dict[str, float]) -> dict[str, float]:
        """Per-sample change vs an earlier :meth:`snapshot` (new samples
        count from 0).  Zero-delta samples are dropped, so the result is
        exactly "what moved"."""
        now = self.snapshot()
        delta = {k: v - prev.get(k, 0.0) for k, v in now.items()}
        return {k: v for k, v in delta.items() if v != 0.0}

    def metrics_text(self) -> str:
        """Prometheus text exposition (version 0.0.4) of every family."""
        lines: list[str] = []
        for fam in self.families():
            if fam.help:
                lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for key, value in fam.samples():
                lines.append(f"{key} {_fmt(value)}")
        return "\n".join(lines) + "\n"


REGISTRY = MetricsRegistry()
"""The process-wide default registry (engines default to their own)."""


# =============================================================================
# Strict exposition parser — the round-trip gate for tests + CI
# =============================================================================

_SUFFIXES = {"histogram": ("_bucket", "_sum", "_count")}


def _parse_labels(s: str, lineno: int) -> tuple[tuple[str, str], ...]:
    """Parse the ``k="v",...`` body of a label set, honouring escapes."""
    out: list[tuple[str, str]] = []
    i = 0
    while i < len(s):
        m = re.match(r'([a-zA-Z_][a-zA-Z0-9_]*)="', s[i:])
        if not m:
            raise ValueError(f"line {lineno}: bad label syntax at {s[i:]!r}")
        name = m.group(1)
        i += m.end()
        val: list[str] = []
        while i < len(s):                       # scan the quoted value
            ch = s[i]
            if ch == "\\":
                if i + 1 >= len(s):
                    raise ValueError(f"line {lineno}: dangling escape")
                nxt = s[i + 1]
                val.append({"\\": "\\", '"': '"', "n": "\n"}.get(nxt))
                if val[-1] is None:
                    raise ValueError(
                        f"line {lineno}: bad escape \\{nxt}")
                i += 2
            elif ch == '"':
                i += 1
                break
            else:
                val.append(ch)
                i += 1
        else:
            raise ValueError(f"line {lineno}: unterminated label value")
        out.append((name, "".join(val)))
        if i < len(s):
            if s[i] != ",":
                raise ValueError(f"line {lineno}: expected ',' between "
                                 f"labels, got {s[i]!r}")
            i += 1
    return tuple(out)


def _family_of(sample_name: str, types: dict[str, str]) -> str | None:
    if sample_name in types:
        return sample_name
    for fam, kind in types.items():
        if kind == "histogram" and sample_name in {
                fam + sfx for sfx in _SUFFIXES["histogram"]}:
            return fam
    return None


def parse_metrics_text(text: str) -> dict[str, dict]:
    """Parse (and validate) Prometheus text exposition.

    Returns ``{family: {"type", "help", "samples": {sample_key: value}}}``.
    Raises ``ValueError`` on: samples without a preceding ``# TYPE``,
    unknown types, duplicate sample keys, malformed label syntax/escapes,
    non-numeric values, histograms whose cumulative buckets decrease or
    whose ``le="+Inf"`` bucket disagrees with ``_count``.  This is the
    round-trip gate: ``parse_metrics_text(registry.metrics_text())`` must
    succeed for any registry state.
    """
    types: dict[str, str] = {}
    helps: dict[str, str] = {}
    samples: dict[str, dict[str, float]] = {}
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            parts = line[len("# HELP "):].split(" ", 1)
            helps[parts[0]] = parts[1] if len(parts) > 1 else ""
            continue
        if line.startswith("# TYPE "):
            parts = line[len("# TYPE "):].split()
            if len(parts) != 2:
                raise ValueError(f"line {lineno}: malformed TYPE line")
            name, kind = parts
            if kind not in ("counter", "gauge", "histogram", "summary",
                            "untyped"):
                raise ValueError(f"line {lineno}: unknown type {kind!r}")
            if name in types:
                raise ValueError(f"line {lineno}: duplicate TYPE for {name}")
            types[name] = kind
            samples.setdefault(name, {})
            continue
        if line.startswith("#"):
            continue                                    # plain comment
        m = re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)"
                     r"(?:\s+-?\d+)?$", line)
        if not m:
            raise ValueError(f"line {lineno}: malformed sample {line!r}")
        sample_name, label_body, value_s = m.groups()
        labels = _parse_labels(label_body, lineno) if label_body else ()
        try:
            value = float(value_s)
        except ValueError:
            raise ValueError(
                f"line {lineno}: non-numeric value {value_s!r}") from None
        fam = _family_of(sample_name, types)
        if fam is None:
            raise ValueError(f"line {lineno}: sample {sample_name!r} has no "
                             f"preceding # TYPE")
        key = _sample_key(sample_name, labels)
        if key in samples[fam]:
            raise ValueError(f"line {lineno}: duplicate sample {key!r}")
        samples[fam][key] = value

    out: dict[str, dict] = {}
    for fam, kind in types.items():
        out[fam] = {"type": kind, "help": helps.get(fam, ""),
                    "samples": samples[fam]}
        if kind == "histogram":
            _check_histogram(fam, samples[fam])
    return out


def _check_histogram(fam: str, fam_samples: dict[str, float]) -> None:
    """Cumulativity + ``+Inf``-equals-count per label combination."""
    series: dict[tuple, list[tuple[float, float]]] = {}
    counts: dict[tuple, float] = {}
    for key, value in fam_samples.items():
        m = re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?$", key)
        name, body = m.groups()
        labels = dict(_parse_labels(body, 0)) if body else {}
        if name == fam + "_bucket":
            le = labels.pop("le", None)
            if le is None:
                raise ValueError(f"{fam}: bucket sample without 'le'")
            group = tuple(sorted(labels.items()))
            edge = float("inf") if le == "+Inf" else float(le)
            series.setdefault(group, []).append((edge, value))
        elif name == fam + "_count":
            counts[tuple(sorted(labels.items()))] = value
    for group, buckets in series.items():
        buckets.sort(key=lambda p: p[0])
        prev = 0.0
        for edge, cum in buckets:
            if cum < prev:
                raise ValueError(
                    f"{fam}: bucket counts not cumulative at le={edge}")
            prev = cum
        if not buckets or buckets[-1][0] != float("inf"):
            raise ValueError(f"{fam}: histogram missing le=\"+Inf\" bucket")
        if group in counts and buckets[-1][1] != counts[group]:
            raise ValueError(f"{fam}: le=\"+Inf\" bucket "
                             f"({buckets[-1][1]}) != _count "
                             f"({counts[group]})")
