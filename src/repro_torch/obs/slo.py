"""SLO evaluation: rolling-window health scored against the paper's models.

SMOF's claims are quantitative — Eq. 6 says steady-state throughput is
``1 / max_j(L_j)``, Eq. 1 says a well-sized inter-stage ring never
stalls, and the device sheet says how much off-chip bandwidth exists to
spill into.  A production front-end should therefore be able to say *how
far from those bounds it is running*, continuously.  The
:class:`SloEvaluator` keeps a rolling window of serving observations and
scores four objectives, each emitting a ``pass`` / ``warn`` / ``breach``
verdict:

``fps``
    measured frames/s as a fraction of the **Eq. 6 roofline**
    (``roofline_fps``, e.g. the calibrated ``1 / (eq6_cycles *
    s_per_cycle)`` of the served plan).  Below ``fps_fraction_warn`` of
    the roofline is a warn; below ``fps_fraction_breach`` a breach.
``latency_p50`` / ``latency_p99``
    request-latency quantiles (from any object with a ``quantile(q)``,
    e.g. the serving engines' :class:`~repro_torch.obs.trace.LatencyHistogram`)
    against configurable absolute targets.
``stall_ratio``
    queue stalls per queue operation over the window — Eq. 1 sizing says
    this should be 0; a rising ratio is the spill FIFO backpressuring.
``spill_bw``
    off-chip spill bandwidth (Gbit/s over the window) as a fraction of
    the device's ``bw_gbps`` (``Device.offchip_gbps``) — riding the DMA
    budget is exactly the regime the paper's Eq. 2 trades against.
``spill_bw_evict`` / ``spill_bw_restore``
    the same objective split by direction, each scored against its *own*
    budget — by default half the device number, or, when the plan was
    compiled with a channel config, the per-kind effective bandwidth the
    ``repro_torch.memory`` arbiter actually granted that direction
    (``stream_budgets``).  The combined ``spill_bw`` check stays for
    backward compat; the split is what catches one-sided saturation
    (e.g. a restore-heavy skip connection) that the sum hides.

Objectives without data or targets are skipped, not failed.  A breach
fires every ``on_breach`` callback with the :class:`SloReport` — the
:class:`~repro_torch.obs.flight.FlightRecorder` hooks in there to dump the
recent event ring for post-mortem.
"""
from __future__ import annotations

import collections
import dataclasses

__all__ = ["SloConfig", "SloCheck", "SloReport", "SloEvaluator",
           "PASS", "WARN", "BREACH"]

PASS, WARN, BREACH = "pass", "warn", "breach"
_SEVERITY = {PASS: 0, WARN: 1, BREACH: 2}


@dataclasses.dataclass(frozen=True)
class SloConfig:
    """Targets for the four objectives; ``None`` disables a latency check.

    Travels on ``CompileSpec.obs.slo`` and round-trips through
    ``Compiled.save``/``load`` (same forward-compat policy as
    :class:`~repro_torch.obs.trace.ObsConfig`: unknown keys from a newer writer
    are ignored).
    """
    window: int = 64                      # rolling observations kept
    fps_fraction_warn: float = 0.5        # measured/roofline below -> warn
    fps_fraction_breach: float = 0.25     # measured/roofline below -> breach
    p50_target_s: float | None = None
    p99_target_s: float | None = None
    latency_warn_fraction: float = 0.8    # warn band: > fraction * target
    stall_ratio_warn: float = 0.01        # stalls per queue op
    stall_ratio_breach: float = 0.10
    spill_bw_fraction_warn: float = 0.5   # spill Gbps / device bw_gbps
    spill_bw_fraction_breach: float = 1.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SloConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass(frozen=True)
class SloCheck:
    """One objective's verdict over the current window."""
    objective: str
    measured: float
    target: float            # the breach threshold the verdict gates on
    verdict: str
    detail: str = ""

    def summary(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class SloReport:
    checks: list[SloCheck]
    window: dict             # aggregate measured stats the checks read

    @property
    def verdict(self) -> str:
        worst = max((_SEVERITY[c.verdict] for c in self.checks), default=0)
        return {v: k for k, v in _SEVERITY.items()}[worst]

    @property
    def ok(self) -> bool:
        return self.verdict != BREACH

    def breaches(self) -> list[SloCheck]:
        return [c for c in self.checks if c.verdict == BREACH]

    def summary(self) -> dict:
        return {"verdict": self.verdict, "ok": self.ok,
                "window": dict(self.window),
                "checks": [c.summary() for c in self.checks]}


@dataclasses.dataclass(frozen=True)
class _Sample:
    frames: float
    seconds: float
    stalls: float
    queue_ops: float
    spill_bytes: float        # combined (kept for backward compat)
    evict_bytes: float
    restore_bytes: float


class SloEvaluator:
    """Rolling-window SLO scoring for one serving front-end.

    roofline_fps
        the Eq. 6 bound to score throughput against (``None``: fps
        objective skipped).
    bw_gbps
        the device's off-chip bandwidth budget
        (:attr:`~repro_torch.core.resources.Device.offchip_gbps`; ``None``:
        spill objective skipped).
    latency
        any ``quantile(q) -> seconds`` provider — typically the serving
        engine's :class:`~repro_torch.obs.trace.LatencyHistogram`.
    stream_budgets
        per-direction Gbit/s budgets for the split spill objectives,
        keyed by the arbiter's stream kinds (``activation-evict`` /
        ``activation-restore``) — e.g.
        ``MemoryModel.budget_gbps_by_kind()``.  Without them each
        direction defaults to half of ``bw_gbps``.
    """

    def __init__(self, cfg: SloConfig | None = None, *,
                 roofline_fps: float | None = None,
                 bw_gbps: float | None = None,
                 latency=None,
                 stream_budgets: dict[str, float] | None = None) -> None:
        self.cfg = cfg or SloConfig()
        self.roofline_fps = roofline_fps
        self.bw_gbps = bw_gbps
        self.latency = latency
        self.stream_budgets = dict(stream_budgets or {})
        self.on_breach: list = []         # callbacks: f(report) -> None
        self._samples: collections.deque[_Sample] = collections.deque(
            maxlen=max(self.cfg.window, 1))
        self.last_report: SloReport | None = None

    # -- intake ---------------------------------------------------------------
    def observe(self, *, frames: float, seconds: float, stalls: float = 0.0,
                queue_ops: float = 0.0, spill_bytes: float = 0.0,
                evict_bytes: float | None = None,
                restore_bytes: float | None = None) -> None:
        """Record one window sample (e.g. one served stream): ``frames``
        delivered over ``seconds`` of wall clock, with the queue/spill
        traffic that run generated.  ``evict_bytes``/``restore_bytes``
        split the spill traffic by direction; callers that only know the
        combined number get an even split (the pipelined spill story moves
        every evicted bit out once and back once, so halves are exact
        there)."""
        if seconds < 0 or frames < 0:
            raise ValueError(f"negative observation ({frames=}, {seconds=})")
        if evict_bytes is None and restore_bytes is None:
            evict_bytes = restore_bytes = spill_bytes / 2.0
        else:
            evict_bytes = evict_bytes or 0.0
            restore_bytes = restore_bytes or 0.0
            spill_bytes = max(spill_bytes, evict_bytes + restore_bytes)
        self._samples.append(_Sample(frames, seconds, stalls, queue_ops,
                                     spill_bytes, evict_bytes,
                                     restore_bytes))

    # -- window aggregates ----------------------------------------------------
    def _window(self) -> dict:
        frames = sum(s.frames for s in self._samples)
        seconds = sum(s.seconds for s in self._samples)
        stalls = sum(s.stalls for s in self._samples)
        ops = sum(s.queue_ops for s in self._samples)
        spill_bytes = sum(s.spill_bytes for s in self._samples)
        evict_bytes = sum(s.evict_bytes for s in self._samples)
        restore_bytes = sum(s.restore_bytes for s in self._samples)

        def gbps(nbytes: float) -> float:
            return (nbytes * 8 / 1e9) / seconds if seconds > 0 else 0.0

        return {
            "samples": len(self._samples),
            "frames": frames,
            "seconds": seconds,
            "fps": frames / seconds if seconds > 0 else 0.0,
            "stalls": stalls,
            "queue_ops": ops,
            "stall_ratio": stalls / ops if ops > 0 else 0.0,
            "spill_bytes": spill_bytes,
            "spill_gbps": gbps(spill_bytes),
            "evict_bytes": evict_bytes,
            "evict_gbps": gbps(evict_bytes),
            "restore_bytes": restore_bytes,
            "restore_gbps": gbps(restore_bytes),
        }

    # -- scoring --------------------------------------------------------------
    @staticmethod
    def _band(value: float, warn: float, breach: float, *,
              low_is_bad: bool) -> str:
        """Three-way verdict; ``low_is_bad`` flips the comparison sense."""
        if low_is_bad:
            if value < breach:
                return BREACH
            return WARN if value < warn else PASS
        if value > breach:
            return BREACH
        return WARN if value > warn else PASS

    def evaluate(self) -> SloReport:
        """Score every configured objective over the current window and
        fire ``on_breach`` callbacks if the overall verdict is a breach."""
        cfg = self.cfg
        win = self._window()
        checks: list[SloCheck] = []

        if self.roofline_fps and win["seconds"] > 0:
            frac = win["fps"] / self.roofline_fps
            checks.append(SloCheck(
                "fps", measured=win["fps"],
                target=cfg.fps_fraction_breach * self.roofline_fps,
                verdict=self._band(frac, cfg.fps_fraction_warn,
                                   cfg.fps_fraction_breach, low_is_bad=True),
                detail=f"{frac:.3f} of the Eq. 6 roofline "
                       f"({self.roofline_fps:.4g} fps)"))

        if self.latency is not None:
            for name, q, target in (("latency_p50", 0.50, cfg.p50_target_s),
                                    ("latency_p99", 0.99, cfg.p99_target_s)):
                if target is None:
                    continue
                measured = self.latency.quantile(q)
                checks.append(SloCheck(
                    name, measured=measured, target=target,
                    verdict=self._band(
                        measured, cfg.latency_warn_fraction * target,
                        target, low_is_bad=False),
                    detail=f"target {target:.4g}s"))

        if win["queue_ops"] > 0:
            checks.append(SloCheck(
                "stall_ratio", measured=win["stall_ratio"],
                target=cfg.stall_ratio_breach,
                verdict=self._band(win["stall_ratio"], cfg.stall_ratio_warn,
                                   cfg.stall_ratio_breach, low_is_bad=False),
                detail=f"{win['stalls']:.0f} stalls / "
                       f"{win['queue_ops']:.0f} queue ops (Eq. 1 says 0)"))

        if self.bw_gbps and win["seconds"] > 0:
            frac = win["spill_gbps"] / self.bw_gbps
            checks.append(SloCheck(
                "spill_bw", measured=win["spill_gbps"],
                target=cfg.spill_bw_fraction_breach * self.bw_gbps,
                verdict=self._band(frac, cfg.spill_bw_fraction_warn,
                                   cfg.spill_bw_fraction_breach,
                                   low_is_bad=False),
                detail=f"{frac:.3f} of the device's "
                       f"{self.bw_gbps:.4g} Gbps off-chip budget"))
            for name, kind, key in (
                    ("spill_bw_evict", "activation-evict", "evict_gbps"),
                    ("spill_bw_restore", "activation-restore",
                     "restore_gbps")):
                budget = self.stream_budgets.get(kind, self.bw_gbps / 2.0)
                if budget <= 0:
                    continue
                frac = win[key] / budget
                src = ("arbiter-granted" if kind in self.stream_budgets
                       else "half-device")
                checks.append(SloCheck(
                    name, measured=win[key],
                    target=cfg.spill_bw_fraction_breach * budget,
                    verdict=self._band(frac, cfg.spill_bw_fraction_warn,
                                       cfg.spill_bw_fraction_breach,
                                       low_is_bad=False),
                    detail=f"{frac:.3f} of the {src} "
                           f"{budget:.4g} Gbps budget"))

        report = SloReport(checks=checks, window=win)
        self.last_report = report
        if not report.ok:
            for cb in self.on_breach:
                cb(report)
        return report
