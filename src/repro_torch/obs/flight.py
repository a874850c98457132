"""Flight recorder: a bounded ring of recent events, dumped on trouble.

A full :class:`~repro_torch.obs.trace.TraceRecorder` grows without bound, so a
long-lived serving process can't leave one on.  The
:class:`FlightRecorder` is the black-box variant: the same recorder
contract (it *is* a ``TraceRecorder``, so the streamer/engine
instrumentation threads through unchanged), but the event buffer is a
``deque(maxlen=capacity)`` — old ticks fall off the back, memory stays
bounded, and at any moment the ring holds the most recent window of
pipeline activity.

It dumps that window as a normal Chrome trace (valid under
:func:`~repro_torch.obs.trace.validate_chrome_trace`) when something goes
wrong:

* :meth:`on_slo_report` — wired into ``SloEvaluator.on_breach``; dumps
  when a report's verdict is ``breach``;
* :meth:`on_model_check` — dumps when a
  :class:`~repro_torch.obs.modelcheck.ModelCheck` comes back ``ok is False``;
* :meth:`dump` — manual, for operator-initiated snapshots.

Each dump appends an ``instant`` event named ``flight:dump`` carrying
the trigger reason, so the trigger point is visible on the timeline.
Successive dumps overwrite ``path`` (the latest incident wins);
``dumps`` keeps the history of (path, reason) for tests and logs.
"""
from __future__ import annotations

import collections
import pathlib
from typing import Callable

from .trace import TraceRecorder

__all__ = ["FlightRecorder"]

DEFAULT_CAPACITY = 4096


class FlightRecorder(TraceRecorder):
    """A :class:`TraceRecorder` whose event buffer is a bounded ring.

    capacity
        how many raw events (spans/instants/counter updates) to retain;
        the ring keeps the newest.
    path
        default dump destination; :meth:`dump` may override per call.
    clock
        injectable, as on :class:`TraceRecorder` — tests use a stub.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY, *,
                 path=None, clock: Callable[[], float] | None = None) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        super().__init__(clock=clock)
        # TraceRecorder appends to / iterates self._events; a maxlen deque
        # keeps that contract while evicting the oldest events.
        self._events = collections.deque(self._events, maxlen=capacity)
        self.capacity = capacity
        self.path = pathlib.Path(path) if path is not None else None
        self.dumps: list[tuple[pathlib.Path, str]] = []

    # -- dumping --------------------------------------------------------------
    def dump(self, path=None, *, reason: str = "manual") -> pathlib.Path:
        """Write the current ring as a Chrome trace; returns the path."""
        target = pathlib.Path(path) if path is not None else self.path
        if target is None:
            raise ValueError("no dump path: pass one or set FlightRecorder("
                             "path=...)")
        self.instant("flight:dump", track="flight", cat="dump",
                     args={"reason": reason, "events": len(self._events)})
        out = self.save(target)
        self.dumps.append((out, reason))
        return out

    # -- triggers -------------------------------------------------------------
    def on_slo_report(self, report) -> pathlib.Path | None:
        """``SloEvaluator.on_breach`` hook: dump when the verdict breaches.

        Accepts any object with ``ok``/``verdict`` (an ``SloReport``).
        """
        if getattr(report, "ok", True):
            return None
        names = ",".join(c.objective for c in report.breaches())
        return self.dump(reason=f"slo_breach:{names or report.verdict}")

    def on_model_check(self, check) -> pathlib.Path | None:
        """Dump when a ``ModelCheck`` fails its structural gates."""
        if getattr(check, "ok", True):
            return None
        why = []
        if not getattr(check, "ticks_ok", True):
            why.append("ticks")
        if not getattr(check, "queues_ok", True):
            why.append("queues")
        return self.dump(reason=f"model_check:{'+'.join(why) or 'failed'}")
