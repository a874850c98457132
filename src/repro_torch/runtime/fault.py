"""Fault tolerance: checkpoint/restart, transient-failure retry, straggler
mitigation — the counterpart of the reference package's
``runtime/fault.py`` (its control logic copied, the checkpoints the port's
``CheckpointStore``).

Single-process simulation of the policies a 1000-node deployment needs —
the *control logic* is real (and unit-tested); only the failure injection
is synthetic:

* **checkpoint/restart** — periodic async checkpoints (checkpoint/store),
  deterministic data resume (data/pipeline is step-indexed), restore picks
  the newest intact checkpoint (a torn save is impossible by construction).
* **retry** — a failed step (device OOM, preempted worker, injected fault)
  is retried from the last good state up to ``max_retries``; repeated
  failure escalates to restore-from-checkpoint.
* **straggler mitigation** — per-step wall times feed a running median;
  a step slower than ``straggler_factor`` x median is logged and counted,
  and the policy hook decides (log | rebalance | skip). At scale the same
  hook triggers backup-task dispatch.
* **elastic rescaling** — on a device-count change, rebuild the mesh,
  recompute shardings, and restore the checkpoint into the new layout
  (:func:`elastic_remesh`, ``try_restore(shardings=...)``: every leaf a
  DTensor on the new mesh, ``checkpoint/store.py``).
"""
from __future__ import annotations

import dataclasses
import time
from statistics import median
from typing import Any, Callable

from ..checkpoint.store import CheckpointStore


@dataclasses.dataclass
class FaultConfig:
    checkpoint_every: int = 50
    max_retries: int = 2
    straggler_factor: float = 3.0
    straggler_policy: str = "log"          # log | skip


@dataclasses.dataclass
class StepRecord:
    step: int
    wall_s: float
    retries: int = 0
    straggler: bool = False


class FaultTolerantLoop:
    """Wraps (state, batch) -> state step functions with FT policies.

    With a ``metrics`` :class:`~repro_torch.obs.metrics.MetricsRegistry`,
    every
    recovery event also lands in ``smof_fault_events_total{kind=...}``
    (retry / restore / rollback / checkpoint / straggler) and step wall
    times in ``smof_fault_step_seconds`` — so recovery behaviour is
    visible on the same scrape surface as the serving metrics, not only
    in the in-memory ``events`` list.
    """

    def __init__(self, step_fn: Callable[[Any, Any], Any],
                 store: CheckpointStore, cfg: FaultConfig | None = None,
                 fault_injector: Callable[[int], None] | None = None,
                 metrics=None):
        self.step_fn = step_fn
        self.store = store
        self.cfg = cfg or FaultConfig()
        self.fault_injector = fault_injector
        self.records: list[StepRecord] = []
        self.events: list[dict] = []
        self.metrics = metrics
        self._c_events = self._h_step = None
        if metrics is not None:
            self._c_events = metrics.counter(
                "smof_fault_events_total",
                "fault-tolerance events, by kind", ("kind",))
            self._h_step = metrics.histogram(
                "smof_fault_step_seconds", "per-step wall clock")

    def _event(self, kind: str, **payload) -> None:
        self.events.append({"kind": kind, **payload})
        if self._c_events is not None:
            self._c_events.labels(kind=kind).inc()

    # -- recovery ---------------------------------------------------------------
    def try_restore(self, template: Any, shardings: Any = None
                    ) -> tuple[Any, int]:
        """(state, next_step) from the newest checkpoint, or (template, 0);
        the state's leaves on the template leaves' devices, or laid out by
        ``shardings`` (a tree of ``NamedSharding``)."""
        step = self.store.latest_step()
        if step is None:
            return template, 0
        state, extra = self.store.restore(template, step, shardings=shardings)
        self._event("restore", step=step)
        return state, int(extra.get("next_step", step + 1))

    # -- main loop ----------------------------------------------------------------
    def run(self, state: Any, batches: Callable[[int], Any], *,
            start_step: int, num_steps: int) -> Any:
        wall: list[float] = []
        step = start_step
        end = start_step + num_steps
        while step < end:
            batch = batches(step)
            t0 = time.monotonic()
            retries = 0
            while True:
                try:
                    if self.fault_injector is not None:
                        self.fault_injector(step)
                    new_state = self.step_fn(state, batch)
                    break
                except Exception as e:  # noqa: BLE001 — injected/transient
                    retries += 1
                    self._event("retry", step=step, error=str(e),
                                attempt=retries)
                    if retries > self.cfg.max_retries:
                        state, step = self._recover(state)
                        batch = batches(step)
                        retries = 0
            dt = time.monotonic() - t0
            is_straggler = (len(wall) >= 5
                            and dt > self.cfg.straggler_factor * median(wall))
            if is_straggler:
                self._event("straggler", step=step, wall_s=dt,
                            median_s=median(wall))
            wall.append(dt)
            if self._h_step is not None:
                self._h_step.observe(dt)
            self.records.append(StepRecord(step, dt, retries, is_straggler))
            state = new_state
            step += 1
            if step % self.cfg.checkpoint_every == 0:
                self.store.save_async(step, state, {"next_step": step})
                self._event("checkpoint", step=step)
        self.store.wait()
        return state

    def _recover(self, state: Any) -> tuple[Any, int]:
        """Exhausted retries: roll back to the newest checkpoint (the
        reference reads the directory while an async save may still be in
        flight; the port waits for it first)."""
        self.store.wait()
        latest = self.store.latest_step()
        if latest is None:
            self._event("recover_failed_no_ckpt")
            raise RuntimeError("step keeps failing and no checkpoint exists")
        restored, extra = self.store.restore(state, latest)
        nxt = int(extra.get("next_step", latest + 1))
        self._event("rollback", to_step=nxt)
        return restored, nxt


def elastic_remesh(make_mesh: Callable[[], Any],
                   make_shardings: Callable[[Any], Any],
                   store: CheckpointStore, template: Any) -> tuple[Any, Any, int]:
    """Rebuild mesh + shardings for the CURRENT device population and
    restore the newest checkpoint into that layout."""
    mesh = make_mesh()
    shardings = make_shardings(mesh)
    step = store.latest_step()
    if step is None:
        return mesh, template, 0
    state, extra = store.restore(template, step, shardings=shardings)
    return mesh, state, int(extra.get("next_step", step + 1))
