"""Pipelined streaming executor — overlap partition stages, double-buffer
off-chip spills.

The staged executor (``runtime/executor.py``) runs a plan's stages one
after another on one input at a time, so every evicted stream pays its full
off-chip round trip on the critical path and the executed time tracks
Eq. 5's sequential sum.  This subsystem runs the *same*
``core.plan.ExecutionPlan`` as a coarse software pipeline over a stream of
microbatches — stage ``j`` processes microbatch ``b`` while stage ``j+1``
processes ``b-1`` — so steady-state throughput tracks Eq. 6's
``1/max_j(L_j)`` slowest-stage model instead.

The documented entry point is the compile façade —
``repro_torch.compile(CompileSpec(mode="pipelined", ...))`` — which lowers
through :func:`lower_plan_pipelined`; the names below remain public for
direct use.

Lowering and execution (``pipeline.py``)
    ``lower_plan_pipelined(g, plan, *, microbatches, kernel_mode, seed,
    placement, channel, channel_device, device, devices)`` ->
    ``StreamingExecutor``: ``sx(xs)`` maps a ``(B, m, c)`` stream to
    ``(B, L)`` outputs, bit for bit what the staged executor produces per
    microbatch; a tick loop whose carry holds, per stage-crossing edge, the
    *encoded* spill in pinned host memory.  Every stage runs on one device
    (``"interleave"``) or, in the reference's ring (``"shard_map"``), one
    stage per device, each on a CUDA stream of its own.  ``sx.run_traced(xs, recorder)`` runs the same
    tick body tick by tick into an ``repro_torch.obs`` recorder and
    returns a ``ModelCheck``.  ``StreamReport`` is the ``SpillReport``
    plus the schedule view; ``measured_stage_latencies`` times each stage
    on its own.

Schedule and latency model (``schedule.py``)
    ``build_schedule`` / ``PipelineSchedule`` (the 1F1B diagram, ``T = B +
    S - 1`` ticks), ``stage_latencies``, the Eq. 5/6 estimators and their
    contended twins, ``simulate_schedule``.

Bounded inter-stage queues (``queues.py``)
    ``queue_specs`` / ``QueueSpec`` (Eq. 1 capacities per crossing edge),
    ``build_queues`` / ``RingBuffer``.
"""
from .pipeline import (PLACEMENTS, StreamingExecutor, StreamReport,
                       lower_plan_pipelined, measured_stage_latencies,
                       stage_weight_bits)
from .queues import QueueSpec, RingBuffer, build_queues, queue_specs
from .schedule import (PipelineSchedule, StageTask, build_schedule,
                       eq5_contended_time, eq5_sequential_time,
                       eq6_contended_time, eq6_pipeline_time,
                       simulate_schedule, stage_latencies)

__all__ = [n for n in dir() if not n.startswith("_")]
