"""The pipelined executor: a plan's stages overlap over a microbatch stream.

The counterpart of the reference package's ``runtime/streamer/pipeline.py``.
``lower_plan_pipelined`` consumes the same ``core.plan.ExecutionPlan`` (and
the same per-vertex lowering, via ``runtime.executor.analyze_plan`` /
``run_vertices``) as the staged executor, but runs the plan's stages as a
software 1F1B pipeline over ``B`` microbatches, on one device: a loop over
``T = B + S - 1`` ticks.  The carry holds, per stage-crossing edge, a shift
register of the *encoded* spill (BFP8 mantissas + shared exponents for
``bfp8`` streams, raw words otherwise): stage ``i`` pushes microbatch
``b``'s encoded spill while stage ``i+1`` decodes microbatch ``b-1`` from
the other end — the paper's two DMA-burst FIFOs as a tick carry.  Every
stage reads the previous tick's carry, so within a tick the stages are
data-independent.  Every stage runs at every tick, bubbles included, as in
the reference.

A crossing payload goes through the same :class:`OffchipHop` as a staged
spill: on a CUDA device each shift-register slot is a set of pinned host
buffers, so an encoded crossing lives off the device between its two
stages.

Numerics are identical to the staged executor per microbatch: the same
codec functions run in the same composition (pad -> quantise -> dequantise
-> slice), only *when* they run changes.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Callable

import torch

from ...core.graph import Graph
from ...core.plan import ExecutionPlan, PlanValidationError
from ...core.resources import ALL_DEVICES
from ...kernels.streamed_matmul import _round_up
from ...memory import ChannelConfig, MemoryModel, build_memory_model
from ...obs.modelcheck import ModelCheck, check_stream
from ...obs.stream import StreamTracer
from ...obs.trace import NULL_RECORDER
from ..executor import (BFP8_BLOCK, TEMPORAL_KINDS, OffchipHop, PlanAnalysis,
                        SpillReport, _exec_spec, _spill_slots, analyze_plan,
                        bfp8_spill_decode, bfp8_spill_encode, init_params,
                        resolve_kernel_mode, run_vertices)
from . import queues as Q
from . import schedule as SCH

PLACEMENTS = ("auto", "interleave", "shard_map")


# =============================================================================
# StreamReport
# =============================================================================

@dataclasses.dataclass
class StreamReport(SpillReport):
    """SpillReport plus the pipeline's schedule/occupancy accounting.

    The spill records (and therefore all bit volumes) are the *same objects*
    the staged executor would report for this plan — per microbatch,
    bit-exact — with the pipeline view stacked on top: per-stage occupancy
    and stall (bubble) counts, per-queue high-water marks, and the Eq. 5 vs
    Eq. 6 frame-time estimates from the stage latency model, so benchmarks
    can show which stage sets ``max_j(L_j)``.
    """
    n_stages: int = 1
    microbatches: int = 1
    ticks: int = 1
    placement: str = "interleave"
    stage_occupancy: list[float] = dataclasses.field(default_factory=list)
    stage_stalls: list[int] = dataclasses.field(default_factory=list)
    stage_latency: list[float] = dataclasses.field(default_factory=list)
    queue_stats: dict = dataclasses.field(default_factory=dict)
    #: the off-chip channel view (``repro_torch.memory``) when the plan was
    #: lowered with a :class:`~repro_torch.memory.ChannelConfig`; ``None``
    #: keeps every contended property degrading to its uncontended twin.
    memory: MemoryModel | None = None

    @property
    def eq5_time(self) -> float:
        """Sequential frame time: sum of stage latencies (Eq. 5)."""
        return SCH.eq5_sequential_time(self.stage_latency)

    @property
    def eq6_time(self) -> float:
        """Pipelined steady-state frame time: slowest stage (Eq. 6)."""
        return SCH.eq6_pipeline_time(self.stage_latency)

    @property
    def bottleneck_stage(self) -> int:
        return max(range(len(self.stage_latency)),
                   key=lambda j: self.stage_latency[j])

    # -- contended (channel-arbitrated) views --------------------------------
    @property
    def stage_latency_contended(self) -> list[float]:
        """``max(L_j, X_j)`` per stage; ``stage_latency`` without a model."""
        if self.memory is None:
            return list(self.stage_latency)
        return list(self.memory.contended_latencies)

    @property
    def eq5_contended_time(self) -> float:
        return SCH.eq5_sequential_time(self.stage_latency_contended)

    @property
    def eq6_contended_time(self) -> float:
        return SCH.eq6_pipeline_time(self.stage_latency_contended)

    @property
    def contention_stall_cycles(self) -> list[float]:
        """Per-stage channel-stall cycles per frame (empty: no model)."""
        return [] if self.memory is None else list(self.memory.stall_cycles)

    @property
    def prefetch_deadline_misses(self) -> int:
        return 0 if self.memory is None else self.memory.prefetch.deadline_misses

    @property
    def channel_policy(self) -> str | None:
        return None if self.memory is None else self.memory.config.policy

    def summary(self) -> dict:
        out = super().summary()
        out.update({
            "n_stages": self.n_stages,
            "microbatches": self.microbatches,
            "ticks": self.ticks,
            "placement": self.placement,
            "stage_occupancy": self.stage_occupancy,
            "stage_stalls": self.stage_stalls,
            "eq5_time": self.eq5_time,
            "eq6_time": self.eq6_time,
            "bottleneck_stage": self.bottleneck_stage,
        })
        if self.memory is not None:
            out.update({
                "channel_policy": self.channel_policy,
                "eq5_contended_time": self.eq5_contended_time,
                "eq6_contended_time": self.eq6_contended_time,
                "contention_stall_cycles": self.contention_stall_cycles,
                "prefetch_deadline_misses": self.prefetch_deadline_misses,
                "memory": self.memory.summary(),
            })
        return out


# =============================================================================
# Encoded carry codecs (the queue payload)
# =============================================================================

def _codec_pair(codec: str, shape: tuple[int, int], *, use_kernels: bool,
                device: torch.device):
    """(encode, decode, zero_template, slot_specs) for one crossing edge's
    payload, a tuple of tensors.

    ``bfp8``: the carry holds the actual spill buffers (int8 mantissas +
    per-block int8 shared exponents), built from the *same* encode/decode
    halves the staged executor composes into ``_bfp8_roundtrip`` — the two
    executors' codec numerics are one implementation.  Everything else
    carries raw words (lossless codecs shrink bits, not numbers).  The zero
    template, what a stage reads before its producer has run, lies on
    ``device``; ``slot_specs`` are the payload's (shape, dtype)s.
    """
    m, c = shape
    if codec == "bfp8":
        c_pad = _round_up(c, BFP8_BLOCK)
        specs = [((m, c_pad), torch.int8),
                 ((m, c_pad // BFP8_BLOCK), torch.int8)]
        enc = functools.partial(bfp8_spill_encode, use_kernels=use_kernels)
        dec = functools.partial(bfp8_spill_decode, c=c,
                                use_kernels=use_kernels)
    else:
        specs = [((m, c), torch.float32)]
        enc = lambda y: (y,)                                  # noqa: E731
        dec = lambda p: p[0]                                  # noqa: E731
    zero = tuple(torch.zeros(s, dtype=dt, device=device) for s, dt in specs)
    return enc, dec, zero, specs


# =============================================================================
# Stage splitting
# =============================================================================

def _stage_names(an: PlanAnalysis) -> list[list[str]]:
    """Vertices per stage, in graph topological order (the deterministic
    schedule the streamer needs — plan.stage_layers agrees when the plan
    carries its topo_order)."""
    n = an.n_stages
    names: list[list[str]] = [[] for _ in range(n)]
    for v in an.topo:
        names[an.stage_of[v]].append(v)
    for j, ns in enumerate(names):
        if not ns:
            raise PlanValidationError(
                f"stage {j} is empty — plan stages must be "
                f"contiguous 0..{n - 1}")
    return names


def _crossing_edges(g: Graph, an: PlanAnalysis) -> list[tuple[str, str]]:
    out = []
    for e in g.edges():
        d = an.stage_of[e.dst] - an.stage_of[e.src]
        if d < 0:
            raise PlanValidationError(
                f"edge {(e.src, e.dst)} goes backwards across "
                f"stages ({an.stage_of[e.src]} -> "
                f"{an.stage_of[e.dst]})")
        if d > 0:
            out.append((e.src, e.dst))
    return out


def _make_stage_fns(g: Graph, an: PlanAnalysis, names: list[list[str]],
                    crossing: list[tuple[str, str]], hop: OffchipHop, enc):
    """Per-stage callables with a uniform signature.

    ``fn_j(params, x, reads) -> (produced, y)`` where ``reads`` maps every
    crossing edge to its decoded value (stage ``j`` only touches the ones it
    consumes), ``produced`` maps each crossing edge stage ``j`` produces to
    its encoded payload on the device, and ``y`` is the graph output
    (``None`` on a stage that does not hold the output vertex).
    """
    out_vertex = an.topo[-1]
    produced_by = {e: an.stage_of[e[0]] for e in crossing}

    def make(j: int):
        mine = set(names[j])

        def fn(params, x, reads):
            # the same payload-routed vertex loop the staged executor runs
            # (fused BFP8 codec on the kernel route, spill_fn round-trips
            # on the reference route); crossing reads arrive pre-decoded
            values, payloads = run_vertices(
                g, an, params, x, hop, names=names[j],
                external=reads.__getitem__, keep_all=False)
            produced = {}
            for e in crossing:
                if produced_by[e] == j:
                    # a kernel-route producer already emitted this edge's
                    # spill payload (fused egress where _lower_vertex
                    # allowed) — bitwise what enc[e] would compute; a raw
                    # crossing of the same producer carries the value
                    pay = payloads.get(e[0]) if e in an.bfp8_edges else None
                    produced[e] = (pay if pay is not None
                                   else enc[e](values[e[0]]))
            return produced, (values[out_vertex] if out_vertex in mine
                              else None)
        return fn

    return [make(j) for j in range(an.n_stages)]


# =============================================================================
# Lowered streaming pipeline
# =============================================================================

@dataclasses.dataclass
class StreamingExecutor:
    """A pipelined form of one ExecutionPlan.

    ``fn(params, xs)`` maps a ``(B, m, c)`` microbatch stream to ``(B, L)``
    outputs, bit-for-bit the outputs of running the staged executor on each
    microbatch independently (the same codecs run in the same composition).
    ``stage_fns[j](params, x, reads) -> (produced, y)`` runs stage ``j``
    once, with its crossing payloads sent off-chip (``produced`` holds their
    handles, ``_decoders`` bring one back decoded) — the sequential
    decomposition the pipeline overlaps, used by
    :func:`measured_stage_latencies`.
    """
    fn: Callable[[dict, torch.Tensor], torch.Tensor]
    params: dict[str, torch.Tensor]
    report: StreamReport
    plan: ExecutionPlan | None
    graph_name: str
    n_stages: int
    microbatches: int
    placement: str
    device: torch.device
    stage_fns: list[Callable]
    _zero_reads: Callable[[], dict]
    _decoders: dict
    _crossing: list[tuple[str, str]]
    schedule: SCH.PipelineSchedule | None = None
    _tick_fn: Callable | None = None
    _carry0: Callable[[], dict] | None = None
    _queue_specs: dict = dataclasses.field(default_factory=dict)
    _stage_of: dict = dataclasses.field(default_factory=dict)
    _stream_shape: tuple = ()

    def __call__(self, xs: torch.Tensor) -> torch.Tensor:
        return self.fn(self.params, xs)

    def zero_reads(self) -> dict:
        """A zeros-filled decoded-reads template (for driving stage_fns)."""
        return self._zero_reads()

    def run_traced(self, xs: torch.Tensor, recorder=NULL_RECORDER, *,
                   measure_stages: bool = True, repeats: int = 3,
                   warmup: int = 1,
                   metrics=None) -> tuple[torch.Tensor, ModelCheck]:
        """Run the pipeline tick by tick, narrating each tick into a trace.

        Same tick body as ``fn`` — the only change is that the host waits
        for the device at every tick boundary, so outputs are bit-for-bit
        ``fn``'s.  Per tick the host records the wall-clock interval, the
        :class:`~repro_torch.obs.stream.StreamTracer` emits the tick/stage
        spans and walks the bounded queues, and the spill counters account
        each crossing's off-chip bytes.  Returns the ``(B, L)`` outputs plus
        a :class:`~repro_torch.obs.modelcheck.ModelCheck` comparing the walk
        (and, with ``measure_stages``, per-stage times via
        :func:`measured_stage_latencies`) against Eq. 5/6 and Eq. 1.

        Instrumentation is host-side only, at tick boundaries: with the
        default ``NULL_RECORDER`` every hook is a no-op.  With a ``metrics``
        :class:`~repro_torch.obs.metrics.MetricsRegistry`, the run also
        feeds the scrape surface: per-phase ``smof_stream_ticks_total``,
        ``smof_stream_frames_total``, per-edge queue occupancy and stall
        metrics (through the rings) and ``smof_spill_bytes_total``.
        """
        if tuple(xs.shape) != self._stream_shape:
            raise ValueError(
                f"microbatch stream shape {tuple(xs.shape)} does not match "
                f"the lowered {self._stream_shape} for {self.graph_name!r}")
        sched = self.schedule
        queues = Q.build_queues(self._queue_specs, recorder, metrics)
        tracer = StreamTracer(recorder, sched, queues=queues,
                              stage_of=self._stage_of,
                              spill_records=self.report.spills)
        def sync():
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        # warm-up on a throwaway carry, so tick 0's span measures the tick
        # and not the kernel library's first load
        self._tick_fn(self.params, self._carry0(), 0, xs)
        sync()

        mem = self.report.memory
        stalls = mem.stall_cycles if mem is not None else []
        carry = self._carry0()
        ys = []
        steady_durs: list[float] = []
        for t in range(sched.ticks):
            ts = recorder.now()
            t0 = time.perf_counter()
            carry, y = self._tick_fn(self.params, carry, t, xs)
            sync()
            dur = time.perf_counter() - t0
            ys.append(y)
            tracer.tick(t, ts=ts, dur=dur)
            if sched.phase(t) == "steady":
                steady_durs.append(dur)
            # narrate where the channel model says compute waits on the
            # shared port this tick (stall > 0 for an active stage)
            for j in sched.active_stages(t):
                if j < len(stalls) and stalls[j] > 0:
                    recorder.instant(f"contention:stage{j}", ts,
                                     track=f"stage{j}")
        acct = tracer.finish()
        if metrics is not None:
            self._record_metrics(metrics, acct)

        stage_s = None
        if measure_stages:
            stage_s = measured_stage_latencies(
                self, xs[0], repeats=repeats, warmup=warmup)
        steady_s = None
        if steady_durs:
            steady_durs.sort()
            steady_s = steady_durs[len(steady_durs) // 2]
        mc = check_stream(self.report, stage_seconds=stage_s,
                          queue_stats=acct["queues"],
                          ticks_measured=acct["ticks_run"],
                          steady_measured=acct["phase_ticks"]["steady"],
                          steady_tick_seconds=steady_s)
        return torch.stack(ys[self.n_stages - 1:]), mc

    def _record_metrics(self, metrics, acct: dict) -> None:
        """Feed one traced run's accounting into a MetricsRegistry.

        Queue occupancy/stall metrics update live inside the rings (they
        were built with the registry); what is left to record at run end
        are tick counts and the per-edge off-chip spill volume — each
        spill record moves ``offchip_bits`` once per microbatch, the same
        totals ``StreamTracer`` accumulates on the recorder.
        """
        ticks = metrics.counter(
            "smof_stream_ticks_total",
            "pipeline ticks walked, by 1F1B phase", ("phase",))
        for phase, n in acct["phase_ticks"].items():
            if n:
                ticks.labels(phase=phase).inc(n)
        metrics.counter(
            "smof_stream_frames_total",
            "microbatch frames retired by the pipelined streamer",
        ).inc(self.microbatches)
        spill = metrics.counter(
            "smof_spill_bytes_total",
            "off-chip spill traffic in bytes, by edge and direction",
            ("edge", "direction"))
        for r in self.report.spills:
            nbytes = (r.offchip_bits // 8) * self.microbatches
            if nbytes:
                edge = f"{r.src}->{r.dst}"
                spill.labels(edge=edge, direction="evict").inc(nbytes)
                spill.labels(edge=edge, direction="restore").inc(nbytes)
        mem = self.report.memory
        if mem is not None:
            stall = metrics.counter(
                "smof_contention_stall_cycles_total",
                "model cycles compute stalls on the shared off-chip "
                "channel, by stage", ("stage",))
            for j, c in enumerate(mem.stall_cycles):
                # one frame's stall per microbatch the stage processed
                if c > 0 and math.isfinite(c):
                    stall.labels(stage=str(j)).inc(c * self.microbatches)
            misses = mem.prefetch.deadline_misses
            if misses:
                metrics.counter(
                    "smof_prefetch_deadline_misses_total",
                    "weight prefetch slots that missed their stage-start "
                    "deadline").inc(misses)


def stage_weight_bits(g: Graph, an: PlanAnalysis) -> dict[int, int]:
    """Streamed weight bits per stage, mirroring ``analyze_plan``'s
    per-layer rounding exactly so the per-stage sums equal
    ``streamed_weight_bits`` bit-for-bit (the channel model's byte
    conservation depends on it)."""
    out = {j: 0 for j in range(an.n_stages)}
    for name, f in an.frac.items():
        v = g.vertex(name)
        spec = _exec_spec(g, name)
        if v.kind in TEMPORAL_KINDS:
            wbits = spec.get("taps", 3) * spec["cout"] * v.weight_bits
        else:
            wbits = spec["cin"] * spec["cout"] * v.weight_bits
        out[an.stage_of[name]] += int(round((1.0 - f) * wbits))
    return out


def _resolve_channel_device(channel: ChannelConfig,
                            device, plan: ExecutionPlan
                            ) -> tuple[float, float] | None:
    """(gbps, freq_mhz) for the channel model, or ``None`` when nothing
    prices the port.  Resolution order: the config's explicit override,
    then the ``device`` argument (a registry name or a ``Device``-like
    object), then the plan's recorded device name."""
    dev = None
    if isinstance(device, str):
        dev = ALL_DEVICES.get(device)
    elif device is not None:
        dev = device
    if dev is None:
        dev = ALL_DEVICES.get(plan.device)
    if dev is not None:
        gbps = channel.gbps if channel.gbps is not None else dev.offchip_gbps
        return gbps, dev.freq_mhz
    if channel.gbps is not None:
        return channel.gbps, 200.0      # Device's default clock
    return None


def _spill_inside_stage(g: Graph, an: PlanAnalysis, key) -> bool:
    """Whether a staged spill slot (``_spill_slots``: a producer's BFP8
    payload, or one edge) has a consumer in its producer's stage; a
    crossing consumer reads from the crossing's shift register instead."""
    if isinstance(key, str):
        return any(an.stage_of[s] == an.stage_of[key]
                   for s in g.successors(key) if (key, s) in an.bfp8_edges)
    return an.stage_of[key[0]] == an.stage_of[key[1]]


def lower_plan_pipelined(g: Graph, plan: ExecutionPlan, *,
                         microbatches: int | None = None,
                         kernel_mode: str = "auto", seed: int = 0,
                         placement: str = "auto",
                         channel: ChannelConfig | None = None,
                         channel_device=None,
                         device: str | torch.device = "cuda"
                         ) -> StreamingExecutor:
    """Lower ``plan`` over ``g`` to a pipelined multi-microbatch executor on
    the torch ``device``.

    microbatches: length ``B`` of the input stream (defaults to
    ``plan.microbatch``, floored at 1).
    placement: "interleave" (every stage on one device, the tick loop) or
    "auto" (the same); "shard_map", one stage per device, is not ported
    (ROADMAP.md, Queue 1, item 10).
    channel: opt-in off-chip channel model (``repro_torch.memory``): the
    plan's streams are arbitrated over the shared port, queue capacities
    absorb the arbiter-derived crossing delays, and the report carries the
    contended Eq. 5/6 bounds plus the prefetch deadline accounting.
    channel_device: registry name or ``Device`` pricing the channel
    (defaults to ``plan.device``); without a resolvable device *and* no
    explicit gbps override the channel model is skipped.
    """
    if placement not in PLACEMENTS:
        raise ValueError(f"unknown placement {placement!r}")
    if placement == "shard_map":
        raise NotImplementedError(
            'placement="shard_map" (one stage per GPU) is not ported yet; '
            "see ROADMAP.md, Queue 1, item 10")
    placement = "interleave"
    device = torch.device(device)
    use_kernels = resolve_kernel_mode(kernel_mode, device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    B = int(microbatches if microbatches is not None
            else max(plan.microbatch, 1))
    if B < 1:
        raise ValueError(f"need >= 1 microbatch, got {B}")

    an = analyze_plan(g, plan, use_kernels=use_kernels)
    S = an.n_stages
    names = _stage_names(an)
    crossing = _crossing_edges(g, an)
    sched = SCH.build_schedule(S, B)

    stream_map = {(s.src, s.dst): s for s in plan.streams}
    codec_of = {e: (stream_map[e].codec
                    if e in stream_map and stream_map[e].evicted else "none")
                for e in crossing}
    delay = {e: an.stage_of[e[1]] - an.stage_of[e[0]] for e in crossing}
    enc: dict = {}
    dec: dict = {}
    zeros: dict = {}
    slots = {k: v for k, v in _spill_slots(an).items()
             if _spill_inside_stage(g, an, k)}
    for e in crossing:
        enc[e], dec[e], zeros[e], specs = _codec_pair(
            codec_of[e], an.out_shape[e[0]], use_kernels=use_kernels,
            device=device)
        # one slot of the shift register per tick of delay
        for i in range(delay[e]):
            slots[("crossing", e, i)] = specs
    hop = OffchipHop(device, slots)
    stage_fns = _make_stage_fns(g, an, names, crossing, hop, enc)
    out_len = sum(an.out_shape[e.src][0] * an.out_shape[e.src][1]
                  for e in g.in_edges(an.topo[-1]))

    def read(e, slot) -> torch.Tensor:
        """Decode one shift-register slot (a zero template on the device
        until its producer has run, then an off-chip handle)."""
        return dec[e](slot if slot is zeros[e] else hop.restore(slot))

    def run_stage(params, j: int, x, reads, t: int):
        """Stage ``j`` at tick ``t``: its crossing payloads leave for slot
        ``t % delay`` of their shift registers."""
        produced, y = stage_fns[j](params, x, reads)
        return {e: hop.evict(("crossing", e, t % delay[e]), p)
                for e, p in produced.items()}, y

    def make_carry0() -> dict:
        return {e: [zeros[e]] * delay[e] for e in crossing}

    # the tick body is shared between the stream (forward) and the traced
    # loop (StreamingExecutor.run_traced): one definition, so the traced
    # run cannot drift numerically from the fast path.  At tick t every
    # stage reads the oldest slot of each shift register (written at tick
    # t - delay, or the zero template) before any stage pushes; a push
    # reuses the slot just read, after the read on the same stream.
    @torch.no_grad()
    def tick_body(params, carry, t: int, xs):
        x_t = xs[min(t, B - 1)]
        reads = {e: read(e, carry[e][-1]) for e in crossing}
        produced: dict = {}
        y = None
        for j in range(S):
            prod_j, y_j = run_stage(params, j, x_t if j == 0 else None,
                                    reads, t)
            produced.update(prod_j)
            if j == S - 1:
                y = y_j
        del reads
        if y is None:
            y = torch.zeros((out_len,), dtype=torch.float32, device=device)
        return {e: [produced[e]] + carry[e][:-1] for e in crossing}, y

    def forward(params, xs):
        if tuple(xs.shape) != (B,) + an.in_shape:
            raise ValueError(
                f"microbatch stream shape {tuple(xs.shape)} does not match "
                f"the lowered ({B}, *{an.in_shape}) for {g.name!r}")
        carry = make_carry0()
        ys = []
        for t in range(sched.ticks):
            carry, y = tick_body(params, carry, t, xs)
            if t >= S - 1:
                ys.append(y)
        return torch.stack(ys)

    # -- report: schedule + bounded-queue accounting --------------------------
    lat = SCH.stage_latencies(g, plan)
    mem = None
    if channel is not None:
        priced = _resolve_channel_device(channel, channel_device, plan)
        if priced is not None:
            gbps, freq_mhz = priced
            mem = build_memory_model(
                spills=an.spills,
                weight_bits_by_stage=stage_weight_bits(g, an),
                stage_of=an.stage_of, base_latencies=lat,
                gbps=gbps, freq_mhz=freq_mhz, config=channel,
                microbatches=B)
    specs = Q.queue_specs(
        g, an.stage_of, an.out_shape, codec_of,
        extra_delay=(mem.extra_queue_delay() if mem is not None else None))
    sim = SCH.simulate_schedule(
        sched, Q.build_queues(specs),
        producer_stage={e: an.stage_of[e[0]] for e in specs},
        consumer_stage={e: an.stage_of[e[1]] for e in specs})
    base = an.report()
    report = StreamReport(
        spills=base.spills, streamed_weight_bits=base.streamed_weight_bits,
        static_weight_bits=base.static_weight_bits,
        n_stages=S, microbatches=B, ticks=sched.ticks, placement=placement,
        stage_occupancy=sim["stage_occupancy"],
        stage_stalls=sim["stage_stalls"], stage_latency=lat,
        queue_stats={f"{u}->{w}": st
                     for (u, w), st in sim["queues"].items()},
        memory=mem)

    def zero_reads():
        return {e: dec[e](zeros[e]) for e in crossing}

    def stage_call(j, params, x, reads):
        with torch.no_grad():
            return run_stage(params, j, x, reads, 0)

    return StreamingExecutor(
        fn=forward, params=init_params(g, seed=seed, device=device),
        report=report, plan=plan, graph_name=g.name, n_stages=S,
        microbatches=B, placement=placement, device=device,
        stage_fns=[functools.partial(stage_call, j) for j in range(S)],
        _zero_reads=zero_reads,
        _decoders={e: functools.partial(read, e) for e in crossing},
        _crossing=crossing, schedule=sched, _tick_fn=tick_body,
        _carry0=make_carry0, _queue_specs=specs,
        _stage_of=dict(an.stage_of), _stream_shape=(B,) + an.in_shape)


# =============================================================================
# Measured per-stage latencies (the Eq. 5/6 hook, measured edition)
# =============================================================================

def measured_stage_latencies(sx: StreamingExecutor, x: torch.Tensor, *,
                             repeats: int = 5, warmup: int = 2
                             ) -> list[float]:
    """Seconds per stage, each stage run on its own (median of
    ``repeats``): CUDA events around the stage on a CUDA device, the host
    clock on the CPU.

    This is what the *sequential* schedule pays per frame: each stage is a
    separate dispatch fed through the decoded reads.  Feeding stage ``j+1``
    with stage ``j``'s real outputs keeps shapes and codec work identical to
    the pipeline's steady state.  Plug the result into the Eq. 5/6
    estimators to place measured pipeline throughput between the
    sequential sum and the slowest-stage bound.
    """
    on_cuda = sx.device.type == "cuda"
    reads = sx.zero_reads()
    lat: list[float] = []
    for j, fn in enumerate(sx.stage_fns):
        x_j = x if j == 0 else None

        def timed():
            if on_cuda:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                out = fn(sx.params, x_j, reads)
                b.record()
                b.synchronize()
                return out, a.elapsed_time(b) / 1e3
            t0 = time.perf_counter()
            out = fn(sx.params, x_j, reads)
            return out, time.perf_counter() - t0

        for _ in range(warmup):
            timed()
        times = []
        for _ in range(repeats):
            (prod, _), s = timed()
            times.append(s)
        times.sort()
        lat.append(times[len(times) // 2])
        # thread this stage's real (decoded) outputs into the next reads
        for e, handle in prod.items():
            reads[e] = sx._decoders[e](handle)
    return lat
