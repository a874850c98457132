"""The serving front ends of the port: the LM decode engine with continuous
batching and BFP8 KV-page eviction, and the graph stream server.

The counterparts of the reference package's ``serving/engine.py``.

:class:`ServingEngine`: requests enter a queue and are packed into fixed
decode slots (continuous batching — a finished request's slot is refilled
at the next step); each prompt is prefilled on its own into its slot, and
decode advances all slots in lockstep.  The paper's activation eviction
shows up as cache-page eviction: a finished request's pages (one per cache
leaf: attention's KV, a Mamba, mLSTM or sLSTM layer's recurrent state)
stay parked in device memory while ``resident_limit`` allows, and older page-sets spill to
the host oldest-first through the BFP8 codec (the host-side
``core.compression`` copy, as in the reference), so the eviction order is
the retirement order.  ``restore_request`` brings them back, exactly from
the device, through the BFP8 decode from the host.  On the kernel route
the prefill attention runs the ``flash_attention`` kernel on the card.

:class:`GraphStreamServer`: a batched front end that packs submitted frames
into fixed-length microbatch streams and runs them through the pipelined
streaming executor (``runtime/streamer``).  On a CUDA device a stream's
frames are stacked into one tensor on the card, and the host waits for the
stream's results before it reads the clock for the latency histogram and
the SLO window: without that wait the clock would read the launches, not
the work.  ``GraphStreamServer.autotuned`` runs the closed-loop autotuner
(``repro_torch.optim.autotune``) first, every candidate through the
pipelined streamer, and serves the measured-best plan.
"""
from __future__ import annotations

import collections
import dataclasses
import queue
import time
from typing import Callable

import numpy as np
import torch

from ..core.compression import bfp8_decode, bfp8_encode
from ..models import decode_step, forward, init_cache, project_logits
from ..models.config import ArchConfig
from ..obs.metrics import MetricsRegistry
from ..runtime.executor import resolve_kernel_mode


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                    # (S,) int32
    max_new_tokens: int = 16
    eos: int | None = None
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False


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


class EngineStats(_RegistryStats):
    """Live view of the decode engine's counters (see ``_RegistryStats``)."""

    _PREFIX = "smof_engine_"

    @property
    def prefills(self) -> int:
        return self._value("smof_engine_prefills_total")

    @property
    def decode_steps(self) -> int:
        return self._value("smof_engine_decode_steps_total")

    @property
    def generated(self) -> int:
        return self._value("smof_engine_generated_tokens_total")

    @property
    def evicted_pages(self) -> int:
        return self._value("smof_engine_evicted_pages_total")

    @property
    def restored_pages(self) -> int:
        return self._value("smof_engine_restored_pages_total")

    @property
    def evicted_bytes_raw(self) -> int:
        return self._value("smof_engine_evicted_bytes_total", kind="raw")

    @property
    def evicted_bytes_compressed(self) -> int:
        return self._value("smof_engine_evicted_bytes_total",
                           kind="compressed")


def _page_names(cache: dict):
    """Each cache leaf as (``"/"``-joined tree path, tensor): the
    reference's page names (``pos_0/k`` ...)."""
    for pj, leaves in cache.items():
        for n, t in leaves.items():
            yield f"{pj}/{n}", t


class ServingEngine:
    """Continuous-batching LM decode engine with BFP8 KV-page eviction.

    ``device`` holds the cache and must hold ``params``; nothing moves to
    another device on its own.  ``kernel_mode``, as ``CompileSpec``'s:
    ``"auto"`` (the kernel route: the ``flash_attention`` kernel on a CUDA
    device, its plain version on the CPU), ``"cuda"`` (the kernel route,
    refused off the card) or ``"reference"`` (the plain scan everywhere).
    An encoder-decoder config is refused: the engine has no encoder frames
    to give it (the reference's fails inside its encoder), and it is served
    through ``runtime.steps.make_prefill_step`` / ``make_decode_step``.
    """

    def __init__(self, cfg: ArchConfig, params, *, max_batch: int = 4,
                 s_max: int = 256, dtype=torch.float32,
                 evict_to_host: bool = False, resident_limit: int = 0,
                 sampler: Callable | None = None,
                 metrics: MetricsRegistry | None = None,
                 device: str | torch.device = "cuda",
                 kernel_mode: str = "auto"):
        if cfg.is_encdec:
            raise ValueError(f"{cfg.name} is an encoder-decoder: the engine "
                             f"takes no encoder frames; serve it through "
                             f"runtime.steps.make_prefill_step and "
                             f"make_decode_step")
        self.cfg = cfg
        self.params = params
        self.device = torch.device(device)
        self.use_kernels = resolve_kernel_mode(kernel_mode, self.device)
        held = params["embed"].device
        if held.type != self.device.type:
            raise ValueError(f"params lie on {held}, the engine serves on "
                             f"{self.device}")
        if self.device.type == "cuda":
            # the reference is pure f32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.B = max_batch
        self.s_max = s_max
        self.dtype = dtype
        self.evict_to_host = evict_to_host
        # retired page-sets allowed to stay parked on the device before the
        # oldest spills to the host (0 = spill immediately on retire)
        self.resident_limit = resident_limit
        self.sampler = sampler or (lambda logits: torch.argmax(logits, -1))
        self.cache = init_cache(cfg, max_batch, s_max, dtype=dtype,
                                device=self.device)
        self.slots: list[Request | None] = [None] * max_batch
        self.pos = np.zeros(max_batch, np.int64)
        self.queue: "queue.Queue[Request]" = queue.Queue()
        # every engine counter lives in one MetricsRegistry (own registry by
        # default so engines never cross-talk); self.stats is a live view
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        m = self.metrics
        self._c_prefills = m.counter(
            "smof_engine_prefills_total", "prompt prefills run")
        self._c_decode = m.counter(
            "smof_engine_decode_steps_total", "lockstep decode steps")
        self._c_generated = m.counter(
            "smof_engine_generated_tokens_total",
            "tokens sampled across all slots")
        self._c_evicted_pages = m.counter(
            "smof_engine_evicted_pages_total",
            "KV pages BFP8-evicted across the HBM -> host boundary")
        self._c_restored_pages = m.counter(
            "smof_engine_restored_pages_total",
            "KV pages restored into HBM (resident or via BFP8 decode)")
        self._c_evicted_bytes = m.counter(
            "smof_engine_evicted_bytes_total",
            "KV eviction traffic in bytes, raw (bf16 words) vs compressed",
            ("kind",))
        self._h_latency = m.histogram(
            "smof_engine_request_latency_seconds",
            "submit -> retire wall clock per request")
        self.stats = EngineStats(m)
        # submit -> retire wall clock per request (log-bucketed)
        self.latency = self._h_latency.labels().hist
        self._submit_ts: dict[int, float] = {}
        self.host_store: dict[int, dict] = {}    # rid -> evicted pages
        # rid -> raw pages still on the device, in retirement order (FIFO)
        self.resident_store: "collections.OrderedDict[int, dict]" = \
            collections.OrderedDict()
        self._next_rid = 0

    # -- request intake ------------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16,
               eos: int | None = None) -> Request:
        r = Request(rid=self._next_rid, prompt=np.asarray(prompt, np.int32),
                    max_new_tokens=max_new_tokens, eos=eos)
        self._next_rid += 1
        self._submit_ts[r.rid] = time.perf_counter()
        self.queue.put(r)
        return r

    # -- slot management -------------------------------------------------------------
    def _fill_slots(self) -> None:
        for b in range(self.B):
            if self.slots[b] is None and not self.queue.empty():
                r = self.queue.get()
                self._prefill(b, r)
                self.slots[b] = r

    def run_prefill(self, prompt: np.ndarray):
        """One prompt through the full forward on this engine's route:
        (logits of its last position (1, vocab), its KV cache of one slot,
        the engine cache's layout with batch 1)."""
        S = len(prompt)
        if S >= self.s_max:
            raise ValueError(f"prompt of {S} tokens does not fit s_max="
                             f"{self.s_max}")
        toks = torch.as_tensor(np.asarray(prompt, np.int64),
                               device=self.device)[None]
        one_cache = init_cache(self.cfg, 1, self.s_max, dtype=self.dtype,
                               device=self.device)
        x, new_cache, _ = forward(self.params, self.cfg, toks,
                                  cache=one_cache,
                                  use_kernels=self.use_kernels)
        return project_logits(self.params, self.cfg, x[:, -1]), new_cache

    def _prefill(self, slot: int, r: Request) -> None:
        """Run the prompt through the full forward, writing slot ``slot``."""
        logits, new_cache = self.run_prefill(r.prompt)
        r.out_tokens.append(int(self.sampler(logits)[0]))
        for (_, c), (_, n) in zip(_page_names(self.cache),
                                  _page_names(new_cache)):
            c[:, slot] = n[:, 0]
        self.pos[slot] = len(r.prompt)
        self._c_prefills.inc()

    def _retire(self, slot: int) -> None:
        r = self.slots[slot]
        if r is not None:
            t0 = self._submit_ts.pop(r.rid, None)
            if t0 is not None:
                self.latency.record(time.perf_counter() - t0)
        if r is not None and self.evict_to_host:
            pages = self._snapshot_slot(slot)
            if self.resident_limit > 0:
                self.resident_store[r.rid] = pages
                while len(self.resident_store) > self.resident_limit:
                    # budget exceeded: spill the OLDEST retired page-set
                    old_rid, old_pages = self.resident_store.popitem(
                        last=False)
                    self._host_evict(old_rid, old_pages)
            else:
                self._host_evict(r.rid, pages)
        self.slots[slot] = None
        self.pos[slot] = 0

    # -- KV eviction (paper Eq. 1/2 at the HBM <-> host level) -----------------------
    def _snapshot_slot(self, slot: int) -> dict:
        """Copy one slot's KV pages out of the decode cache (a copy of its
        own on the device: later steps write the cache in place)."""
        return {name: c[:, slot].clone() for name, c in
                _page_names(self.cache)}

    def _host_evict(self, rid: int, pages: dict) -> None:
        """BFP8-encode a page-set across the device -> host boundary."""
        enc_pages = {}
        for name, page in pages.items():
            page = page.float().cpu().numpy()
            enc = bfp8_encode(page)
            self._c_evicted_bytes.labels(kind="raw").inc(
                page.size * 2)                                 # bf16 words
            self._c_evicted_bytes.labels(kind="compressed").inc(
                enc.mantissas.size + enc.exponents.size)
            enc_pages[name] = enc
        self.host_store[rid] = enc_pages
        self._c_evicted_pages.inc(len(enc_pages))

    def restore_request(self, rid: int, slot: int) -> None:
        """Bring an evicted request's pages back into the cache's slot
        ``slot`` (resumption).  Pages still parked under ``resident_limit``
        restore exactly; pages that crossed to the host come back through
        the BFP8 codec."""
        resident = self.resident_store.pop(rid, None)
        for name, c in _page_names(self.cache):
            if resident is not None:
                page = resident[name]
            else:
                page = torch.from_numpy(bfp8_decode(
                    self.host_store[rid][name]))
            c[:, slot] = page.to(device=c.device, dtype=c.dtype)
            self._c_restored_pages.inc()
        if resident is None:
            del self.host_store[rid]

    # -- decode loop ---------------------------------------------------------------
    def step(self) -> int:
        """One lockstep decode step over all active slots; returns #active."""
        self._fill_slots()
        active = [b for b, s in enumerate(self.slots) if s is not None]
        if not active:
            return 0
        last = np.zeros((self.B, 1), np.int64)
        for b in active:
            last[b, 0] = self.slots[b].out_tokens[-1]
        logits, self.cache = decode_step(
            self.params, self.cfg, torch.as_tensor(last, device=self.device),
            torch.as_tensor(self.pos, device=self.device), self.cache,
            use_kernels=self.use_kernels)
        nxt = self.sampler(logits).cpu().numpy()
        self._c_decode.inc()
        for b in active:
            r = self.slots[b]
            self.pos[b] += 1
            r.out_tokens.append(int(nxt[b]))
            self._c_generated.inc()
            if (len(r.out_tokens) >= r.max_new_tokens
                    or (r.eos is not None and int(nxt[b]) == r.eos)
                    or self.pos[b] >= self.s_max - 1):
                r.done = True
                self._retire(b)
        return len(active)

    def run_until_drained(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if self.step() == 0 and self.queue.empty():
                return

    def metrics_text(self) -> str:
        """Prometheus text exposition of this engine's registry."""
        return self.metrics.metrics_text()


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

    Construction goes through the compile façade (``repro_torch.api``):
    pass a lowered ``StreamingExecutor`` (``executor=``, what
    ``Compiled.serve()`` does, sharing the design's metrics registry), a
    ready :class:`~repro_torch.api.CompileSpec` (``spec=``), or the
    reference's ``(g, plan, microbatches=..., **lowering knobs)`` form,
    which is folded into a ``manual-plan`` pipelined spec (``torch_device``
    is one of the knobs, ``"cuda"`` unless given).
    """

    def __init__(self, g=None, plan=None, *, microbatches: int = 8,
                 executor=None, spec=None,
                 metrics: MetricsRegistry | None = None, slo=None,
                 resident_limit: int = 0, **lower_kw):
        if executor is None:
            from ..api import CompileSpec, compile as smof_compile
            if spec is None:
                spec = CompileSpec(model=g, strategy="manual-plan",
                                   mode="pipelined", plan=plan,
                                   microbatches=microbatches, **lower_kw)
            executor = smof_compile(spec).executor
        self.executor = executor
        self.microbatches = executor.microbatches
        # frames go to the first stage's device, results come from the
        # last stage's: one device, but a ring's two ends
        self.device = executor.device
        self.out_device = executor.out_device
        self._stage_devices = list(dict.fromkeys(executor.devices))
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
        self.slo = slo                       # obs.slo.SloEvaluator | None
        self.autotune_result = None          # set by .autotuned()
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
    def autotuned(cls, g, dev, *, autotune_cfg=None, **lower_kw
                  ) -> "GraphStreamServer":
        """Serve the *measured-best* plan instead of the default DSE plan.

        Compiles ``strategy="autotune"`` through the façade: the closed
        loop (``repro_torch.optim.autotune``) executes every candidate
        through the pipelined streamer on ``autotune_cfg.torch_device``, and
        the server is built around the winning plan at the autotuner's
        microbatch depth.  ``lower_kw`` are further
        :class:`~repro_torch.api.CompileSpec` fields (``kernel_mode``,
        ``torch_device``, ``seed``, ...); without ``autotune_cfg`` the
        search takes the spec's depth, kernel mode, seed and torch device,
        as the façade's default does.  The full
        :class:`~repro_torch.optim.autotune.AutotuneResult` (trajectory +
        calibration report) is kept on ``server.autotune_result``.
        """
        from ..api import CompileSpec, compile as smof_compile
        spec = CompileSpec(model=g, device=dev, strategy="autotune",
                           mode="pipelined", autotune_cfg=autotune_cfg,
                           **lower_kw)
        if autotune_cfg is not None:
            spec.microbatches = autotune_cfg.microbatches
        return smof_compile(spec).serve()

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
        """Wait for the current stream of every device the executor runs
        on (a ring's stage streams are joined into them)."""
        for d in self._stage_devices:
            if d.type == "cuda":
                torch.cuda.current_stream(d).synchronize()

    def flush(self) -> dict[int, torch.Tensor]:
        """Run all queued frames; returns {ticket: output} for this flush.

        Every stream is one tensor on the executor's device (a ring's first
        stage's), its tail zero-padded to ``B`` frames; the outputs lie on
        ``out_device`` (a ring's last stage's).  With an attached SLO evaluator
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

    def roofline_fps(self) -> float | None:
        """The served plan's Eq. 6 throughput bound in frames/s, when the
        plan's provenance carries a calibrated ``s_per_cycle`` (autotuned
        artifacts do): ``1 / (eq6_cycles * s_per_cycle)``."""
        plan = getattr(self.executor, "plan", None)
        spc = plan.provenance.get("s_per_cycle") if plan is not None else None
        eq6 = getattr(self.executor.report, "eq6_time", None)
        if spc and eq6:
            return 1.0 / (eq6 * spc)
        return None

    def enable_slo(self, cfg=None, *, roofline_fps=None, bw_gbps=None,
                   stream_budgets=None):
        """Attach a rolling-window SLO evaluator, re-scored on every flush.

        ``roofline_fps`` defaults to :meth:`roofline_fps` (calibrated plans
        only; DSE plans carry none, and the fps objective is then off);
        ``bw_gbps`` is the device's off-chip budget for the spill-bandwidth
        objective.  ``stream_budgets`` (per-kind Gbps, e.g.
        ``MemoryModel.budget_gbps_by_kind()``) scores the split
        evict/restore objectives against the arbiter's grants; it defaults
        to the executor report's channel model when the plan was lowered
        with one.  Returns the evaluator so callers can hook
        ``on_breach`` (e.g. ``FlightRecorder.on_slo_report``).
        """
        from ..obs.slo import SloEvaluator
        if roofline_fps is None:
            roofline_fps = self.roofline_fps()
        if stream_budgets is None:
            mem = getattr(self.executor.report, "memory", None)
            if mem is not None:
                stream_budgets = mem.budget_gbps_by_kind()
        self.slo = SloEvaluator(cfg, roofline_fps=roofline_fps,
                                bw_gbps=bw_gbps, latency=self.latency,
                                stream_budgets=stream_budgets)
        return self.slo

    def result(self, ticket: int) -> torch.Tensor:
        """Claim a flushed output, on ``out_device`` (one-shot: the
        server does not keep delivered results, so a long-lived front end
        stays bounded).

        Results evicted under ``resident_limit`` restore bit-exactly from
        the host byte store."""
        if ticket in self._host_results:
            raw, shape = self._host_results.pop(ticket)
            self._c_restored_results.inc()
            host = torch.from_numpy(
                np.frombuffer(raw, dtype=np.float32).reshape(shape).copy())
            return host.to(self.out_device)
        return self._results.pop(ticket)
