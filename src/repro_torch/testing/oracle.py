"""Differential conformance oracles over one (graph, plan) case, for the
port.

The reference package's ``testing/oracle.py`` on PyTorch: the same
function, computed by four executors that stream it differently —

* ``reference`` — dense, un-evicted, un-fragmented (``reference_pipeline``);
* ``staged``    — the sequential Eq. 5 executor (``lower_plan``);
* ``pipelined`` — the 1F1B Eq. 6 streamer (``lower_plan_pipelined``);
* ``served``    — ``GraphStreamServer`` over the pipelined executor.

:func:`check_case` asserts the relations the paper's design implies, on the
torch device it is given (the card by default):

``plan_roundtrip``      ``from_json(to_json(plan))`` is the same plan, the
                        re-serialisation is byte-identical, and no keys
                        were dropped.
``lossless_exact``      with every stream codec forced lossless, staged
                        *and* pipelined outputs are bit-exact vs the
                        reference (eviction changes where data lives, not
                        what is computed).  Failures name the first
                        diverging vertex via ``run_intermediates``.
``bfp8_bounded``        with the actual (possibly lossy) plan, staged
                        output is bit-exact when no BFP8 codec is in play
                        and finite + loosely error-bounded when one is.
``staged_vs_pipelined`` staged and 1F1B outputs are bit-exact per
                        microbatch under the same plan.
``kernel_parity``       (cases drawn with the kernel route, the reference's
                        ``kernel_mode="pallas"``) the staged executor on the
                        kernel route against the staged reference route,
                        per frame.  On the CPU the kernel route runs the
                        kernels' plain versions: bit for bit.  On the card
                        it runs the CUDA kernels, which sum in other orders
                        than ``torch.matmul`` and ``mean`` (the 3xTF32
                        products, the pool's tree); one ulp before a BFP8
                        encode can move a mantissa by one step of its
                        block's scale, and chained encodes compound such
                        steps.  So there two checks hold, as in
                        ``chip_smoke.py``: every vertex against its plain
                        version on the kernel route's own inputs
                        (:func:`vertex_parity`, within
                        :data:`VERTEX_PARITY_TOL`), and the frame against
                        the reference route within :func:`frame_bound`
                        (:data:`KERNEL_PARITY_TOL` x max|reference|, or
                        twice the reference's own change under a one-ulp
                        move of its input where that is larger), naming the
                        first vertex past it.
``traced_parity``       the tick-by-tick traced run returns bit-exact
                        outputs vs the tick loop of ``run``.
``modelcheck``          the traced run's :class:`ModelCheck` gates pass:
                        the walk matched ``T = B + S - 1`` / Eq. 6 steady
                        ticks and no Eq. 1-sized queue stalled or
                        overflowed.
``channel_model``       (cases with a drawn ``ChannelConfig``) the
                        ``repro_torch.memory`` arbitration obeys its own
                        model: contended stage latencies dominate the base
                        ones, grants respect demands and channel capacity,
                        and per-kind byte volumes equal the report's
                        spill/weight accounting.
``serve_vs_run``        the server returns bit-exact results per ticket,
                        across a padded partial batch and (with
                        ``resident_limit``) after spilling results to the
                        host byte store.
``artifact_roundtrip``  ``Compiled.save`` -> ``Compiled.load`` on the same
                        device reproduces bit-exact outputs and an equal
                        re-serialised plan.
``report_invariants``   spill accounting is self-consistent: BFP8 records
                        match the compile-time ``_bfp8_offchip_bits``
                        formula, lossless records are raw-volume, and the
                        stream report's schedule obeys ticks/Eq. 5/6.

Every relation but ``kernel_parity`` on the card compares the port with
itself on one route, and holds bit for bit on both devices.

:func:`inject_fault` deliberately breaks one mechanism (for harness
self-tests and the fuzz driver's ``--inject-fault``): the oracles must
catch every registered fault.
"""
from __future__ import annotations

import contextlib
import dataclasses
import tempfile
from pathlib import Path

import numpy as np
import torch

from .gen import FuzzCase

__all__ = ["OracleViolation", "CaseReport", "check_case", "inject_fault",
           "FAULTS", "FrameHold", "KERNEL_PARITY_TOL", "VERTEX_PARITY_TOL",
           "frame_bound", "hold_to_reference", "replay_json",
           "stream_bounds", "vertex_parity"]

#: the frame check on the card: max|kernel route - reference route| <= this
#: x max|reference route| per frame, or the frame's :func:`frame_bound`
KERNEL_PARITY_TOL = 2e-2
#: the vertex check (:func:`vertex_parity`): every vertex within this x
#: max(1, max|plain|) of its plain version on the same inputs, the kernels'
#: own tolerance against their plain versions (f32 sums in another order)
VERTEX_PARITY_TOL = 2e-4


class OracleViolation(AssertionError):
    """One conformance oracle failed for one case."""

    def __init__(self, oracle: str, message: str):
        self.oracle = oracle
        super().__init__(f"[{oracle}] {message}")


@dataclasses.dataclass
class CaseReport:
    """What one passing case exercised (the fuzz driver's progress line)."""
    label: str
    n_vertices: int
    n_stages: int
    microbatches: int
    n_evicted: int
    n_lossy: int
    oracles: tuple[str, ...]

    def summary(self) -> str:
        return (f"{self.n_vertices}v/{self.n_stages}s/"
                f"B{self.microbatches}, {self.n_evicted} evicted "
                f"({self.n_lossy} lossy)")


def _eq(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a, b)


def _max_abs(t: torch.Tensor) -> float:
    return float(t.abs().max()) if t.numel() else 0.0


def _first_divergence(ref, other, x, tol: float = 0.0) -> str:
    """Name the first topo vertex where two executors' values differ (by
    more than ``tol`` x max|ref| with ``tol > 0``)."""
    va, vb = ref.run_intermediates(x), other.run_intermediates(x)
    for name, a in va.items():
        if name not in vb:
            continue
        b = vb[name]
        diff = _max_abs(a - b) if a.shape == b.shape else float("inf")
        if (diff > tol * _max_abs(a)) if tol > 0 else not _eq(a, b):
            return (f"first divergence at vertex {name!r} "
                    f"(max abs diff {diff:.3g})")
    return "no intermediate divergence found (outputs differ only)"


def vertex_parity(kernel_exec, plain_exec, x, *,
                  tol: float = VERTEX_PARITY_TOL,
                  values: dict | None = None) -> tuple[float, str | None]:
    """Hold every vertex of ``kernel_exec`` (a staged ``LoweredPipeline`` on
    the kernel route) to its plain version on the kernel route's own
    inputs, teacher-forced: each vertex's plain body (``apply_vertex`` on
    ``plain_exec``, the same plan lowered in reference mode) gets the kernel
    route's values of its predecessors, a spilled edge through the plain
    route's spill numerics (a BFP8 edge: the plain codec's round trip of
    the producer's kernel-route value, bit for bit what the kernel route's
    consumer decodes; a lossless one: identity).  So no error compounds
    from one vertex to the next.

    Each vertex must meet max|kernel - plain| <= ``tol`` x max(1,
    max|plain|).  Raises :class:`OracleViolation` (``vertex_parity``)
    naming the first vertex in topological order that does not; returns
    (the worst ratio of error to limit, its vertex) otherwise.  On the CPU
    the kernel route runs the plain versions, so every ratio is 0.0.
    ``values``: the kernel route's values of every vertex for ``x``
    (``kernel_exec.run_intermediates(x)``) where the caller has them; else
    they are computed here."""
    from ..runtime.executor import apply_vertex
    g, an = plain_exec.graph, plain_exec.analysis
    kan = kernel_exec.analysis
    if an.use_kernels or not kan.use_kernels:
        raise ValueError("vertex_parity holds a kernel-route executor to a "
                         "reference-mode one")
    if an.topo != kan.topo or set(an.spill_fn) != set(kan.spill_fn):
        raise ValueError("vertex_parity needs both executors lowered from "
                         "the same graph and plan")
    got = kernel_exec.run_intermediates(x) if values is None else values
    worst, where = 0.0, None
    for name in an.topo:
        v = g.vertex(name)
        ins = [an.spill_fn[(e.src, name)](got[e.src])
               if (e.src, name) in an.spill_fn else got[e.src]
               for e in g.in_edges(name)]
        want = apply_vertex(v, ins, kernel_exec.params, x, an)
        y = got[name]
        lim = tol * max(1.0, _max_abs(want))
        err = _max_abs(y - want) if y.shape == want.shape else float("inf")
        ratio = err / lim
        if not ratio <= 1.0:                    # NaN fails too
            raise OracleViolation(
                "vertex_parity",
                f"vertex {name!r} ({v.kind}): max|kernel - plain| {err:.3e} "
                f"on the kernel route's inputs, beyond {tol} x max(1, "
                f"max|plain|) = {lim:.3e}")
        if ratio > worst:
            worst, where = ratio, name
    return worst, where


def _bound(y_ref: torch.Tensor, y_up: torch.Tensor) -> tuple[float, float]:
    s = _max_abs(y_up - y_ref)
    return max(KERNEL_PARITY_TOL * _max_abs(y_ref), 2.0 * s), s


def _one_ulp_up(x: torch.Tensor) -> torch.Tensor:
    return torch.nextafter(x, torch.full_like(x, float("inf")))


def frame_bound(ref_exec, x, y_ref) -> tuple[float, float]:
    """The bound a frame on the kernel route is held to against reference
    mode: (max(:data:`KERNEL_PARITY_TOL` x max|y_ref|, 2 S), S), with S =
    max|ref_exec(x one ulp up) - y_ref| the reference's own change when
    every input element moves one ulp up (``torch.nextafter(x, +inf)``).
    ``ref_exec`` is the reference route on the frame ``x``,
    ``y_ref = ref_exec(x)``.

    Why 2 S: the kernel route and reference mode each stand one rounding
    perturbation from the same computation, so they may part by twice what
    one perturbation moves.  S comes from reference mode alone, not from
    the kernel under test; where BFP8 encodes are chained a one-ulp change
    before an encode moves a mantissa by one step of its block, and the
    steps compound down the chain.  Where S is below half of
    :data:`KERNEL_PARITY_TOL` x max|y_ref|, the bound is that tolerance."""
    return _bound(y_ref, ref_exec(_one_ulp_up(x)))


def stream_bounds(ref_exec, xs, ys_ref) -> list[tuple[float, float]]:
    """:func:`frame_bound` of every microbatch of a stream: ``ref_exec``
    takes the stream ``xs`` (B, m, c) and gives ``ys_ref`` (B, L); one
    reference pass moves the whole stream one ulp up."""
    ys_up = ref_exec(_one_ulp_up(xs))
    return [_bound(ys_ref[b], ys_up[b]) for b in range(len(ys_ref))]


@dataclasses.dataclass(frozen=True)
class FrameHold:
    """What :func:`hold_to_reference` read on a frame that passed."""
    err: float            # max|y - y_ref|
    bound: float          # the frame's bound, max(tol, 2 s)
    s: float              # reference mode's change one ulp up (frame_bound)
    tol: float            # KERNEL_PARITY_TOL x max|y_ref|
    worst: float          # the worst vertex's ratio to its vertex_parity limit
    where: str | None     # that vertex


def hold_to_reference(kernel_exec, plain_exec, ref_run, x, y, y_ref, *,
                      bound: tuple[float, float] | None = None,
                      values: dict | None = None) -> FrameHold:
    """The kernel route's two checks against reference mode on one frame
    (or microbatch) ``x`` on the card: every vertex of ``kernel_exec``
    within :data:`VERTEX_PARITY_TOL` of its plain version on the kernel
    route's own inputs (:func:`vertex_parity` against ``plain_exec``, the
    same plan in reference mode, staged; ``values`` as there), and the
    output ``y`` finite, of ``y_ref``'s shape and within the frame's bound
    of reference mode's ``y_ref``: ``bound`` = (bound, S) where the caller
    has it (a stream's :func:`stream_bounds`), else :func:`frame_bound` of
    ``ref_run``.  Raises :class:`OracleViolation` (``vertex_parity`` naming
    the vertex, or ``frame_bound``)."""
    worst, where = vertex_parity(kernel_exec, plain_exec, x, values=values)
    if y.shape != y_ref.shape or not bool(torch.isfinite(y).all()):
        raise OracleViolation("frame_bound",
                              f"bad output {tuple(y.shape)}, expected a "
                              f"finite {tuple(y_ref.shape)}")
    lim, s = frame_bound(ref_run, x, y_ref) if bound is None else bound
    tol = KERNEL_PARITY_TOL * _max_abs(y_ref)
    err = _max_abs(y - y_ref)
    if not err <= lim:
        raise OracleViolation(
            "frame_bound",
            f"max|y - ref| {err:.3e} beyond the bound {lim:.3e} "
            f"(max({KERNEL_PARITY_TOL} x max|ref| = {tol:.3e}, 2 S), "
            f"S = {s:.3e})")
    return FrameHold(err, lim, s, tol, worst, where)


def _lossless_twin(plan):
    """The same plan with every stream codec forced lossless: eviction
    decisions survive, only the lossy compression is removed — exactly
    the plan under which SMOF's eviction must be semantics-preserving."""
    from ..core.plan import ExecutionPlan
    twin = ExecutionPlan.from_json(plan.to_json())
    for s in twin.streams:
        if s.codec == "bfp8":
            s.codec = "none"
    return twin


def check_case(case: FuzzCase, *, resident_limit: int = 2,
               rel_err_per_lossy: float = 0.25,
               torch_device: str = "cuda") -> CaseReport:
    """Run every oracle over ``case`` on ``torch_device``; raises
    :class:`OracleViolation` on the first failure, returns a
    :class:`CaseReport` when all pass.  Every design compiles from the
    case's seed, so all of them hold the same weights."""
    from .. import api
    from ..runtime.executor import _bfp8_offchip_bits

    g, plan = case.graph, case.plan
    ran: list[str] = []

    # -- plan_roundtrip (before compiling: the pristine plan) ---------------
    from ..core.plan import ExecutionPlan
    s0 = plan.to_json()
    back = ExecutionPlan.from_json(s0)
    if back.dropped_keys:
        raise OracleViolation(
            "plan_roundtrip", f"round-trip dropped keys {back.dropped_keys}")
    if back != plan:
        raise OracleViolation("plan_roundtrip",
                              "from_json(to_json(plan)) != plan")
    if back.to_json() != s0:
        raise OracleViolation("plan_roundtrip",
                              "re-serialisation is not byte-identical")
    ran.append("plan_roundtrip")

    B = max(2, plan.microbatch)
    base = dict(model=g, device="u200", strategy="manual-plan",
                kernel_mode="reference", seed=case.seed,
                torch_device=torch_device)
    c_ref = api.compile(api.CompileSpec(mode="reference", **base))
    c_staged = api.compile(api.CompileSpec(mode="staged", plan=plan, **base))
    c_pipe = api.compile(api.CompileSpec(
        mode="pipelined", plan=plan, microbatches=B,
        placement="interleave", channel=case.channel, **base))

    m, c = case.input_shape
    rng = np.random.default_rng(case.seed)
    xs = torch.from_numpy(rng.normal(size=(B, m, c)).astype(np.float32)).to(
        c_ref.executor.device)

    ref_ys = [c_ref.run(xs[b]) for b in range(B)]
    staged_ys = [c_staged.run(xs[b]) for b in range(B)]
    pipe_ys = c_pipe.run(xs)

    # -- lossless_exact ------------------------------------------------------
    lossy = [s for s in plan.streams if s.evicted and s.codec == "bfp8"]
    if lossy:
        twin = _lossless_twin(plan)
        c_tw_staged = api.compile(api.CompileSpec(
            mode="staged", plan=twin, **base))
        c_tw_pipe = api.compile(api.CompileSpec(
            mode="pipelined", plan=twin, microbatches=B,
            placement="interleave", channel=case.channel, **base))
        tw_staged_ys = [c_tw_staged.run(xs[b]) for b in range(B)]
        tw_pipe_ys = c_tw_pipe.run(xs)
        del c_tw_pipe
    else:
        c_tw_staged = c_staged
        tw_staged_ys, tw_pipe_ys = staged_ys, pipe_ys
    for b in range(B):
        if not _eq(tw_staged_ys[b], ref_ys[b]):
            raise OracleViolation(
                "lossless_exact",
                f"staged (all-lossless plan) != reference on frame {b}: "
                + _first_divergence(c_ref.executor, c_tw_staged.executor,
                                    xs[b]))
        if not _eq(tw_pipe_ys[b], ref_ys[b]):
            raise OracleViolation(
                "lossless_exact",
                f"pipelined (all-lossless plan) != reference on frame {b}")
    del c_tw_staged, tw_staged_ys, tw_pipe_ys
    ran.append("lossless_exact")

    # -- bfp8_bounded --------------------------------------------------------
    for b in range(B):
        y = staged_ys[b]
        if not lossy:
            if not _eq(y, ref_ys[b]):
                raise OracleViolation(
                    "bfp8_bounded",
                    f"no lossy codec in plan but staged != reference on "
                    f"frame {b}: "
                    + _first_divergence(c_ref.executor, c_staged.executor,
                                        xs[b]))
        else:
            if not bool(torch.isfinite(y).all()):
                raise OracleViolation(
                    "bfp8_bounded", f"non-finite staged output on frame {b} "
                    f"({len(lossy)} BFP8 stream(s))")
            err = float(torch.linalg.norm((y - ref_ys[b]).double()))
            bound = (rel_err_per_lossy * len(lossy)
                     * float(torch.linalg.norm(ref_ys[b].double())) + 1e-3)
            if err > bound:
                raise OracleViolation(
                    "bfp8_bounded",
                    f"frame {b}: L2 error {err:.4g} exceeds bound "
                    f"{bound:.4g} ({len(lossy)} BFP8 stream(s))")
    ran.append("bfp8_bounded")

    # -- staged_vs_pipelined -------------------------------------------------
    for b in range(B):
        if not _eq(pipe_ys[b], staged_ys[b]):
            raise OracleViolation(
                "staged_vs_pipelined",
                f"1F1B stream output differs from staged on microbatch {b} "
                f"(same plan, same codecs: must be bit-exact)")
    ran.append("staged_vs_pipelined")

    # -- kernel_parity -------------------------------------------------------
    # cases drawn with the kernel route: the staged executor through the
    # kernel wrappers (with the BFP8 boundary codec fused at evicted edges)
    # against the staged reference dispatch, per frame
    if case.kernel_mode == "pallas":
        c_ker = api.compile(api.CompileSpec(
            mode="staged", plan=plan,
            **{**base, "kernel_mode": api.kernel_route(torch_device)}))
        for b in range(B):
            want = staged_ys[b]
            if not xs.is_cuda:
                if not _eq(c_ker.run(xs[b]), want):
                    raise OracleViolation(
                        "kernel_parity",
                        f"staged kernel route != staged reference on frame "
                        f"{b}: " + _first_divergence(
                            c_staged.executor, c_ker.executor, xs[b]))
                continue
            # one run of the kernel route a frame, every vertex kept: the
            # frame's output is its last vertex's
            vals = c_ker.executor.run_intermediates(xs[b])
            try:
                hold_to_reference(c_ker.executor, c_staged.executor,
                                  c_staged.run, xs[b],
                                  vals[c_ker.executor.analysis.topo[-1]],
                                  want, values=vals)
            except OracleViolation as e:
                free = ("" if e.oracle == "vertex_parity" else
                        "; free-running: " + _first_divergence(
                            c_staged.executor, c_ker.executor, xs[b],
                            KERNEL_PARITY_TOL))
                raise OracleViolation("kernel_parity",
                                      f"frame {b}: {e}{free}") from e
        del c_ker
        ran.append("kernel_parity")

    # -- traced_parity + modelcheck ------------------------------------------
    ys_t, mc = c_pipe.executor.run_traced(xs, measure_stages=False)
    if not _eq(ys_t, pipe_ys):
        raise OracleViolation(
            "traced_parity", "tick-by-tick traced outputs differ from the "
            "tick loop's outputs")
    ran.append("traced_parity")
    bad = mc.violations()
    if bad:
        raise OracleViolation("modelcheck", "; ".join(bad))
    ran.append("modelcheck")

    # -- channel_model -------------------------------------------------------
    # model-domain invariants of the off-chip channel arbitration (no
    # measured-time claims): contended stage latencies dominate the base
    # ones, grants never exceed demands or the channel's capacity, and the
    # per-kind arbitrated byte volumes equal the spill/weight accounting of
    # the stream report bit-exactly.
    if case.channel is not None:
        from ..obs.modelcheck import check_contention
        srep_pipe = c_pipe.executor.report
        if srep_pipe.memory is None:
            raise OracleViolation(
                "channel_model",
                "case has a ChannelConfig but the pipelined compile "
                "attached no MemoryModel to its StreamReport")
        cc = check_contention(srep_pipe)
        bad = cc.violations()
        if bad:
            raise OracleViolation("channel_model", "; ".join(bad))
        if cc.eq6_contended_cycles < cc.eq6_cycles - 1e-9:
            raise OracleViolation(
                "channel_model",
                f"contended Eq.6 ({cc.eq6_contended_cycles}) below "
                f"uncontended Eq.6 ({cc.eq6_cycles}): contention can only "
                "slow a stage down")
        ran.append("channel_model")

    # -- serve_vs_run --------------------------------------------------------
    srv = c_pipe.serve(resident_limit=resident_limit)
    frames = [xs[b] for b in range(B)] + [xs[0]]
    tickets = [srv.submit(f) for f in frames]          # B+1: pads one batch
    srv.flush()
    want = staged_ys + [staged_ys[0]]
    for t, w in zip(tickets, want):
        got = srv.result(t)
        if not _eq(got, w):
            raise OracleViolation(
                "serve_vs_run",
                f"server result for ticket {t} differs from Compiled.run "
                f"(resident_limit={resident_limit})")
    del srv
    ran.append("serve_vs_run")

    # -- artifact_roundtrip --------------------------------------------------
    with tempfile.TemporaryDirectory() as td:
        p = Path(td) / "case.smof.json"
        c_staged.save(p)
        loaded = api.Compiled.load(p, torch_device=torch_device)
        if not _eq(loaded.run(xs[0]), staged_ys[0]):
            raise OracleViolation(
                "artifact_roundtrip",
                "loaded artifact's output differs from the saved compile "
                "(seeded params must reproduce bit-identically)")
        if loaded.plan.to_json() != c_staged.plan.to_json():
            raise OracleViolation(
                "artifact_roundtrip",
                "loaded artifact's plan re-serialises differently")
    ran.append("artifact_roundtrip")

    # -- report_invariants ---------------------------------------------------
    for r in c_staged.executor.report.spills:
        spec = g.vertex(r.src).meta["exec"]
        sm = spec.get("m_out", spec["m"])
        sc = spec["cout"]
        raw = sm * sc * g.edge(r.src, r.dst).word_bits
        if r.raw_bits != raw:
            raise OracleViolation(
                "report_invariants",
                f"spill {r.src}->{r.dst}: raw_bits {r.raw_bits} != "
                f"declared stripe volume {raw}")
        if r.codec == "bfp8" and r.reason == "evicted":
            want_bits = _bfp8_offchip_bits(sm, sc)
            if r.offchip_bits != want_bits or not r.exact:
                raise OracleViolation(
                    "report_invariants",
                    f"spill {r.src}->{r.dst}: BFP8 offchip_bits "
                    f"{r.offchip_bits} != compile-time formula {want_bits}")
        elif r.codec == "none" and r.offchip_bits != r.raw_bits:
            raise OracleViolation(
                "report_invariants",
                f"spill {r.src}->{r.dst}: uncompressed stream reports "
                f"offchip {r.offchip_bits} != raw {r.raw_bits}")
    srep = c_pipe.executor.report
    if srep.ticks != B + plan.n_stages - 1:
        raise OracleViolation(
            "report_invariants",
            f"stream report ticks {srep.ticks} != B + S - 1 = "
            f"{B + plan.n_stages - 1}")
    if srep.eq6_time > srep.eq5_time + 1e-9:
        raise OracleViolation(
            "report_invariants",
            f"Eq.6 steady frame time {srep.eq6_time} exceeds Eq.5 "
            f"sequential time {srep.eq5_time}")
    ran.append("report_invariants")

    return CaseReport(
        label=case.label, n_vertices=len(list(g.vertices())),
        n_stages=plan.n_stages, microbatches=B,
        n_evicted=sum(1 for s in plan.streams if s.evicted),
        n_lossy=len(lossy), oracles=tuple(ran))


# -----------------------------------------------------------------------------
# fault injection (harness self-test)
# -----------------------------------------------------------------------------

FAULTS = ("skip-bfp8-decode", "undersize-queues", "oversubscribe-channel",
          "skew-fused-quant")


@contextlib.contextmanager
def inject_fault(name: str | None):
    """Deliberately break one mechanism while compiling/running cases.

    ``skip-bfp8-decode``
        the staged executor's BFP8 spill round-trip
        (``runtime.executor._bfp8_roundtrip``) becomes the identity —
        evicted BFP8 streams silently skip quantisation on the staged
        reference route while the 1F1B streamer still encodes/decodes its
        crossings, so ``staged_vs_pipelined`` (or ``bfp8_bounded``) must
        fire.
    ``undersize-queues``
        every inter-stage ring is sized to capacity 1, ignoring Eq. 1 —
        any crossing with pipeline delay > 1 then stalls or overflows and
        ``modelcheck`` must fire.
    ``oversubscribe-channel``
        the bandwidth arbiter grants every stream its full demand,
        ignoring the channel's capacity cap — on any case whose drawn
        channel is oversubscribed, total grants exceed ``bits_per_cycle``
        and ``modelcheck``/``channel_model`` must fire.
    ``skew-fused-quant``
        every fused egress payload (``kernels.streaming_conv.
        _egress_payload``: the CUDA kernels' on the card, the plain
        versions' on the CPU) leaves with a one-off block exponent
        (doubling every dequantised value), while the standalone stripe
        codec stays correct — on any kernel-route case whose fused egress
        fires, ``kernel_parity`` must catch the divergence.

    A compile made under the fault keeps it (``_bfp8_roundtrip`` is bound
    when a plan is lowered), so the fault covers the whole case.
    """
    if not name:
        yield
        return
    if name == "skip-bfp8-decode":
        from ..runtime import executor as _ex
        orig = _ex._bfp8_roundtrip
        _ex._bfp8_roundtrip = lambda x, **kw: x
        try:
            yield
        finally:
            _ex._bfp8_roundtrip = orig
    elif name == "undersize-queues":
        from ..runtime.streamer import queues as _q
        orig = _q.queue_specs

        def undersized(*a, **kw):
            return {e: dataclasses.replace(s, capacity=1)
                    for e, s in orig(*a, **kw).items()}
        _q.queue_specs = undersized
        try:
            yield
        finally:
            _q.queue_specs = orig
    elif name == "skew-fused-quant":
        from ..kernels import streaming_conv as _sc
        orig = _sc._egress_payload

        def skewed(man, exp):
            return man, exp + 1          # doubles every block's scale
        _sc._egress_payload = skewed
        try:
            yield
        finally:
            _sc._egress_payload = orig
    elif name == "oversubscribe-channel":
        from ..memory import arbiter as _arb
        orig = _arb._grant

        def uncapped(policy, demands, weights, order, capacity):
            return list(demands)        # every stream gets its demand
        _arb._grant = uncapped
        try:
            yield
        finally:
            _arb._grant = orig
    else:
        raise ValueError(f"unknown fault {name!r}; known: {FAULTS}")


def replay_json(payload: dict, *, torch_device: str = "cuda") -> CaseReport:
    """Re-execute one repro payload (see ``fuzz.write_repro``)."""
    from .gen import case_from_json_dict
    case = case_from_json_dict(payload["case"])
    with inject_fault(payload.get("inject_fault")):
        return check_case(case, torch_device=torch_device)
