"""The port's pipelined 1F1B streamer on the CPU, held against the reference
package's ``lower_plan_pipelined`` (run as ``tests/test_streamer.py`` runs
it, ``kernel_mode="reference"``) on the same plans, the same weights
(carried across by ``params_from_numpy``) and the same numpy-seeded
streams, and against the port's own staged executor.

* ``StreamReport.summary()`` is equal field for field, with and without an
  off-chip channel model;
* the schedule, its simulation and the queue specs are the reference's;
* every microbatch equals the port's staged executor on the same plan bit
  for bit, on the kernel route and on the reference route;
* outputs are within the tolerances of ``tests/test_torch_executor.py``:
  rtol = atol = 2e-4 for a lossless plan, 2e-2 x max|reference| for a
  BFP8 plan (the port's codec is exact and the reference's is not).
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp                                     # noqa: E402
import torch                                                # noqa: E402

from repro.core import DSEConfig as JDSEConfig              # noqa: E402
from repro.core import builders as jbuilders                # noqa: E402
from repro.core.dse import run_dse as jrun_dse              # noqa: E402
from repro.core.plan import ExecutionPlan as JPlan          # noqa: E402
from repro.core.plan import plan_from_dse as jplan_from_dse  # noqa: E402
from repro.core.resources import Device as JDevice          # noqa: E402
from repro.memory import ChannelConfig as JChannel          # noqa: E402
from repro.runtime import streamer as jstreamer             # noqa: E402

import repro_torch                                          # noqa: E402
from repro_torch.core import DSEConfig as TDSEConfig        # noqa: E402
from repro_torch.core import builders as tbuilders          # noqa: E402
from repro_torch.core.dse import run_dse as trun_dse        # noqa: E402
from repro_torch.core.plan import ExecutionPlan as TPlan    # noqa: E402
from repro_torch.core.plan import hand_cut_plan             # noqa: E402
from repro_torch.core.plan import plan_from_dse as tplan_from_dse  # noqa: E402
from repro_torch.core.resources import Device as TDevice    # noqa: E402
from repro_torch.memory import ChannelConfig as TChannel    # noqa: E402
from repro_torch.runtime import streamer as tstreamer       # noqa: E402
from repro_torch.runtime.executor import (lower_plan,       # noqa: E402
                                          params_from_numpy)

_TINY = dict(name="tiny", compute_units=4096, onchip_bits=300_000,
             offchip_gbps=64.0, freq_mhz=500.0, reconfig_s=0.0)
LOSSLESS_TOL = 2e-4
BFP8_TOL = 2e-2
CASES = ["unet_dse", "yolo_bfp8_dse", "unet_staged_bfp8", "single_stage",
         "unet_cut_at_pools"]
CHANNELS = [("round-robin", None), ("weighted-fair", 0.5),
            ("fixed-priority", 8.0)]


def _dse_plans(builder, kwargs, codecs):
    """The same DSE in both packages: (reference plan, port plan)."""
    cfg = dict(batch=1, codecs=codecs, word_bits=16,
               cut_kinds=("pool", "conv"))
    jg = getattr(jbuilders, builder)(**kwargs)
    tg = getattr(tbuilders, builder)(**kwargs)
    jp = jplan_from_dse(jg.name, "tiny",
                        jrun_dse(jg, JDevice(**_TINY), JDSEConfig(**cfg)))
    tp = tplan_from_dse(tg.name, "tiny",
                        trun_dse(tg, TDevice(**_TINY), TDSEConfig(**cfg)))
    assert tp.to_json() == jp.to_json()
    return jp, tp


@dataclasses.dataclass
class Case:
    jg: object
    tg: object
    jplan: JPlan
    tplan: TPlan
    B: int
    bfp8: bool


def _case(name) -> Case:
    if name in ("unet_dse", "yolo_bfp8_dse"):
        builder, codecs = (("build_unet_exec", ("none",)) if name == "unet_dse"
                           else ("build_yolo_head_exec", ("none", "bfp8")))
        jp, tp = _dse_plans(builder, {}, codecs)
        return Case(getattr(jbuilders, builder)(),
                    getattr(tbuilders, builder)(), jp, tp, 8,
                    "bfp8" in codecs)
    if name == "unet_staged_bfp8":
        kwargs, n, codec, B = {}, 3, "bfp8", 8
    elif name == "unet_cut_at_pools":
        # seven stages of three vertices: cuts just before pool_4 and
        # pool_7, so act_3 and act_6 each send a raw edge to the next
        # stage and a BFP8-evicted skip to a later one
        kwargs, n, codec, B = {}, 7, "bfp8", 8
    else:                                   # single_stage
        kwargs, n, codec, B = dict(positions=32, levels=2), 1, None, 4
    tg = tbuilders.build_unet_exec(**kwargs)
    tp = hand_cut_plan(tg, n, evict_codec=codec, device="tiny")
    return Case(jbuilders.build_unet_exec(**kwargs), tg,
                JPlan.from_json(tp.to_json()), tp, B, codec == "bfp8")


def _lower(case, *, kernel_mode="auto", channel=None):
    """(reference streamer, port streamer) with the reference's weights."""
    jsx = jstreamer.lower_plan_pipelined(
        case.jg, case.jplan, microbatches=case.B, kernel_mode="reference",
        channel=None if channel is None else JChannel(*channel),
        device=JDevice(**_TINY))
    tsx = tstreamer.lower_plan_pipelined(
        case.tg, case.tplan, microbatches=case.B, kernel_mode=kernel_mode,
        channel=None if channel is None else TChannel(*channel),
        channel_device=TDevice(**_TINY), device="cpu")
    tsx.params = params_from_numpy(
        {k: np.asarray(v) for k, v in jsx.params.items()})
    return jsx, tsx


def _stream(case, seed):
    shape = (case.B,) + tbuilders.exec_input_shape(case.tg)
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.fixture(scope="module")
def cases():
    return {name: _case(name) for name in CASES}


@pytest.fixture(scope="module")
def runs(cases):
    """Per case: the lowered pair, a stream, and both packages' outputs."""
    out = {}
    for i, (name, case) in enumerate(cases.items()):
        jsx, tsx = _lower(case)
        xs = _stream(case, seed=i)
        ys = tsx(torch.from_numpy(xs))
        out[name] = (jsx, tsx, xs, ys, np.asarray(jsx(jnp.asarray(xs))))
    return out


# =============================================================================
# the report
# =============================================================================

@pytest.mark.parametrize("name", CASES)
def test_stream_report_equals_reference(cases, runs, name):
    jsx, tsx, *_ = runs[name]
    assert isinstance(tsx.report, tstreamer.StreamReport)
    assert tsx.report.summary() == jsx.report.summary()
    assert ([dataclasses.asdict(s) for s in tsx.report.spills]
            == [dataclasses.asdict(s) for s in jsx.report.spills])
    assert tsx.report.queue_stats == jsx.report.queue_stats
    assert tsx.report.stage_latency == jsx.report.stage_latency
    assert tsx.report.ticks == cases[name].B + tsx.n_stages - 1


@pytest.mark.parametrize("channel", CHANNELS, ids=lambda c: c[0])
@pytest.mark.parametrize("name", CASES)
def test_stream_report_with_channel_equals_reference(cases, name, channel):
    """The contended Eq. 5/6 of the port's copy of ``repro.memory``."""
    jsx, tsx = _lower(cases[name], channel=channel)
    tsum, jsum = tsx.report.summary(), jsx.report.summary()
    assert "memory" in tsum and tsum == jsum
    assert tsx.report.eq6_contended_time == jsx.report.eq6_contended_time
    assert tsx.report.eq6_contended_time >= tsx.report.eq6_time
    assert ({e: dataclasses.asdict(s) for e, s in tsx._queue_specs.items()}
            == {e: dataclasses.asdict(s) for e, s in jsx._queue_specs.items()})


@pytest.mark.parametrize("name", CASES)
def test_schedule_and_queues_equal_reference(cases, runs, name):
    jsx, tsx, *_ = runs[name]
    case = cases[name]
    js = jstreamer.build_schedule(jsx.n_stages, case.B)
    ts = tstreamer.build_schedule(tsx.n_stages, case.B)
    assert ([dataclasses.astuple(t) for t in ts.tasks()]
            == [dataclasses.astuple(t) for t in js.tasks()])
    assert [ts.phase(t) for t in range(ts.ticks)] == \
        [js.phase(t) for t in range(js.ticks)]
    specs = {e: dataclasses.asdict(s) for e, s in tsx._queue_specs.items()}
    assert specs == {e: dataclasses.asdict(s)
                     for e, s in jsx._queue_specs.items()}
    stage_of = tsx._stage_of
    tsim = tstreamer.simulate_schedule(
        ts, tstreamer.build_queues(tsx._queue_specs),
        producer_stage={e: stage_of[e[0]] for e in tsx._queue_specs},
        consumer_stage={e: stage_of[e[1]] for e in tsx._queue_specs})
    jsim = jstreamer.simulate_schedule(
        js, jstreamer.build_queues(jsx._queue_specs),
        producer_stage={e: stage_of[e[0]] for e in jsx._queue_specs},
        consumer_stage={e: stage_of[e[1]] for e in jsx._queue_specs})
    assert tsim == jsim


# =============================================================================
# numerics
# =============================================================================

@pytest.mark.parametrize("name", CASES)
def test_microbatches_equal_staged_executor(cases, runs, name):
    """Per microbatch, bit for bit the port's staged executor on the same
    plan and weights."""
    _, tsx, xs, ys, _ = runs[name]
    case = cases[name]
    low = lower_plan(case.tg, case.tplan, device="cpu")
    low.params = tsx.params
    assert tuple(ys.shape) == (case.B, ys.shape[1])
    for b in range(case.B):
        assert torch.equal(ys[b], low(torch.from_numpy(xs[b])))


@pytest.mark.parametrize("name", CASES)
def test_outputs_match_reference_streamer(cases, runs, name):
    _, _, _, ys, jys = runs[name]
    assert ys.shape == jys.shape
    if cases[name].bfp8:
        err = np.abs(ys.numpy() - jys).max()
        assert err <= BFP8_TOL * np.abs(jys).max()
    else:
        np.testing.assert_allclose(ys.numpy(), jys, rtol=LOSSLESS_TOL,
                                   atol=LOSSLESS_TOL)


@pytest.mark.parametrize("name", CASES)
def test_kernel_route_equals_reference_route(cases, runs, name):
    """On the CPU the kernel route (fused codec, payload-routed crossings)
    and the reference route compute the same composition, bit for bit."""
    _, tsx, xs, ys, _ = runs[name]
    _, ref = _lower(cases[name], kernel_mode="reference")
    ref.params = tsx.params
    assert torch.equal(ref(torch.from_numpy(xs)), ys)


def test_bfp8_crossings_carry_encoded_payloads(cases, runs):
    """The hand-cut 3-stage plan evicts skips across stages: their shift
    registers hold int8 payloads, and the codec really ran (the stream
    leaves the dense reference)."""
    case = cases["unet_staged_bfp8"]
    _, tsx, xs, ys, _ = runs["unet_staged_bfp8"]
    evicted = {(s.src, s.dst) for s in case.tplan.streams if s.evicted}
    crossing = set(tsx._crossing)
    assert evicted & crossing and crossing - evicted
    carry = tsx._carry0()
    for e in crossing:
        dtypes = [t.dtype for t in carry[e][0]]
        assert dtypes == ([torch.int8, torch.int8] if e in evicted
                          else [torch.float32])
        assert len(carry[e]) == (tsx._stage_of[e[1]] - tsx._stage_of[e[0]])
    dense = repro_torch.compile(repro_torch.CompileSpec(
        model=case.tg, mode="reference", torch_device="cpu"))
    dense.executor.params = tsx.params
    rel = (float((ys[0] - dense.run(torch.from_numpy(xs[0]))).abs().max())
           / float(ys[0].abs().max()))
    assert 0.0 < rel < 0.15


def test_producer_with_raw_and_bfp8_crossings(cases, runs):
    """A producer whose output crosses raw to the next stage and BFP8 to a
    later one: the raw edge carries the f32 value, the evicted edge the
    int8 payload, and the stream is the staged executor's (checked with
    every case above)."""
    case = cases["unet_cut_at_pools"]
    _, tsx, *_ = runs["unet_cut_at_pools"]
    evicted = {(s.src, s.dst) for s in case.tplan.streams if s.evicted}
    crossing = set(tsx._crossing)
    raw = {e[0] for e in crossing - evicted}
    bfp8 = {e[0] for e in crossing & evicted}
    assert raw & bfp8 == {"act_3", "act_6"}
    carry = tsx._carry0()
    for e in crossing:
        assert [t.dtype for t in carry[e][0]] == (
            [torch.int8, torch.int8] if e in evicted else [torch.float32])


@pytest.mark.parametrize("name", ["unet_staged_bfp8", "single_stage"])
def test_run_traced_equals_the_stream(cases, runs, name):
    """The traced tick loop runs the same tick body: the same outputs bit
    for bit, every tick walked, the queues within their Eq. 1 capacity."""
    from repro_torch.obs.trace import TraceRecorder
    _, tsx, xs, ys, _ = runs[name]
    rec = TraceRecorder()
    traced, mc = tsx.run_traced(torch.from_numpy(xs), rec, repeats=1,
                                warmup=0)
    assert torch.equal(traced, ys)
    assert mc.ticks_ok and mc.queues_ok
    assert mc.ticks_measured == tsx.report.ticks
    lat = tstreamer.measured_stage_latencies(tsx, torch.from_numpy(xs[0]),
                                             repeats=1, warmup=0)
    assert len(lat) == tsx.n_stages and all(t > 0 for t in lat)


# =============================================================================
# refusals and the façade
# =============================================================================

def test_wrong_stream_shape_rejected(cases):
    _, tsx = _lower(cases["unet_dse"])
    with pytest.raises(ValueError, match="stream shape"):
        tsx(torch.zeros(3, 64, 32))
    with pytest.raises(ValueError, match="stream shape"):
        tsx.run_traced(torch.zeros(3, 64, 32))


def test_backward_stage_edge_rejected():
    g = tbuilders.build_unet_exec()
    plan = hand_cut_plan(tbuilders.build_unet_exec(), evict_codec=None,
                         device="tiny")
    plan.layers[plan.topo_order[-1]].stage = 0
    with pytest.raises(ValueError, match="backward|empty"):
        tstreamer.lower_plan_pipelined(g, plan, microbatches=4,
                                       device="cpu")


@pytest.mark.parametrize("placement,err", [("shard_map", ValueError),
                                           ("ring", ValueError)])
def test_placement_refused(cases, placement, err):
    # shard_map: the reference's refusal of a ring with fewer devices than
    # stages (one CPU, S > 1)
    case = cases["unet_dse"]
    assert case.tplan.n_stages > 1
    with pytest.raises(err):
        tstreamer.lower_plan_pipelined(case.tg, case.tplan, microbatches=2,
                                       placement=placement, device="cpu")


def test_facade_runs_a_stream_and_a_frame(cases):
    case = cases["yolo_bfp8_dse"]
    c = repro_torch.compile(repro_torch.CompileSpec(
        model=case.tg, device=TDevice(**_TINY), mode="pipelined",
        microbatches=case.B, torch_device="cpu",
        dse=TDSEConfig(batch=1, codecs=("none", "bfp8"), word_bits=16,
                       cut_kinds=("pool", "conv"))))
    assert c.plan.streams == case.tplan.streams
    xs = torch.from_numpy(_stream(case, seed=7))
    ys = c.run(xs.numpy())
    assert tuple(ys.shape) == (case.B, ys.shape[1])
    one = c.run(xs[3])
    assert torch.equal(one, ys[3])
    rep = c.report()
    assert rep["mode"] == "pipelined"
    assert rep["traffic"]["ticks"] == case.B + c.plan.n_stages - 1
    assert rep["traffic"] == c.executor.report.summary()
