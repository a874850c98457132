"""The port's closed-loop autotuner on the CPU, held against the reference
package's ``repro.optim.autotune``.

The measurement hooks are injectable, so both searches run under one
deterministic stub clock: a candidate's measured frame (tick) time is its
analytic Eq. 6 cycles times 7 ns, which the TINY sheet's nominal 500 MHz
(2 ns a cycle) does not predict.  Both packages then compute the same
Python floats from copied analytic models, and the port is held to the
reference by exact equality:

* trajectory rows, best plan JSON, the fitted ``s_per_cycle`` and the
  provenance digest, on the UNet (seeds 0 and 3), the small UNet and the
  small X3D, with ``kernel_mode="reference"`` on the CPU;
* the ``_propose`` walk over 20 steps with tile moves on (the CPU never
  proposes them, the card does), and the records of a search whose
  channel prunes every move;
* the façade's provenance and ``report()["autotune"]``, the artifacts of
  each package loaded by the other.

Then the reference's own checks on the port (the seed as candidate 0, the
acceptance floor, determinism, calibration, the JSON schema), one real
host-clock measurement, ``GraphStreamServer.autotuned`` and the CLI on the
CPU, and ``runtime.executor.launch_table`` against the kernel wrappers
counted on plans the search proposes.
"""
import dataclasses
import json
import math
import random

import numpy as np
import pytest

pytest.importorskip("torch")

import torch                                                # noqa: E402

import repro.api as japi                                    # noqa: E402
from repro.core import DSEConfig as JDSEConfig              # noqa: E402
from repro.core import builders as jbuilders                # noqa: E402
from repro.core.dse import run_dse as jrun_dse              # noqa: E402
from repro.core.plan import plan_from_dse as jplan_from_dse  # noqa: E402
from repro.core.resources import Device as JDevice          # noqa: E402
from repro.memory import ChannelConfig as JChannel          # noqa: E402
from repro.optim import autotune as JA                      # noqa: E402
from repro.runtime.executor import WEIGHT_KINDS as JWEIGHT_KINDS  # noqa: E402

import repro_torch                                          # noqa: E402
import repro_torch.api as tapi                              # noqa: E402
from repro_torch.core import DSEConfig as TDSEConfig        # noqa: E402
from repro_torch.core import builders as tbuilders          # noqa: E402
from repro_torch.core.dse import run_dse as trun_dse        # noqa: E402
from repro_torch.core.plan import plan_from_dse             # noqa: E402
from repro_torch.core.resources import Device as TDevice    # noqa: E402
from repro_torch.kernels import streaming_conv as TSC       # noqa: E402
from repro_torch.memory import ChannelConfig as TChannel    # noqa: E402
from repro_torch.optim import autotune as TA                # noqa: E402
from repro_torch.runtime import executor as tex             # noqa: E402
from repro_torch.serving import GraphStreamServer           # noqa: E402

_TINY = dict(name="tiny", compute_units=4096, onchip_bits=300_000,
             offchip_gbps=64.0, freq_mhz=500.0, reconfig_s=0.0)
# stub clock: 7 ns per analytic cycle (nominal 500 MHz would be 2 ns, so
# pre-calibration predictions are off by exactly log(3.5))
STUB_S_PER_CYCLE = 7e-9
SMALL_UNET = dict(positions=32, levels=2)
SMALL_X3D = dict(positions=64, cin=3, widths=(24, 48), expansion=2, depth=2)
# (builder, kwargs, seed, candidates, seed DSE's cut kinds): the small X3D
# with tests/test_torch_x3d.py's DSE (cuts at the output only), which takes
# a fraction of the search's default DSE time
CASES = {
    "unet-s0": ("build_unet_exec", {}, 0, 8, None),
    "unet-s3": ("build_unet_exec", {}, 3, 6, None),
    "unet-small": ("build_unet_exec", SMALL_UNET, 0, 6, None),
    "x3d-small": ("build_x3d_exec", SMALL_X3D, 0, 4, ("output",)),
}


def _stub_fps(sx, xs, **_):
    return 1.0 / (max(sx.report.stage_latency) * STUB_S_PER_CYCLE)


def _stub_stages(sx, x, **_):
    return [l * STUB_S_PER_CYCLE for l in sx.report.stage_latency]


def _cfg(pkg, seed=0, n=6, mb=4, **kw):
    kw.setdefault("kernel_mode", "reference")
    if pkg is TA:
        kw.setdefault("torch_device", "cpu")
    return pkg.AutotuneConfig(n_candidates=n, microbatches=mb, seed=seed,
                              **kw)


def _tune(pkg, builder, kwargs, seed=0, n=6, dev=None, cut_kinds=None,
          **kw):
    builders, Device, DSEConfig = (
        (jbuilders, JDevice, JDSEConfig) if pkg is JA
        else (tbuilders, TDevice, TDSEConfig))
    g = getattr(builders, builder)(**kwargs)
    if cut_kinds is not None:
        kw["dse"] = DSEConfig(batch=1, codecs=("none", "bfp8"),
                              word_bits=16, cut_kinds=cut_kinds)
    return pkg.autotune(g, dev or Device(**_TINY), _cfg(pkg, seed, n, **kw),
                        measure_fps=_stub_fps, measure_stages=_stub_stages)


@pytest.fixture(scope="module")
def searches():
    """Each case searched once by each package, on first use."""
    done = {}

    def get(case):
        if case not in done:
            builder, kwargs, seed, n, cuts = CASES[case]
            done[case] = (_tune(JA, builder, kwargs, seed, n, cut_kinds=cuts),
                          _tune(TA, builder, kwargs, seed, n, cut_kinds=cuts))
        return done[case]
    return get


@pytest.fixture
def stub_clock(monkeypatch):
    """Both packages' default measurements (what the façade, the server
    and the CLI call) replaced by the stub clock."""
    for pkg in (JA, TA):
        monkeypatch.setattr(pkg, "measure_pipelined_fps", _stub_fps)
        monkeypatch.setattr(pkg, "measured_stage_latencies", _stub_stages)


# =============================================================================
# exact equality with the reference under the stub clock
# =============================================================================

@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("what", ["trajectory_rows", "best_plan",
                                  "s_per_cycle", "digest"])
def test_search_equals_reference(searches, case, what):
    jr, tr = searches(case)
    get = {"trajectory_rows": lambda r: r.trajectory_rows(),
           "best_plan": lambda r: r.best_plan.to_json(),
           "s_per_cycle": lambda r: r.calibration.s_per_cycle}.get(what)
    if what == "digest":
        assert tapi._autotune_digest(tr) == japi._autotune_digest(jr)
        assert len(tapi._autotune_digest(tr)) == 16
    else:
        assert get(tr) == get(jr)
    assert len(tr.trajectory) == CASES[case][3]


def _prelude(pkg):
    """The search's prelude on the UNet: graph, topo order, seed genome,
    deep edges and weight layers."""
    if pkg is JA:
        builders, Device, dse, to_plan, weight_kinds = (
            jbuilders, JDevice, jrun_dse, jplan_from_dse, JWEIGHT_KINDS)
        DSEConfig = JDSEConfig
    else:
        builders, Device, dse, to_plan, weight_kinds = (
            tbuilders, TDevice, trun_dse, plan_from_dse, tex.WEIGHT_KINDS)
        DSEConfig = TDSEConfig
    g = builders.build_unet_exec()
    dev = Device(**_TINY)
    res = dse(g, dev, DSEConfig(batch=1, codecs=("none", "bfp8"),
                                word_bits=16, cut_kinds=("pool", "conv")))
    topo = g.topo()
    genome = pkg._genome_from_plan(to_plan(g.name, dev.name, res,
                                           microbatch=4), topo)
    g.compute_buffer_depths()
    in_out = {n for n in topo if g.vertex(n).kind in ("input", "output")}
    ranked = sorted((e for e in g.edges()
                     if e.src not in in_out and e.dst not in in_out),
                    key=lambda e: e.buffer_depth, reverse=True)
    deep = [(e.src, e.dst) for e in ranked[:max(len(ranked) // 2, 1)]]
    weighty = [n for n in topo if g.vertex(n).kind in weight_kinds]
    return g, topo, genome, deep, weighty


@pytest.fixture(scope="module")
def preludes():
    return {pkg: _prelude(pkg) for pkg in (JA, TA)}


def _walk(pkg, prelude, seed, steps):
    """``steps`` chained ``_propose`` moves with tile moves on, from the
    seed genome."""
    g, topo, genome, deep, weighty = prelude
    cfg = _cfg(pkg)
    rng = random.Random(seed)
    out = []
    for _ in range(steps):
        prop = pkg._propose(genome, g, topo, deep, weighty, rng, cfg,
                            tile_moves=True)
        if prop is None:
            out.append(None)
            break
        genome, move = prop
        plan = pkg._plan_from_genome(g, topo, genome, model=g.name,
                                     device="tiny", microbatch=4)
        out.append((move, dataclasses.asdict(genome), plan.to_json()))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_propose_walk_equals_reference(preludes, seed):
    jw = _walk(JA, preludes[JA], seed, 20)
    tw = _walk(TA, preludes[TA], seed, 20)
    assert len(tw) == 20 and tw == jw
    assert "tile" in {m for m, _, _ in tw}
    assert TA.MOVES == JA.MOVES
    assert (TSC.TILE_BM_CHOICES, TSC.TILE_BC_CHOICES) == (
        JA.TILE_BM_CHOICES, JA.TILE_BC_CHOICES)


@pytest.mark.parametrize("policy,gbps", [("weighted-fair", 2000.0),
                                         ("round-robin", 0.001)])
def test_channel_pruning_equals_reference(policy, gbps):
    """A generous channel keeps every move; a starved one prunes every
    move away from the seed (recorded, fps 0, never lowered)."""
    dev = dict(_TINY, name="tiny_stream")
    jr = _tune(JA, "build_unet_exec", SMALL_UNET, n=4, dev=JDevice(**dev),
               channel=JChannel(policy=policy, gbps=gbps))
    tr = _tune(TA, "build_unet_exec", SMALL_UNET, n=4, dev=TDevice(**dev),
               channel=TChannel(policy=policy, gbps=gbps))
    assert tr.trajectory_rows() == jr.trajectory_rows()
    assert tr.best_plan.to_json() == jr.best_plan.to_json()
    seed, rest = tr.trajectory[0], tr.trajectory[1:]
    assert seed.move == "seed" and not seed.pruned
    if gbps < 1:
        assert rest and all(r.pruned and r.fps_measured == 0.0
                            and not r.accepted for r in rest)
        assert tr.best_fps == tr.baseline_fps
    else:
        assert all(r.feasible and not r.pruned for r in tr.trajectory)
        assert all(r.eq6_contended_cycles >= r.eq6_cycles - 1e-9
                   for r in tr.trajectory)


# =============================================================================
# the reference's own checks, on the port
# =============================================================================

def test_seed_is_candidate_zero_and_floor(searches):
    _, res = searches("unet-s0")
    assert isinstance(res, TA.AutotuneResult)
    assert res.trajectory[0].move == "seed" and res.trajectory[0].accepted
    assert res.baseline_fps == res.trajectory[0].fps_measured
    assert res.best_fps >= res.baseline_fps


def test_deterministic_under_fixed_seed(searches):
    _, r1 = searches("unet-s3")
    r2 = _tune(TA, "build_unet_exec", {}, seed=3)
    assert r1.trajectory_rows() == r2.trajectory_rows()
    assert r1.best_plan.to_json() == r2.best_plan.to_json()
    assert r1.calibration.s_per_cycle == r2.calibration.s_per_cycle


def test_moves_mutate_the_genome(searches):
    _, r0 = searches("unet-s0")
    _, r3 = searches("unet-s3")
    assert len({(r.n_stages, r.n_evicted, r.n_fragged)
                for r in r0.trajectory}) > 1
    assert ([c.move for c in r0.trajectory[1:]]
            != [c.move for c in r3.trajectory[1:]])


def test_calibration_recovers_stub_scale(searches):
    _, res = searches("unet-s0")
    cal = res.calibration
    assert isinstance(cal, TA.CalibrationReport)
    assert cal.s_per_cycle == pytest.approx(STUB_S_PER_CYCLE, rel=1e-9)
    assert cal.pre_err == pytest.approx(
        abs(math.log((1 / 500e6) / STUB_S_PER_CYCLE)), rel=1e-6)
    assert cal.post_err < 1e-9 < cal.pre_err
    assert cal.improved
    for r in res.trajectory:
        assert r.fps_eq6_cal == pytest.approx(r.fps_measured, rel=1e-9)
        assert r.fps_eq6_pre == pytest.approx(
            r.fps_measured * STUB_S_PER_CYCLE * 500e6, rel=1e-9)


def test_x3d_rows_share_one_schema(searches):
    _, res = searches("x3d-small")
    assert res.model == "x3d_exec" and res.calibration.improved
    rows = res.trajectory_rows()
    assert rows and all(set(rows[0]) == set(r) for r in rows)
    assert {"eq6_contended_cycles", "feasible", "pruned"} <= set(rows[0])


def test_calibrated_hook_plugs_into_stage_latencies(searches):
    from repro_torch.runtime.streamer import stage_latencies
    _, res = searches("unet-s0")
    g = tbuilders.build_unet_exec()
    hook = TA.calibrated_latency_hook(res.calibration.s_per_cycle)
    for s, c in zip(stage_latencies(g, res.best_plan, hook=hook),
                    stage_latencies(g, res.best_plan)):
        assert s == pytest.approx(c * res.calibration.s_per_cycle)


def test_result_json_roundtrips(searches):
    from repro_torch.core.plan import ExecutionPlan
    jr, res = searches("unet-small")
    d = json.loads(res.to_json())
    assert set(d) == {"summary", "trajectory", "best_plan"}
    assert d["summary"]["best_fps"] >= d["summary"]["baseline_fps"]
    assert d == json.loads(jr.to_json())
    back = ExecutionPlan.from_json(json.dumps(d["best_plan"]))
    assert back.to_json() == res.best_plan.to_json()


def test_host_clock_measures_a_stream_on_the_cpu():
    """The default measurement, on the CPU's host clock (one candidate)."""
    from repro_torch.core import exec_input_shape
    from repro_torch.core.plan import ExecutionPlan, LayerPlan, StreamPlan
    from repro_torch.runtime.streamer import lower_plan_pipelined
    g = tbuilders.build_unet_exec(**SMALL_UNET)
    topo = g.topo()
    plan = ExecutionPlan(
        model=g.name, device="tiny", n_stages=1,
        layers={n: LayerPlan(name=n) for n in topo},
        streams=[StreamPlan(e.src, e.dst) for e in g.edges()],
        topo_order=topo)
    sx = lower_plan_pipelined(g, plan, microbatches=2,
                              kernel_mode="reference", device="cpu")
    xs = torch.zeros((2,) + exec_input_shape(g))
    fps = TA.measure_pipelined_fps(sx, xs, repeats=2, warmup=1)
    assert math.isfinite(fps) and fps > 0


def test_the_search_refuses_the_kernel_mode_cuda_on_the_cpu():
    """No fallback: ``kernel_mode="cuda"`` on a CPU search raises before
    any candidate runs."""
    with pytest.raises(ValueError, match="needs a CUDA device"):
        _tune(TA, "build_unet_exec", SMALL_UNET, kernel_mode="cuda")


# =============================================================================
# the façade, the server, the CLI and the artifacts
# =============================================================================

def _compile(pkg_api, Device, **kw):
    builders = jbuilders if pkg_api is japi else tbuilders
    pkg = JA if pkg_api is japi else TA
    spec = dict(model=builders.build_unet_exec(**SMALL_UNET),
                device=Device(**_TINY), strategy="autotune",
                mode="pipelined", kernel_mode="reference",
                autotune_cfg=_cfg(pkg, n=3, mb=2))
    if pkg_api is tapi:
        spec["torch_device"] = "cpu"
    spec.update(kw)
    return pkg_api.compile(pkg_api.CompileSpec(**spec))


@pytest.fixture
def compiled_pair(stub_clock):
    return _compile(japi, JDevice), _compile(tapi, TDevice)


def test_facade_provenance_equals_reference(compiled_pair):
    jc, tc = compiled_pair
    jp, tp = dict(jc.plan.provenance), dict(tc.plan.provenance)
    assert jp.pop("compiled_by") == "repro.api.compile"
    assert tp.pop("compiled_by") == "repro_torch.api.compile"
    assert tp == jp
    assert tp["strategy"] == "autotune" and tp["autotune_candidates"] == 3
    assert tp["autotune_digest"] == tapi._autotune_digest(tc.autotune_result)
    assert tc.plan.to_json().replace("repro_torch.", "repro.") == \
        jc.plan.to_json()


def test_facade_report_and_depth(compiled_pair):
    jc, tc = compiled_pair
    rep = tc.report()
    assert rep["autotune"] == jc.report()["autotune"]
    assert rep["autotune"]["candidates"] == 3
    assert "calibration" in rep["autotune"] and rep["strategy"] == "autotune"
    # the executor runs at the depth the search measured at, and a serve()
    # with overrides keeps that depth unless the caller changes it
    assert tc.executor.microbatches == 2
    assert tc.serve(seed=0).microbatches == 2
    assert tc.serve().autotune_result is tc.autotune_result


def test_default_search_config_follows_the_spec(stub_clock):
    """Without an ``autotune_cfg`` the search takes the spec's depth,
    kernel mode, seed and torch device."""
    c = _compile(tapi, TDevice, autotune_cfg=None, microbatches=2, seed=5,
                 mode="staged")
    prov = c.plan.provenance
    assert prov["autotune_seed"] == 5
    assert prov["autotune_kernel_mode"] == "reference"
    assert prov["autotune_candidates"] == 12
    assert c.autotune_result.microbatches == 2
    assert c.executor.device.type == "cpu"


def test_search_metrics_land_in_the_artifact_registry(compiled_pair):
    _, tc = compiled_pair
    text = tc.metrics_text()
    for name in ("smof_autotune_candidates_total", "smof_autotune_best_fps",
                 "smof_autotune_baseline_fps", "smof_autotune_s_per_cycle"):
        assert name in text
    assert tc.metrics()["smof_autotune_s_per_cycle"] == pytest.approx(
        STUB_S_PER_CYCLE, rel=1e-9)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_autotuned_artifacts_load_in_the_other_package(compiled_pair,
                                                       tmp_path, writer):
    jc, tc = compiled_pair
    path = tmp_path / "at.smof.json"
    if writer == "port":
        tc.save(path)
        back, src = japi.Compiled.load(path), tc
    else:
        jc.save(path)
        back, src = tapi.Compiled.load(path, torch_device="cpu"), jc
    assert back.strategy == "autotune"
    assert back.plan.provenance == src.plan.provenance
    assert json.loads(back.plan.to_json()) == json.loads(src.plan.to_json())
    assert back.executor.microbatches == 2


def test_autotuned_server_on_the_cpu():
    """``GraphStreamServer.autotuned`` on the host clock: the server runs
    the winner at the search's depth, and every result is the staged
    executor's on the same plan, bit for bit."""
    g = tbuilders.build_unet_exec(**SMALL_UNET)
    cfg = _cfg(TA, n=2, mb=2, repeats=1)
    srv = GraphStreamServer.autotuned(g, TDevice(**_TINY), autotune_cfg=cfg,
                                      kernel_mode="reference",
                                      torch_device="cpu")
    res = srv.autotune_result
    assert res is not None and len(res.trajectory) == 2
    assert srv.microbatches == 2 and srv.executor.plan is res.best_plan
    assert res.best_fps >= res.baseline_fps > 0
    staged = repro_torch.compile(repro_torch.CompileSpec(
        model=g, device=TDevice(**_TINY), strategy="manual-plan",
        plan=res.best_plan, kernel_mode="reference", torch_device="cpu"))
    m, c = staged.input_shape()
    frames = np.random.default_rng(7).normal(size=(3, m, c)).astype(
        np.float32)
    tickets = [srv.submit(f) for f in frames]
    out = srv.flush()
    assert set(out) == set(tickets)
    for t, f in zip(tickets, frames):
        assert torch.equal(srv.result(t), staged.run(f))


def test_autotuned_server_takes_the_spec_defaults(stub_clock):
    """Without an ``autotune_cfg`` the server's search runs where the spec
    says (here the CPU), at the spec's depth and seed."""
    srv = GraphStreamServer.autotuned(
        tbuilders.build_unet_exec(**SMALL_UNET), TDevice(**_TINY),
        kernel_mode="reference", torch_device="cpu", microbatches=2,
        seed=4)
    res = srv.autotune_result
    assert len(res.trajectory) == 12 and res.microbatches == 2
    assert srv.microbatches == 2 and srv.device.type == "cpu"
    assert srv.executor.plan.provenance["autotune_seed"] == 4


def test_cli_on_the_cpu(stub_clock, tmp_path, capsys):
    out_json, art = tmp_path / "at.json", tmp_path / "at.smof.json"
    TA.main(["--model", "unet_exec", "--torch-device", "cpu",
             "--kernel-mode", "reference", "--candidates", "2",
             "--microbatches", "2", "--json", str(out_json),
             "--save", str(art)])
    printed = capsys.readouterr().out
    summary = json.loads(printed[:printed.index("saved:")])
    assert summary["candidates"] == 2 and summary["microbatches"] == 2
    d = json.loads(out_json.read_text())
    assert set(d) == {"summary", "trajectory", "best_plan"}
    assert len(d["trajectory"]) == 2
    back = tapi.Compiled.load(art, torch_device="cpu")
    assert back.strategy == "autotune" and back.mode == "pipelined"
    assert back.plan.provenance["autotune_kernel_mode"] == "reference"


def test_cli_helpers_offer_the_ports_modes():
    import argparse
    ap = tapi.add_compile_args(argparse.ArgumentParser())
    args = ap.parse_args(["--model", "yolo_head_exec", "--kernel-mode",
                          "cuda", "--channel-gbps", "10"])
    spec = tapi.spec_from_args(args, microbatches=4)
    assert (spec.kernel_mode, spec.torch_device, spec.microbatches) == (
        "cuda", "cuda", 4)
    assert spec.channel.policy == "round-robin" and spec.channel.gbps == 10
    with pytest.raises(SystemExit):
        ap.parse_args(["--kernel-mode", "pallas"])


# =============================================================================
# launch_table against the wrappers, on plans the search proposes
# =============================================================================

def _count_wrappers(monkeypatch) -> dict:
    """Counts each kernel wrapper's calls under the name of the kernel it
    launches on a CUDA tensor (``plain_dot``: a fragmented layer whose K
    pads to 128 or less, which ``streamed_matmul_padded`` leaves to
    ``torch.matmul``)."""
    counts: dict = {}

    def wrap(mod, name, key):
        f = getattr(mod, name)

        def counted(*a, **k):
            kname = key(a, k)
            counts[kname] = counts.get(kname, 0) + 1
            return f(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    for op in ("conv2d", "act_relu", "pool", "dwconv"):
        wrap(TSC, op, lambda a, k, op=op: TSC._kernel_name(
            op, k.get("payload"), k.get("encode", False)))
    wrap(tex, "streamed_matmul_padded", lambda a, k: (
        "streamed_matmul" if a[0].shape[1] > 128 else "plain_dot"))
    for name in ("bfp8_quant", "bfp8_dequant"):
        wrap(tex, name, lambda a, k, n=name: n)
    return counts


@pytest.mark.parametrize("builder", ["build_yolo_head_exec",
                                     "build_x3d_exec", "build_unet_exec"])
def test_launch_table_counts_what_a_frame_launches(monkeypatch, builder):
    """A staged frame on the kernel route (the plain versions on the CPU)
    calls each kernel wrapper as often as ``launch_table`` says, on twelve
    plans the search's moves reach from a one-stage plan that evicts
    nothing and streams every other weight layer's rows."""
    g = getattr(tbuilders, builder)()
    topo = g.topo()
    weighty = [n for n in topo if g.vertex(n).kind in tex.WEIGHT_KINDS]
    genome = TA._Genome(bounds=[], evict={},
                         frac=dict.fromkeys(weighty[1::2], 0.5))
    edges = [(e.src, e.dst) for e in g.edges()
             if g.vertex(e.src).kind != "input"
             and g.vertex(e.dst).kind != "output"]
    rng, cfg = random.Random(5), _cfg(TA, mb=1, frag_step=0.5)
    m, c = tbuilders.exec_input_shape(g)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(m, c))
                         .astype(np.float32))
    counts = _count_wrappers(monkeypatch)
    kinds = set()
    for _ in range(12):
        genome, _move = TA._propose(genome, g, topo, edges, weighty, rng,
                                    cfg)
        plan = TA._plan_from_genome(g, topo, genome, model=g.name,
                                    device="tiny", microbatch=1)
        lp = tex.lower_plan(g, plan, kernel_mode="auto", device="cpu")
        counts.clear()
        lp(x)
        table = tex.launch_table(g, plan)
        assert counts == table
        kinds |= set(table)
    assert {"conv2d", "bfp8_dequant", "plain_dot"} <= kinds
    # the YOLO head streams layers with K > 128 through the kernel
    assert ("streamed_matmul" in kinds) == (builder == "build_yolo_head_exec")
