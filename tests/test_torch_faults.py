"""The reference package's call forms in the port, and an H100-sheet
artifact across ``save`` / ``load``, on the CPU.

* ``GraphStreamServer(g, plan, microbatches=..., **lowering knobs)``, the
  reference's construction, folds into a ``manual-plan`` pipelined compile:
  its results are ``Compiled.serve()``'s bit for bit (same seed, same
  weights), and with the reference's weights carried over
  (``params_from_numpy``) the reference server's within rtol = atol =
  2e-4 (the two packages' f32 matmuls sum in different orders);
* ``roofline_fps()`` and ``enable_slo(cfg, roofline_fps=, bw_gbps=,
  stream_budgets=)``: the reference's defaults and overrides, and the
  verdicts of the reference's ``SloEvaluator`` on the port's own window
  samples;
* ``build_plan`` returns ``(plan, autotune_result)`` and takes
  ``metrics=``; ``CompileSpec(use_pallas=...)`` and
  ``resolved_kernel_mode()``; ``kernels.ops.evict_encode`` /
  ``evict_decode``;
* an artifact planned on ``H100_RUNTIME``, saved and loaded, serves with
  the sheet's host link as its SLO bandwidth (387.0 Gbit/s) and prices the
  off-chip channel as its compile did.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp                                     # noqa: E402
import torch                                                # noqa: E402

import repro                                                # noqa: E402
from repro.core import builders as jbuilders                # noqa: E402
from repro.core.plan import ExecutionPlan as JPlan          # noqa: E402
from repro.kernels import ops as jops                       # noqa: E402
from repro.obs import slo as jslo                           # noqa: E402
from repro.serving.engine import GraphStreamServer as JServer  # noqa: E402

import repro_torch                                          # noqa: E402
from repro_torch.core import H100_RUNTIME, hand_cut_plan    # noqa: E402
from repro_torch.core import builders as tbuilders          # noqa: E402
from repro_torch.core.resources import (ALL_DEVICES,        # noqa: E402
                                        GPU_SHEETS, find_sheet)
from repro_torch.kernels import ops as tops                 # noqa: E402
from repro_torch.memory import ChannelConfig                # noqa: E402
from repro_torch.obs import slo as tslo                     # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry         # noqa: E402
from repro_torch.obs.trace import ObsConfig                 # noqa: E402
from repro_torch.runtime.executor import params_from_numpy  # noqa: E402
from repro_torch.serving import GraphStreamServer           # noqa: E402

YOLO = dict(positions=256, widths=(16, 32, 64), head=16)
B = 4
TOL = 2e-4
N_FRAMES = 2 * B + 1          # two full streams and one with B - 1 bubbles


def _plan(device="u200"):
    g = tbuilders.build_yolo_head_exec(**YOLO)
    return g, hand_cut_plan(g, 3, evict_codec="none", depth_thresh=64.0,
                            device=device)


def _frames(g, seed=7, n=N_FRAMES):
    m, c = tbuilders.exec_input_shape(g)
    return np.random.default_rng(seed).normal(size=(n, m, c)).astype(
        np.float32)


def _serve(srv, xs):
    tickets = [srv.submit(x) for x in xs]
    srv.flush()
    return [srv.result(t) for t in tickets]


# =============================================================================
# fault 5: GraphStreamServer(g, plan, ...)
# =============================================================================

def test_server_from_graph_and_plan_equals_compiled_serve():
    g, plan = _plan()
    srv = GraphStreamServer(g, plan, microbatches=B, torch_device="cpu",
                            seed=3, resident_limit=2)
    comp = repro_torch.compile(repro_torch.CompileSpec(
        model=g, strategy="manual-plan", plan=plan, mode="pipelined",
        microbatches=B, torch_device="cpu", seed=3))
    assert srv.microbatches == B and srv.device.type == "cpu"
    assert srv.slo is None and srv.resident_limit == 2
    xs = _frames(g)
    for got, want in zip(_serve(srv, xs), _serve(comp.serve(), xs)):
        assert torch.equal(got, want)
    assert srv.stats.padded_frames == B - 1
    assert srv.metrics.snapshot()["smof_server_evicted_results_total"] == \
        N_FRAMES - 2


def test_server_from_a_spec_and_with_an_evaluator():
    g, plan = _plan()
    spec = repro_torch.CompileSpec(model=g, strategy="manual-plan",
                                   plan=plan, mode="pipelined",
                                   microbatches=B, torch_device="cpu")
    ev = tslo.SloEvaluator(tslo.SloConfig(window=2))
    reg = MetricsRegistry()
    srv = GraphStreamServer(spec=spec, slo=ev, metrics=reg)
    assert srv.slo is ev and srv.metrics is reg
    _serve(srv, _frames(g))
    assert len(ev._samples) == 2 and ev.last_report is not None
    assert sum(v for k, v in reg.snapshot().items() if k.startswith(
        "smof_server_slo_evaluations_total")) == 3


def test_server_from_graph_and_plan_equals_the_reference():
    g, plan = _plan()
    jsrv = JServer(jbuilders.build_yolo_head_exec(**YOLO),
                   JPlan.from_json(plan.to_json()), microbatches=B,
                   kernel_mode="reference")
    tsrv = GraphStreamServer(g, plan, microbatches=B, torch_device="cpu",
                             kernel_mode="reference")
    tsrv.executor.params = params_from_numpy(
        {k: np.asarray(v) for k, v in jsrv.executor.params.items()})
    xs = _frames(g)
    for got, want in zip(_serve(tsrv, xs), _serve(jsrv, xs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
    for name in ("frames_in", "frames_out", "streams_run", "padded_frames"):
        assert getattr(tsrv.stats, name) == getattr(jsrv.stats, name)


# =============================================================================
# fault 5: roofline_fps() and enable_slo's overrides
# =============================================================================

def _pair(s_per_cycle=None):
    """The hand-cut YOLO head served by both packages from one plan."""
    g, plan = _plan()
    if s_per_cycle is not None:
        plan.provenance["s_per_cycle"] = s_per_cycle
    jsrv = JServer(jbuilders.build_yolo_head_exec(**YOLO),
                   JPlan.from_json(plan.to_json()), microbatches=B,
                   kernel_mode="reference")
    tsrv = GraphStreamServer(g, plan, microbatches=B, torch_device="cpu")
    return g, jsrv, tsrv


@pytest.mark.parametrize("s_per_cycle", [None, 7e-9])
def test_roofline_fps_and_slo_defaults_equal_the_reference(s_per_cycle):
    _, jsrv, tsrv = _pair(s_per_cycle)
    if s_per_cycle is None:
        assert tsrv.roofline_fps() is None and jsrv.roofline_fps() is None
    else:
        assert tsrv.roofline_fps() == pytest.approx(jsrv.roofline_fps(),
                                                    rel=1e-12)
    tev, jev = tsrv.enable_slo(), jsrv.enable_slo()
    assert tsrv.slo is tev
    for f in ("roofline_fps", "bw_gbps", "stream_budgets"):
        assert getattr(tev, f) == pytest.approx(getattr(jev, f)), f
    assert tev.latency is tsrv.latency


def test_enable_slo_overrides_give_the_reference_verdicts():
    """A roofline far above what a CPU run delivers breaches the fps
    objective, as in the reference's throttled-serving test.  The port's
    window samples of four streams, replayed into the port's and the
    reference's evaluators with the same overrides, give the same report
    after every sample, the last the served one."""
    g, jsrv, tsrv = _pair()
    kw = dict(roofline_fps=1e12, bw_gbps=8.0,
              stream_budgets={"activation-evict": 2.0,
                              "activation-restore": 3.0})
    cfg = dict(window=8, p50_target_s=10.0, p99_target_s=20.0)
    tev = tsrv.enable_slo(tslo.SloConfig.from_dict(cfg), **kw)
    for f, v in kw.items():
        assert getattr(tev, f) == v
    for i in range(2):
        _serve(tsrv, _frames(g, seed=i, n=B + 1))
    rep = tev.last_report
    assert not rep.ok and "fps" in [c.objective for c in rep.breaches()]
    samples = list(tev._samples)
    assert len(samples) == 4
    pair = [mod.SloEvaluator(mod.SloConfig.from_dict(cfg),
                             latency=tsrv.latency, **kw)
            for mod in (tslo, jslo)]
    for s in samples:
        got = []
        for ev in pair:
            ev.observe(**dataclasses.asdict(s))
            got.append(ev.evaluate().summary())
        assert got[0] == got[1]
    assert got[0] == rep.summary()


# =============================================================================
# fault 5: build_plan, use_pallas, the codec aliases
# =============================================================================

def test_build_plan_returns_the_plan_and_the_search_result():
    spec = dict(model="unet_exec")
    tplan, tres = repro_torch.build_plan(repro_torch.CompileSpec(**spec),
                                         metrics=MetricsRegistry())
    jplan, jres = repro.build_plan(repro.CompileSpec(**spec))
    assert tres is None and jres is None
    tplan.provenance.pop("compiled_by")
    jplan.provenance.pop("compiled_by")
    assert tplan.to_json() == jplan.to_json()
    assert repro_torch.build_plan(repro_torch.CompileSpec(
        model="unet_exec", mode="reference")) == (None, None)


@pytest.mark.parametrize("use_pallas,torch_device,want", [
    (None, "cpu", "reference"), (True, "cpu", "auto"),
    (True, "cuda", "cuda"), (False, "cuda", "reference")])
def test_use_pallas_resolves_the_kernel_mode(use_pallas, torch_device, want):
    spec = repro_torch.CompileSpec(model="unet_exec", kernel_mode="reference",
                                   use_pallas=use_pallas,
                                   torch_device=torch_device)
    assert spec.resolved_kernel_mode() == want
    # the reference's "pallas" is the port's kernel route on that device
    jmode = repro.CompileSpec(model="unet_exec", kernel_mode="reference",
                              use_pallas=use_pallas).resolved_kernel_mode()
    assert want == (repro_torch.api.kernel_route(torch_device)
                    if jmode == "pallas" else jmode)


def test_use_pallas_drives_the_compile(tmp_path):
    """``use_pallas=False`` lowers the plain bodies whatever
    ``kernel_mode`` says, ``True`` the kernel route; the report and the
    artifact name the resolved mode."""
    g, plan = _plan()
    outs = {}
    for flag in (False, True):
        comp = repro_torch.compile(repro_torch.CompileSpec(
            model=g, strategy="manual-plan", plan=plan, mode="staged",
            torch_device="cpu", kernel_mode="reference" if flag else "auto",
            use_pallas=flag))
        assert comp.executor.analysis.use_kernels is flag
        assert comp.report()["kernel_mode"] == ("auto" if flag
                                                else "reference")
        outs[flag] = comp.run(_frames(g, n=1)[0])
        loaded = repro_torch.Compiled.load(comp.save(tmp_path / f"{flag}.json"),
                                           torch_device="cpu")
        assert loaded.executor.analysis.use_kernels is flag
    np.testing.assert_allclose(outs[True].numpy(), outs[False].numpy(),
                               rtol=TOL, atol=TOL)


def test_evict_codec_aliases_equal_the_reference():
    x = np.random.default_rng(0).standard_normal((64, 96)).astype(np.float32)
    tm, te = tops.evict_encode(torch.from_numpy(x))
    jm, je = jops.evict_encode(jnp.asarray(x), interpret=True)
    assert tm.dtype == torch.int8 and te.shape == (64, 3)
    # the reference's codec is not exact on XLA:CPU (ROADMAP Queue 3):
    # mantissas within one step, exponents within one
    assert np.abs(tm.numpy().astype(int) - np.asarray(jm, int)).max() <= 1
    assert np.abs(te.numpy().astype(int) - np.asarray(je, int)).max() <= 1
    y = tops.evict_decode(tm, te)
    jy = jops.evict_decode(jnp.asarray(tm.numpy()), jnp.asarray(te.numpy()),
                           interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-6, atol=0)
    step = 2.0 ** (te.numpy().astype(np.float64) - 6.0)
    assert (np.abs(y.numpy() - x) <= np.repeat(step, 32, axis=1) / 2
            + 1e-12).all()


# =============================================================================
# fault 6: an artifact planned on an H100 sheet, saved and loaded
# =============================================================================

def test_gpu_sheets_resolve_by_name_and_the_fpga_set_stays():
    assert set(GPU_SHEETS) == {"h100_kernel", "h100_runtime"}
    assert not set(GPU_SHEETS) & set(ALL_DEVICES)
    assert find_sheet("h100_runtime") is H100_RUNTIME
    assert find_sheet("u200") is ALL_DEVICES["u200"]
    assert find_sheet("tpu") is None
    spec = repro_torch.CompileSpec(model="unet_exec", device="h100_kernel")
    assert repro_torch.api._resolve_device(spec) is GPU_SHEETS["h100_kernel"]
    with pytest.raises(KeyError):
        repro_torch.api._resolve_device(
            dataclasses.replace(spec, device="nope"))


def test_h100_artifact_keeps_its_slo_bandwidth_and_channel(tmp_path):
    g = tbuilders.build_yolo_head_exec(**YOLO)
    comp = repro_torch.compile(repro_torch.CompileSpec(
        model=g, device=H100_RUNTIME, mode="pipelined", microbatches=B,
        torch_device="cpu", channel=ChannelConfig(policy="round-robin"),
        obs=ObsConfig.from_dict(dict(slo=dict(p50_target_s=10.0,
                                              p99_target_s=20.0)))))
    assert comp.device == comp.plan.device == "h100_runtime"
    loaded = repro_torch.Compiled.load(comp.save(tmp_path / "h100.json"),
                                       torch_device="cpu")
    assert loaded.spec.device == "h100_runtime"
    for c in (comp, loaded):
        srv = c.serve()
        assert srv.slo.bw_gbps == 387.0
        mem = c.executor.report.memory
        assert mem is not None
    want = comp.executor.report.memory.summary()
    assert loaded.executor.report.memory.summary() == want
    assert (loaded.executor.report.eq6_contended_time
            == comp.executor.report.eq6_contended_time)
    xs = _frames(g, n=B)
    assert torch.equal(loaded.run(torch.from_numpy(xs)),
                       comp.run(torch.from_numpy(xs)))
