"""The port's graph serving front end and telemetry on the CPU, held against
the reference package.

* ``GraphStreamServer`` on the YOLO head at 256 positions under a hand-cut
  3-stage plan, lossless and BFP8: the same plan, the reference's weights
  (``params_from_numpy``) and the same numpy frames through the port's and
  the reference's servers, padded tail and ``resident_limit`` eviction
  included.  Results agree within rtol = atol = 2e-4 on the lossless plan
  (the two packages' f32 matmuls sum in different orders, so not bit for
  bit) and within 2e-2 x max|reference| on the BFP8 plan (one mantissa
  step of a block, as ``tests/test_torch_codec.py``); the counters, and
  the sample names and labels of ``metrics_text()``, are the reference's;
* inside the port everything is bit for bit: served results against the
  staged executor on the same plan (resident or restored, through a reused
  or a re-lowered executor), ``Compiled.trace`` against ``run``, staged
  and pipelined;
* the copies of ``obs.metrics``, ``obs.slo`` and ``obs.flight`` give the
  originals' outputs on the same inputs.
"""
import dataclasses
import json

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp                                     # noqa: E402
import torch                                                # noqa: E402

import repro                                                # noqa: E402
from repro.core import builders as jbuilders                # noqa: E402
from repro.core.plan import ExecutionPlan as JPlan          # noqa: E402
from repro.obs import flight as jflight                     # noqa: E402
from repro.obs import metrics as jmetrics                   # noqa: E402
from repro.obs import slo as jslo                           # noqa: E402
from repro.obs import trace as jtrace                       # noqa: E402

import repro_torch                                          # noqa: E402
from repro_torch.core import builders as tbuilders          # noqa: E402
from repro_torch.core import hand_cut_plan                  # noqa: E402
from repro_torch.obs import flight as tflight               # noqa: E402
from repro_torch.obs import metrics as tmetrics             # noqa: E402
from repro_torch.obs import slo as tslo                     # noqa: E402
from repro_torch.obs import trace as ttrace                 # noqa: E402
from repro_torch.runtime.executor import params_from_numpy  # noqa: E402

YOLO = dict(positions=256, widths=(16, 32, 64), head=16)
B = 4
LOSSLESS_TOL = 2e-4
BFP8_TOL = 2e-2
N_FRAMES = 2 * B + 1          # two full streams and one with B - 1 bubbles


def _plan(codec):
    g = tbuilders.build_yolo_head_exec(**YOLO)
    return g, hand_cut_plan(g, 3, evict_codec=codec, depth_thresh=64.0)


@pytest.fixture(scope="module", params=["none", "bfp8"],
                ids=["lossless", "bfp8"])
def pair(request):
    """The small YOLO head pipelined (B = 4) in both packages from one plan;
    the port holds the reference's weights."""
    codec = request.param
    tg, plan = _plan(codec)
    jg = jbuilders.build_yolo_head_exec(**YOLO)
    jc = repro.compile(repro.CompileSpec(
        model=jg, strategy="manual-plan", plan=JPlan.from_json(plan.to_json()),
        mode="pipelined", microbatches=B, kernel_mode="reference"))
    tc = repro_torch.compile(repro_torch.CompileSpec(
        model=tg, strategy="manual-plan", plan=plan, mode="pipelined",
        microbatches=B, torch_device="cpu"))
    tc.executor.params = params_from_numpy(
        {k: np.asarray(v) for k, v in jc.executor.params.items()})
    m, c = tc.input_shape()
    xs = np.random.default_rng(7).normal(size=(N_FRAMES, m, c)).astype(
        np.float32)
    return codec, jc, tc, xs


def _serve_all(compiled, xs, resident_limit):
    """A fresh registry, every frame submitted, one flush, every result
    claimed in ticket order."""
    compiled = dataclasses.replace(compiled,
                                   registry=type(compiled.registry)())
    srv = compiled.serve(resident_limit=resident_limit)
    tickets = [srv.submit(x) for x in xs]
    srv.flush()
    return compiled, srv, [srv.result(t) for t in tickets]


def _close(got, want, codec):
    if codec == "bfp8":
        assert np.abs(got - want).max() <= BFP8_TOL * np.abs(want).max()
    else:
        np.testing.assert_allclose(got, want, rtol=LOSSLESS_TOL,
                                   atol=LOSSLESS_TOL)


@pytest.mark.parametrize("resident_limit", [0, 3])
def test_server_results_equal_reference(pair, resident_limit):
    codec, jc, tc, xs = pair
    _, _, jys = _serve_all(jc, xs, resident_limit)
    _, srv, tys = _serve_all(tc, xs, resident_limit)
    assert srv.stats.padded_frames == B - 1
    for j, t in zip(jys, tys):
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        _close(t.numpy(), np.asarray(j), codec)


def _samples(text):
    """{family: {sample key: value}} of a Prometheus exposition, the
    latency histogram's values dropped (wall clock)."""
    out = {}
    for fam, d in tmetrics.parse_metrics_text(text).items():
        out[fam] = {k: (None if "latency" in fam and "count" not in k
                        else v) for k, v in d["samples"].items()}
    return out


def test_server_counters_and_metric_names_equal_reference(pair):
    """The same submit/flush/claim sequence under ``resident_limit=3``:
    the port's exposition has the reference's families, sample names and
    labels, and the same counter values."""
    _, jc, tc, xs = pair
    jc2, _, _ = _serve_all(jc, xs, 3)
    tc2, srv, _ = _serve_all(tc, xs, 3)
    want = _samples(jc2.metrics_text())
    got = _samples(tc2.metrics_text())
    assert got == want
    assert (srv.stats.frames_in, srv.stats.frames_out, srv.stats.streams_run,
            srv.stats.padded_frames) == (N_FRAMES, N_FRAMES, 3, B - 1)
    snap = tc2.metrics()
    assert snap["smof_server_evicted_results_total"] == N_FRAMES - 3
    assert snap["smof_server_restored_results_total"] == N_FRAMES - 3


def test_trace_metrics_equal_reference(pair):
    """``Compiled.trace`` of one stream feeds the artifact's registry with
    the reference's tick, frame, queue and spill samples, and both
    packages' ModelChecks pass."""
    _, jc, tc, xs = pair
    jc2 = dataclasses.replace(jc, registry=type(jc.registry)())
    tc2 = dataclasses.replace(tc, registry=type(tc.registry)())
    _, jmc = jc2.trace(jnp.asarray(xs[:B]))
    _, tmc = tc2.trace(xs[:B])
    assert jmc.ok and tmc.ok
    assert _samples(tc2.metrics_text()) == _samples(jc2.metrics_text())


@pytest.mark.parametrize("how", ["reuse", "relower-from-staged",
                                 "override-microbatches"])
def test_served_results_equal_staged_bit_for_bit(how):
    """Inside the port a served result is the staged executor's, bit for
    bit, whether it stayed resident or came back from the host store, and
    whether ``serve`` reused the pipelined executor or re-lowered the plan
    (same seed, so the same weights)."""
    g, plan = _plan("bfp8")
    spec = repro_torch.CompileSpec(model=g, strategy="manual-plan",
                                   plan=plan, torch_device="cpu", seed=3)
    staged = repro_torch.compile(spec)
    if how == "reuse":
        comp = repro_torch.compile(dataclasses.replace(
            spec, mode="pipelined", microbatches=B))
        srv = comp.serve(resident_limit=2)
        assert srv.executor is comp.executor
    elif how == "relower-from-staged":
        srv = staged.serve(resident_limit=2)
    else:
        comp = repro_torch.compile(dataclasses.replace(
            spec, mode="pipelined", microbatches=B))
        srv = comp.serve(resident_limit=2, microbatches=3)
        assert srv.microbatches == 3 and srv.executor is not comp.executor
    m, c = staged.input_shape()
    xs = np.random.default_rng(1).normal(size=(N_FRAMES, m, c)).astype(
        np.float32)
    tickets = [srv.submit(x) for x in xs]
    out = srv.flush()
    assert set(out) == set(tickets)
    for t, x in zip(tickets, xs):
        np.testing.assert_array_equal(srv.result(t).numpy(),
                                      staged.run(x).numpy())
    assert srv.stats.frames_out == N_FRAMES


@pytest.mark.parametrize("resident_limit", [0, 2])
def test_resident_results_hold_only_their_own_storage(resident_limit):
    """A resident result owns its storage, one result's bytes, and never a
    view of its stream's whole (B, L) output: under ``resident_limit`` the
    results left on the device sum to at most that many results, bubble
    rows and evicted neighbours freed with their stream (unbounded, every
    result is still one result's bytes)."""
    g, plan = _plan("bfp8")
    comp = repro_torch.compile(repro_torch.CompileSpec(
        model=g, strategy="manual-plan", plan=plan, mode="pipelined",
        microbatches=B, torch_device="cpu"))
    srv = comp.serve(resident_limit=resident_limit)
    m, c = comp.input_shape()
    xs = np.random.default_rng(2).normal(size=(N_FRAMES, m, c)).astype(
        np.float32)
    tickets = [srv.submit(x) for x in xs]
    out = srv.flush()
    one = out[tickets[0]].nbytes
    resident = list(srv._results.values())
    assert len(resident) == (resident_limit or N_FRAMES)
    assert all(y.untyped_storage().nbytes() == one for y in resident)
    assert sum(y.untyped_storage().nbytes() for y in resident) <= \
        len(resident) * one


@pytest.mark.parametrize("mode", ["staged", "pipelined"])
def test_trace_outputs_equal_run(mode, tmp_path):
    """``Compiled.trace`` returns ``run``'s outputs bit for bit and writes
    a Chrome trace that validates; the pipelined ModelCheck's tick and
    queue gates are clean (T = B + S - 1)."""
    g, plan = _plan("bfp8")
    comp = repro_torch.compile(repro_torch.CompileSpec(
        model=g, strategy="manual-plan", plan=plan, mode=mode,
        microbatches=B, torch_device="cpu"))
    m, c = comp.input_shape()
    x = np.random.default_rng(2).normal(size=(m, c)).astype(np.float32)
    path = tmp_path / "run.trace.json"
    y, mc = comp.trace(x, path=path)
    stats = ttrace.validate_chrome_trace(json.loads(path.read_text()))
    assert stats["spans"] > 0 and stats["counters"] > 0
    if mode == "staged":
        assert mc is None
        np.testing.assert_array_equal(y.numpy(), comp.run(x).numpy())
        assert [s["name"] for s in comp.recorder.spans()] == ["frame"]
    else:
        xs = torch.from_numpy(x).expand((B, m, c))
        np.testing.assert_array_equal(y.numpy(), comp.run(xs).numpy())
        assert mc.ok and not mc.violations()
        assert mc.ticks_measured == B + plan.n_stages - 1
        assert comp.report()["model_check"] == mc.summary()


def test_serve_attaches_the_slo_evaluator_and_flight_recorder(tmp_path):
    """``spec.obs.slo`` attaches an evaluator with the device sheet's
    off-chip budget and no roofline (a hand-cut plan has no calibrated
    ``s_per_cycle``), as the reference's ``serve`` does; every flushed
    stream is scored once."""
    g, plan = _plan("bfp8")
    obs = dict(slo=dict(p50_target_s=10.0, p99_target_s=20.0),
               flight_capacity=64, flight_path=str(tmp_path / "f.json"))
    comp = repro_torch.compile(repro_torch.CompileSpec(
        model=g, strategy="manual-plan", plan=plan, mode="pipelined",
        microbatches=B, torch_device="cpu",
        obs=ttrace.ObsConfig.from_dict(obs)))
    jcomp = repro.compile(repro.CompileSpec(
        model=jbuilders.build_yolo_head_exec(**YOLO), strategy="manual-plan",
        plan=JPlan.from_json(plan.to_json()), mode="pipelined",
        microbatches=B, kernel_mode="reference",
        obs=jtrace.ObsConfig.from_dict(obs)))
    srv, jsrv = comp.serve(), jcomp.serve()
    assert srv.slo is not None and srv.flight is not None
    assert srv.slo.roofline_fps is None and jsrv.slo.roofline_fps is None
    assert srv.slo.bw_gbps == jsrv.slo.bw_gbps > 0
    assert srv.slo.cfg.to_dict() == jsrv.slo.cfg.to_dict()
    m, c = comp.input_shape()
    xs = np.random.default_rng(4).normal(size=(N_FRAMES, m, c)).astype(
        np.float32)
    for x in xs:
        srv.submit(x)
    srv.flush()
    verdicts = {k: v for k, v in comp.metrics().items()
                if k.startswith("smof_server_slo_evaluations_total")}
    assert sum(verdicts.values()) == 3


# =============================================================================
# the copied obs modules against the originals
# =============================================================================

def _drive_registry(mod):
    r = mod.MetricsRegistry()
    c = r.counter("smof_demo_frames_total", "frames", ("edge",))
    c.labels(edge='a->b "q"\n').inc(3)
    c.labels(edge="c->d").inc(0.5)
    g = r.gauge("smof_demo_occupancy", "queue occupancy")
    g.set(7)
    g.dec(2)
    h = r.histogram("smof_demo_latency_seconds", "latency", ("stage",))
    for i, v in enumerate((1e-6, 3e-4, 0.02, 0.02, 5.0)):
        h.labels(stage=str(i % 2)).observe(v)
    before = r.snapshot()
    c.labels(edge="c->d").inc(2)
    return r, r.delta_since(before)


def test_metrics_copy_equals_reference():
    jr, jd = _drive_registry(jmetrics)
    tr, td = _drive_registry(tmetrics)
    assert tr.metrics_text() == jr.metrics_text()
    assert tr.snapshot() == jr.snapshot() and td == jd
    assert (tmetrics.parse_metrics_text(tr.metrics_text())
            == jmetrics.parse_metrics_text(jr.metrics_text()))


def _drive_slo(slo_mod, trace_mod):
    cfg = slo_mod.SloConfig.from_dict(dict(
        window=3, p50_target_s=0.01, p99_target_s=0.05, stall_ratio_warn=0.02,
        future_key=1))
    lat = trace_mod.LatencyHistogram()
    for v in (0.001, 0.004, 0.009, 0.03, 0.2):
        lat.record(v)
    ev = slo_mod.SloEvaluator(cfg, roofline_fps=500.0, bw_gbps=8.0,
                              latency=lat,
                              stream_budgets={"activation-evict": 2.0})
    reports = []
    for frames, s, stalls, ops, spill in ((8, 0.02, 0, 40, 1e6),
                                          (8, 0.05, 3, 40, 4e6),
                                          (3, 0.01, 0, 10, 1e5),
                                          (8, 0.40, 9, 40, 9e8)):
        ev.observe(frames=frames, seconds=s, stalls=stalls, queue_ops=ops,
                   spill_bytes=spill)
        reports.append(ev.evaluate().summary())
    return cfg.to_dict(), reports


def test_slo_copy_equals_reference():
    assert _drive_slo(tslo, ttrace) == _drive_slo(jslo, jtrace)


def _drive_flight(mod, path):
    clock = iter(i * 1e-3 for i in range(1000))
    rec = mod.FlightRecorder(4, path=path, clock=lambda: next(clock))
    for i in range(7):
        with rec.span(f"tick{i}", track="stage0"):
            rec.incr("spill:bytes", 64)
    rec.instant("stall", track="stage1")

    class Report:
        ok, verdict = False, "breach"

        def breaches(self):
            return [type("C", (), {"objective": "latency_p99"})()]

    rec.on_slo_report(Report())
    events = json.loads(path.read_text())["traceEvents"]
    return rec.dumps[0][1], [e for e in events
                             if e["name"] != "process_name"]


def test_flight_copy_equals_reference(tmp_path):
    """The same events through a 4-event ring, dumped on an SLO breach:
    the same reason and events (the process name aside)."""
    assert (_drive_flight(tflight, tmp_path / "t.json")
            == _drive_flight(jflight, tmp_path / "j.json"))
