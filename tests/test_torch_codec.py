"""The fused BFP8 codec variants and the saved-artifact entry point of the
port on the CPU, held against the reference package.

* the small X3D (``test_torch_x3d.SMALL_X3D``) under three hand-cut
  one-stage plans, every edge deeper than 512, 64 and 0 words evicted
  through BFP8: the three points of the eviction axis that reach the codec
  variants ``chip_smoke.py`` runs on X3D-M at full width.  The reference
  gets the same plan through its JSON and the port the reference's weights.
  ``_lower_vertex`` decides the same in both packages, the SpillReports are
  equal field for field, every vertex is within 2e-2 x max|reference| of
  the reference's Pallas kernels in interpret mode (one mantissa step of a
  BFP8 block, as in test_torch_executor.py), and the port's kernel route
  equals its reference route bit for bit;
* the plain versions of the eight codec variants against the Pallas
  kernels in interpret mode at ragged shapes (c = 3, 24, 40; a pool over 2
  rows and over all of them), with the same payload on both sides: y within
  rtol = atol = 1e-5 (the conv and the long mean sum in another order), the
  payload within the reference codec's tolerance (test_torch_kernels.py);
* ``Compiled.save`` / ``load``: the artifact is the reference's (kind,
  schema, keys, graph and plan JSON), each package loads the other's, a
  reload runs bit for bit as the compile that saved it, and an artifact
  that asks for telemetry keeps its ``obs`` both ways;
* the executor's memory order: a vertex's decoded inputs are gone before
  its output's standalone encode runs.
"""
import copy
import dataclasses
import json
import weakref

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp                                     # noqa: E402
import torch                                                # noqa: E402

import repro                                                # noqa: E402
from repro.core import builders as jbuilders                # noqa: E402
from repro.core.plan import ExecutionPlan as JExecutionPlan  # noqa: E402
from repro.kernels import bfp8 as jbfp8                     # noqa: E402
from repro.kernels import streaming_conv as JSC             # noqa: E402
from repro.runtime import executor as jex                   # noqa: E402

import repro_torch                                          # noqa: E402
from repro_torch.core import builders as tbuilders          # noqa: E402
from repro_torch.core import hand_cut_plan                  # noqa: E402
from repro_torch.kernels import streaming_conv as TSC       # noqa: E402
from repro_torch.runtime import executor as tex             # noqa: E402
from repro_torch.runtime.executor import params_from_numpy  # noqa: E402

from test_torch_x3d import (BFP8_TOL, SMALL_X3D, _payload_close,  # noqa: E402
                            launch_table)

# threshold -> the fused variants the small X3D's plan reaches
THRESHOLDS = {
    512.0: {"conv2d_encode", "dwconv_encode", "pool_encode",
            "act_relu_encode"},
    64.0: {"conv2d_decode", "conv2d_decode_encode", "dwconv_decode",
           "dwconv_decode_encode", "pool_decode", "pool_decode_encode",
           "act_relu_encode"},
    0.0: {"conv2d_decode_encode", "dwconv_decode_encode",
          "pool_decode_encode", "act_relu_decode_encode"},
}


def _frame(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _plan_pair(thresh):
    """(port graph, port plan, reference graph, the same plan read by the
    reference from its JSON).  ``hand_cut_plan`` computes the port graph's
    buffer depths; the reference graph gets them too, so both graphs (and
    their JSON dumps) are in the same state."""
    tg = tbuilders.build_x3d_exec(**SMALL_X3D)
    plan = hand_cut_plan(tg, 1, depth_thresh=thresh)
    jg = jbuilders.build_x3d_exec(**SMALL_X3D)
    jg.compute_buffer_depths()
    return tg, plan, jg, JExecutionPlan.from_json(plan.to_json())


@pytest.fixture(scope="module", params=sorted(THRESHOLDS, reverse=True),
                ids=lambda t: f"evict>{t:g}")
def hand_cut(request):
    """(threshold, reference Pallas pipeline, port kernel route, port
    reference route), the port with the reference's weights."""
    tg, plan, jg, jplan = _plan_pair(request.param)
    jlp = jex.lower_plan(jg, jplan, kernel_mode="pallas", interpret=True)
    params = params_from_numpy({k: np.asarray(v)
                                for k, v in jlp.params.items()})

    def port(kernel_mode):
        c = repro_torch.compile(repro_torch.CompileSpec(
            model=tg, strategy="manual-plan", plan=plan,
            kernel_mode=kernel_mode, torch_device="cpu"))
        c.executor.params = params
        return c
    return request.param, jlp, port("auto"), port("reference")


def test_hand_cut_plan_reaches_the_codec_variants(hand_cut):
    thresh, _, c, _ = hand_cut
    counts = launch_table(c.graph, c.plan)
    fused = {k for k, n in counts.items() if n and (
        k.endswith("_encode") or "_decode" in k)}
    assert fused == THRESHOLDS[thresh]


def test_hand_cut_lowering_decisions_equal_reference(hand_cut):
    _, jlp, c, _ = hand_cut
    tg, plan = c.graph, c.plan
    jg = jbuilders.build_x3d_exec(**SMALL_X3D)
    jplan = JExecutionPlan.from_json(plan.to_json())
    tan = tex.analyze_plan(tg, plan, use_kernels=True)
    jan = jex.analyze_plan(jg, jplan, use_pallas=True, interpret=True)
    assert tan.topo == jan.topo and tan.bfp8_edges == jan.bfp8_edges
    for name in tan.topo:
        assert (dataclasses.asdict(tex._lower_vertex(tg, name, tan))
                == dataclasses.asdict(jex._lower_vertex(jg, name, jan))), name


def test_hand_cut_spill_report_equals_reference(hand_cut):
    _, jlp, c, _ = hand_cut
    spills = [dataclasses.asdict(s) for s in c.executor.report.spills]
    assert spills == [dataclasses.asdict(s) for s in jlp.report.spills]
    assert c.executor.report.summary() == jlp.report.summary()


def test_hand_cut_every_vertex_within_tolerance(hand_cut):
    _, jlp, c, _ = hand_cut
    x = _frame(c.input_shape())
    jvals = jlp.run_intermediates(jnp.asarray(x))
    tvals = c.executor.run_intermediates(torch.from_numpy(x))
    assert list(tvals) == list(jvals)
    for name, jv in jvals.items():
        jv, tv = np.asarray(jv), tvals[name].numpy()
        assert tv.shape == jv.shape, name
        err = float(np.abs(tv - jv).max(initial=0.0))
        lim = BFP8_TOL * float(np.abs(jv).max(initial=0.0))
        assert err <= lim, (f"first vertex off the reference: {name}, max "
                            f"err {err:.3e} > {lim:.3e}")


def test_hand_cut_kernel_route_equals_reference_route(hand_cut):
    """On the CPU the kernel route runs every fused variant's plain
    version; it computes the reference route's composition bit for bit."""
    _, _, c, ref = hand_cut
    for seed in (1, 2):
        x = _frame(c.input_shape(), seed=seed)
        np.testing.assert_array_equal(c.run(x).numpy(), ref.run(x).numpy())


# =============================================================================
# the eight variants' plain versions against the Pallas kernels
# =============================================================================

VARIANTS = [(kind, c, k) for kind in (
    "conv2d_decode", "conv2d_decode_encode", "dwconv_encode", "dwconv_decode",
    "dwconv_decode_encode", "act_relu_decode_encode", "pool_decode",
    "pool_decode_encode") for c in (3, 24, 40)
    for k in ((2, "m") if kind.startswith("pool") else (None,))]


@pytest.mark.parametrize("kind,c,k", VARIANTS)
def test_codec_variant_plain_version_matches_pallas(kind, c, k):
    m = 90 if k != "m" else 77
    m_out = {None: None, 2: m // 2, "m": 1}[k]
    dec, enc = "_decode" in kind, kind.endswith("_encode")
    x = _rand(c + len(kind), m, c, scale=2.0)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    tpay = jpay = None
    if dec:                 # one payload, random bytes in its padding
        cq = -(-c // 32) * 32
        man, exp = (np.array(a) for a in jbfp8.bfp8_quant_values(
            jnp.pad(jx, ((0, 0), (0, cq - c))), block=32))
        man[:, c:] = np.random.default_rng(c).integers(-127, 128,
                                                       (m, cq - c))
        jpay = (jnp.asarray(man), jnp.asarray(exp))
        tpay = (torch.from_numpy(man), torch.from_numpy(exp))
    kw = dict(payload=tpay, encode=enc)
    jkw = dict(payload=jpay, encode=enc, interpret=True)
    tin, jin = (None, None) if dec else (tx, jx)
    if kind.startswith("conv2d"):
        w = _rand(7, c, 48, scale=c ** -0.5)
        got = TSC.conv2d(tin, torch.from_numpy(w), **kw)
        want = JSC.conv2d(jin, jnp.asarray(w), **jkw)
    elif kind.startswith("dwconv"):
        w = _rand(8, 3, c)
        got = TSC.dwconv(tin, torch.from_numpy(w), **kw)
        want = JSC.dwconv(jin, jnp.asarray(w), **jkw)
    elif kind.startswith("pool"):
        got = TSC.pool(tin, m_out, c=c, **kw)
        want = JSC.pool(jin, m_out, c=c, **jkw)
    else:
        got = TSC.act_relu(tin, c=c, **kw)
        want = JSC.act_relu(jin, c=c, **jkw)
    ty, jy = (got[0], want[0]) if enc else (got, want)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    if enc:
        _payload_close(*got[1], *want[1], ty.numpy())


# =============================================================================
# the saved artifact
# =============================================================================

@pytest.fixture(scope="module")
def evict_all():
    """The small X3D with every stream BFP8-evicted, compiled by both
    packages from the same plan; the port holds the reference's weights."""
    tg, plan, jg, jplan = _plan_pair(0.0)
    jc = repro.compile(repro.CompileSpec(
        model=jg, strategy="manual-plan", plan=jplan, kernel_mode="pallas",
        interpret=True))
    tc = repro_torch.compile(repro_torch.CompileSpec(
        model=tg, strategy="manual-plan", plan=plan, torch_device="cpu"))
    tc.executor.params = params_from_numpy(
        {k: np.asarray(v) for k, v in jc.executor.params.items()})
    return jc, tc


def test_port_loads_the_reference_artifact(evict_all, tmp_path):
    """The reference's artifact (kernel_mode "pallas", interpret) loads on
    the CPU as the port's kernel route, runs the same plan, and with the
    reference's weights stays within tolerance of the reference's own load
    of the same file."""
    jc, _ = evict_all
    art = jc.save(tmp_path / "ref.smof.json")
    back = repro.Compiled.load(art)
    tc = repro_torch.Compiled.load(art, torch_device="cpu")
    assert tc.spec.strategy == "manual-plan" and tc.spec.kernel_mode == "auto"
    assert tc.executor.device.type == "cpu"
    assert tc.plan.to_json() == back.plan.to_json()
    assert tc.executor.report.summary() == back.executor.report.summary()
    tc.executor.params = params_from_numpy(
        {k: np.asarray(v) for k, v in back.executor.params.items()})
    x = _frame(tc.input_shape(), seed=3)
    want = np.asarray(back.run(jnp.asarray(x)))
    got = tc.run(x).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= BFP8_TOL * np.abs(want).max()


def test_port_save_then_load_is_bit_identical(evict_all, tmp_path):
    _, tc = evict_all
    own = repro_torch.compile(dataclasses.replace(tc.spec))
    back = repro_torch.Compiled.load(own.save(tmp_path / "port.smof.json"),
                                     torch_device="cpu")
    assert back.plan.to_json() == own.plan.to_json()
    for seed in (4, 5):
        x = _frame(own.input_shape(), seed=seed)
        np.testing.assert_array_equal(back.run(x).numpy(),
                                      own.run(x).numpy())


def test_port_artifact_has_the_reference_layout(evict_all, tmp_path):
    """The same keys, graph JSON and plan JSON as the reference writes for
    the same plan (provenance apart from who compiled it), kernel_mode in
    the reference's names and interpret null; and a reference artifact
    loaded and saved again by the port keeps its graph and plan JSON."""
    jc, tc = evict_all
    jd = json.loads(jc.save(tmp_path / "ref.smof.json").read_text())
    td = json.loads(tc.save(tmp_path / "port.smof.json").read_text())
    assert set(td) == set(jd)
    assert td["artifact"] == jd["artifact"] == "smof-compiled"
    assert td["artifact_schema_version"] == jd["artifact_schema_version"]
    assert td["graph"] == jd["graph"]
    tplan, jplan = copy.deepcopy(td["plan"]), copy.deepcopy(jd["plan"])
    tprov, jprov = tplan.pop("provenance"), jplan.pop("provenance")
    assert tplan == jplan
    assert tprov.pop("compiled_by") == "repro_torch.api.compile"
    assert jprov.pop("compiled_by") == "repro.api.compile"
    assert tprov == jprov
    assert td["kernel_mode"] == "auto" and td["interpret"] is None
    assert td["obs"] == jd["obs"]
    again = json.loads(repro_torch.Compiled.load(
        tmp_path / "ref.smof.json", torch_device="cpu").save(
            tmp_path / "again.smof.json").read_text())
    assert again["graph"] == jd["graph"] and again["plan"] == jd["plan"]


@pytest.mark.parametrize("kernel_mode", ["auto", "reference"])
def test_reference_loads_the_port_artifact(evict_all, tmp_path, kernel_mode):
    """The reference runs the port's artifact; with its weights carried
    over, the port's run of the same plan stays within tolerance."""
    _, tc = evict_all
    port = repro_torch.compile(dataclasses.replace(tc.spec,
                                                   kernel_mode=kernel_mode))
    back = repro.Compiled.load(port.save(tmp_path / "port.smof.json"))
    assert back.plan.to_json() == port.plan.to_json()
    assert back.spec.kernel_mode == kernel_mode
    port.executor.params = params_from_numpy(
        {k: np.asarray(v) for k, v in back.executor.params.items()})
    x = _frame(port.input_shape(), seed=6)
    want = np.asarray(back.run(jnp.asarray(x)))
    got = port.run(x).numpy()
    assert np.abs(got - want).max() <= BFP8_TOL * np.abs(want).max()


@pytest.mark.parametrize("obs", [dict(enabled=True),
                                 dict(trace_path="frame.trace.json"),
                                 dict(flight_capacity=64)])
def test_artifact_with_telemetry_loads_and_round_trips(evict_all, tmp_path,
                                                       obs):
    """An artifact whose ``obs`` asks for telemetry loads into the port
    with that ``obs``, and the reference loads the port's re-save of it."""
    _, tc = evict_all
    path = tc.save(tmp_path / "port.smof.json")
    d = json.loads(path.read_text())
    d["obs"].update(obs)
    path.write_text(json.dumps(d))
    back = repro_torch.Compiled.load(path, torch_device="cpu")
    assert back.spec.obs.to_dict() == d["obs"]
    again = back.save(tmp_path / "again.smof.json")
    assert json.loads(again.read_text())["obs"] == d["obs"]
    ref = repro.Compiled.load(again)
    assert ref.spec.obs.to_dict() == d["obs"]


def test_cuda_kernel_mode_is_saved_as_the_reference_kernel_route(
        evict_all, tmp_path):
    """The port's "cuda" is the reference's "pallas", both ways: on the
    CPU the kernel route loads as "auto", which runs the kernels' plain
    versions."""
    _, tc = evict_all
    path = tc.save(tmp_path / "port.smof.json")
    d = json.loads(path.read_text())
    d["kernel_mode"] = "pallas"
    path.write_text(json.dumps(d))
    back = repro_torch.Compiled.load(path, torch_device="cpu")
    assert back.spec.kernel_mode == "auto"
    x = _frame(tc.input_shape(), seed=7)
    np.testing.assert_array_equal(back.run(x).numpy(),
                                  repro_torch.compile(dataclasses.replace(
                                      tc.spec)).run(x).numpy())


# =============================================================================
# the executor's memory order
# =============================================================================

def test_no_decoded_input_is_held_through_the_output_encode(evict_all,
                                                            monkeypatch):
    """run_vertices drops a vertex's decoded inputs once its op returns, so
    they never sit on the device beside its output's standalone encode (a
    frame that evicts every stream would then peak above the same plan with
    its streams resident)."""
    _, tc = evict_all
    decoded, held = [], []
    decode, encode = tex.bfp8_spill_decode, tex.bfp8_spill_encode

    def watched_decode(*args, **kwargs):
        out = decode(*args, **kwargs)
        decoded.append(weakref.ref(out))
        return out

    def watched_encode(x, **kwargs):
        held.append(sum(r() is not None for r in decoded))
        return encode(x, **kwargs)

    monkeypatch.setattr(tex, "bfp8_spill_decode", watched_decode)
    monkeypatch.setattr(tex, "bfp8_spill_encode", watched_encode)
    tc.run(_frame(tc.input_shape(), seed=8))
    assert decoded and held, "the plan decodes and encodes standalone"
    assert not any(held), f"decoded inputs alive at each encode: {held}"
