"""X3D through the port on the CPU: the second slice of the main path.

* a small X3D on the memory-starved sheet (4 BFP8-evicted edges) against
  the reference package's ``lower_plan`` in Pallas interpret mode, with the
  same weights and input: the SpillReport field for field, every vertex
  within 2e-2 x max|reference| (one mantissa step of a BFP8 block, as in
  test_torch_executor.py), and the kernel route against the reference
  route bit for bit;
* X3D-M at its published stage widths on the u200 sheet: the plan's JSON
  equals the reference's, and its launch table, read from the lowering
  without running a frame, is the one ``chip_smoke.py`` holds the card to;
* the plain versions of the kernels this slice adds against
  ``repro.kernels.ref`` and the Pallas kernels in interpret mode.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402
import torch                                                # noqa: E402

from repro.core import DSEConfig as JDSEConfig              # noqa: E402
from repro.core import builders as jbuilders                # noqa: E402
from repro.core.dse import run_dse as jrun_dse              # noqa: E402
from repro.core.plan import plan_from_dse as jplan_from_dse  # noqa: E402
from repro.core.resources import Device as JDevice          # noqa: E402
from repro.core.resources import get_device as jget_device  # noqa: E402
from repro.kernels import ref as jref                       # noqa: E402
from repro.kernels import streaming_conv as JSC             # noqa: E402
from repro.runtime.executor import lower_plan as jlower_plan  # noqa: E402

import repro_torch                                          # noqa: E402
from repro_torch.core import DSEConfig as TDSEConfig        # noqa: E402
from repro_torch.core import builders as tbuilders          # noqa: E402
from repro_torch.core import hand_cut_plan                  # noqa: E402
from repro_torch.core.dse import run_dse as trun_dse        # noqa: E402
from repro_torch.core.plan import plan_from_dse as tplan_from_dse  # noqa: E402
from repro_torch.core.resources import Device as TDevice    # noqa: E402
from repro_torch.core.resources import get_device as tget_device  # noqa: E402
from repro_torch.kernels import ref as tref                 # noqa: E402
from repro_torch.kernels import streaming_conv as TSC       # noqa: E402
from repro_torch.kernels.bfp8 import bfp8_quant             # noqa: E402
from repro_torch.runtime import executor as tex             # noqa: E402
from repro_torch.runtime.executor import launch_table      # noqa: E402
from repro_torch.runtime.executor import params_from_numpy  # noqa: E402

_TINY = dict(name="tiny_stream", compute_units=4096, onchip_bits=300_000,
             offchip_gbps=64.0, freq_mhz=500.0, reconfig_s=0.0)
SMALL_X3D = dict(positions=64, cin=3, widths=(24, 48), expansion=2, depth=2)
# X3D-M's stage widths (build_x3d_m) and its 16 frames of 128 x 128 after
# the stride-2 stem; expansion 2 for 2.25, depth 2 in every stage
X3D_M = dict(positions=16 * 128 * 128, cin=3, widths=(24, 48, 96, 192),
             expansion=2, depth=2)
BFP8_TOL = 2e-2


def _tiny_cfg(pkg_cfg):
    return pkg_cfg(batch=1, codecs=("none", "bfp8"), word_bits=16,
                   cut_kinds=("output",))


def _u200_cfg(pkg_cfg):
    return pkg_cfg(batch=1, codecs=("none", "bfp8"), word_bits=16,
                   cut_kinds=("pool", "conv"))


def _frame(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


# =============================================================================
# the small X3D against the reference's Pallas kernels
# =============================================================================

@pytest.fixture(scope="module")
def small_x3d():
    jg = jbuilders.build_x3d_exec(**SMALL_X3D)
    dev = JDevice(**_TINY)
    plan = jplan_from_dse(jg.name, dev.name,
                          jrun_dse(jg, dev, _tiny_cfg(JDSEConfig)),
                          microbatch=8)
    jlp = jlower_plan(jg, plan, kernel_mode="pallas", interpret=True)
    params = {k: np.asarray(v) for k, v in jlp.params.items()}

    def port(kernel_mode):
        c = repro_torch.compile(repro_torch.CompileSpec(
            model=tbuilders.build_x3d_exec(**SMALL_X3D),
            device=TDevice(**_TINY), dse=_tiny_cfg(TDSEConfig),
            kernel_mode=kernel_mode, torch_device="cpu"))
        c.executor.params = params_from_numpy(params)
        return c
    return jlp, port("auto"), port("reference")


def test_small_x3d_plan_reaches_the_slice_kernels(small_x3d):
    _, c, _ = small_x3d
    evicted = [s for s in c.executor.report.spills if s.reason == "evicted"]
    assert len(evicted) == 4 and all(s.codec == "bfp8" for s in evicted)
    counts = launch_table(c.graph, c.plan)
    assert counts["conv2d"] == 4 and counts["dwconv"] == 5
    assert counts["pool_encode"] == 1 and counts["bfp8_quant"] == 2


def test_small_x3d_spill_report_equals_reference(small_x3d):
    jlp, c, _ = small_x3d
    spills = [dataclasses.asdict(s) for s in c.executor.report.spills]
    assert spills == [dataclasses.asdict(s) for s in jlp.report.spills]
    assert c.executor.report.summary() == jlp.report.summary()


def test_small_x3d_every_vertex_within_tolerance(small_x3d):
    jlp, c, _ = small_x3d
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


def test_small_x3d_kernel_route_equals_reference_route(small_x3d):
    """On the CPU the kernel route runs the kernels' plain versions,
    standalone quants and the pool encode included; it computes the same
    composition as the reference route, bit for bit."""
    _, c, ref = small_x3d
    for seed in (1, 2):
        x = _frame(c.input_shape(), seed=seed)
        np.testing.assert_array_equal(c.run(x).numpy(), ref.run(x).numpy())


# =============================================================================
# X3D-M at its published stage widths on the u200 sheet
# =============================================================================

@pytest.fixture(scope="module")
def x3d_m_plans():
    """(reference plan JSON, port plan JSON, port plan, port graph)."""
    jg = jbuilders.build_x3d_exec(**X3D_M)
    tg = tbuilders.build_x3d_exec(**X3D_M)
    jdev, tdev = jget_device("u200"), tget_device("u200")
    jp = jplan_from_dse(jg.name, jdev.name,
                        jrun_dse(jg, jdev, _u200_cfg(JDSEConfig)),
                        microbatch=8)
    tp = tplan_from_dse(tg.name, tdev.name,
                        trun_dse(tg, tdev, _u200_cfg(TDSEConfig)),
                        microbatch=8)
    return jp.to_json(), tp.to_json(), tp, tg


def test_x3d_m_plan_equals_reference(x3d_m_plans):
    jjson, tjson, plan, _ = x3d_m_plans
    assert tjson == jjson
    evicted = [(s.src, s.dst) for s in plan.streams if s.evicted]
    assert evicted == [("act_4", "add_14"), ("add_14", "add_19"),
                       ("conv_29", "add_34"), ("conv_44", "add_49"),
                       ("conv_59", "add_64"), ("pool_67", "concat_68")]
    assert plan.n_stages == 1
    assert all(s.codec == "bfp8" for s in plan.streams if s.evicted)
    assert sum(lp.weight_static_fraction < 1.0
               for lp in plan.layers.values()) == 21


def test_x3d_m_launches_nine_kernels(x3d_m_plans):
    """X3D-M on u200 runs, per frame: conv2d 9x (the 8 SE bottleneck convs
    at m = 1 and the head), dwconv 9x, the standalone quant 4x (add_14 and
    three fragmented stage-end convs), the pool encode 1x (the feature-bank
    skip), pool 9x (4 SE global pools), act_relu 13x (1 encodes a skip),
    bfp8_dequant 6x, streamed_matmul 5x, and 12 plain dots."""
    _, _, plan, g = x3d_m_plans
    assert launch_table(g, plan) == {
        "conv2d": 9, "dwconv": 9, "bfp8_quant": 4, "pool_encode": 1,
        "pool": 9, "act_relu": 12, "act_relu_encode": 1, "bfp8_dequant": 6,
        "streamed_matmul": 5, "plain_dot": 12}
    an = tex.analyze_plan(g, plan, use_kernels=True)
    global_k = sorted(an.out_shape[g.in_edges(n)[0].src][0] for n in an.topo
                      if g.vertex(n).kind == "pool"
                      and an.out_shape[n][0] == 1)
    assert global_k == [32768, 65536, 131072, 262144]
    assert an.out_shape[an.topo[-1]] == (32768, 32)


# X3D-M at its published stage widths under three hand-cut one-stage plans:
# every edge deeper than 4096, 96 and 0 words BFP8-evicted, nothing
# fragmented (chip_smoke.py's x3d-evict-deep, -mid and -all, which it runs
# from a saved artifact)
HAND_CUT = {
    4096.0: ({"conv2d": 23, "conv2d_encode": 3, "dwconv": 5,
              "dwconv_encode": 4, "pool": 9, "pool_encode": 1,
              "act_relu": 12, "act_relu_encode": 1, "bfp8_quant": 1,
              "bfp8_dequant": 10}, 10, 96_239_616),
    96.0: ({"conv2d": 18, "conv2d_decode": 5, "conv2d_decode_encode": 3,
            "dwconv": 1, "dwconv_decode": 4, "dwconv_decode_encode": 4,
            "pool": 5, "pool_encode": 1, "pool_decode": 4, "act_relu": 4,
            "act_relu_encode": 9, "bfp8_quant": 11, "bfp8_dequant": 11},
           31, 337_379_328),
    0.0: ({"conv2d_decode_encode": 26, "dwconv_decode_encode": 9,
           "pool_decode_encode": 10, "act_relu_decode_encode": 13,
           "bfp8_quant": 11, "bfp8_dequant": 21}, 79, 659_621_622),
}


@pytest.mark.parametrize("thresh", sorted(HAND_CUT, reverse=True))
def test_x3d_m_hand_cut_launch_tables(thresh):
    """The launch table, BFP8 edge count and payload bytes each way per
    frame that chip_smoke.py holds each hand-cut plan to; the SE global
    pools decode and encode in one launch at k up to 262144 only when
    every stream is evicted."""
    g = tbuilders.build_x3d_exec(**X3D_M)
    plan = hand_cut_plan(g, 1, depth_thresh=thresh)
    table, edges, payload = HAND_CUT[thresh]
    assert launch_table(g, plan) == table
    an = tex.analyze_plan(g, plan, use_kernels=True)
    assert len(an.bfp8_edges) == edges
    assert sum(r.offchip_bits for r in an.spills) // 8 == payload
    fused_k = sorted(an.out_shape[g.in_edges(n)[0].src][0]
                     // an.out_shape[n][0] for n in an.topo
                     if g.vertex(n).kind == "pool"
                     and tex._lower_vertex(g, n, an).fuse_in)
    assert fused_k == {4096.0: [], 96.0: [2] * 4,
                       0.0: [2] * 6 + [32768, 65536, 131072,
                                       262144]}[thresh]


# =============================================================================
# the plain versions of this slice's kernels against the reference's
# =============================================================================

def _near_pow2(amax):
    """Blocks whose amax lies within 2^-16 (relative) of a power of two,
    where the reference's f32 log2 may miss the exponent."""
    a = np.where(amax > 0, amax, 1.0).astype(np.float64)
    return np.abs(a / np.exp2(np.round(np.log2(a))) - 1.0) < 2.0**-16


def _payload_close(tman, texp, jman, jexp, y):
    """Exponents equal away from powers of two, a mantissa off by at most
    one step, and in at most 1e-3 of the values (test_torch_kernels.py
    says why the reference's codec is inexact)."""
    tman, texp = tman.numpy(), texp.numpy()
    jman, jexp = np.asarray(jman), np.asarray(jexp)
    m, cq = tman.shape
    yq = np.zeros((m, cq), np.float32)
    yq[:, :y.shape[1]] = y
    same = ~_near_pow2(np.abs(yq.reshape(m, cq // 32, 32)).max(-1))
    np.testing.assert_array_equal(texp[same], jexp[same])
    dman = np.abs(tman.astype(np.int32) - jman.astype(np.int32))[
        np.repeat(same, 32, axis=1)]
    assert dman.max(initial=0) <= 1 and (dman != 0).mean() <= 1e-3


@pytest.mark.parametrize("m,c,taps", [(1, 24, 3), (64, 24, 3), (96, 48, 3),
                                      (45, 40, 5), (300, 96, 2)])
def test_dwconv_matches_reference(m, c, taps):
    """Within 4 ulps of the tap sum's magnitude: jitted, XLA:CPU contracts
    the reference's tap sum into FMAs (docs/KERNELS.md), the port rounds
    every product and sum."""
    x, w = _rand(m + c, m, c), _rand(taps, taps, c)
    x[0, :3] = -0.0
    got = TSC.dwconv(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    want = np.asarray(jax.jit(jref.dwconv_ref)(jnp.asarray(x),
                                               jnp.asarray(w)))
    xp = np.pad(np.abs(x), ((taps // 2, taps - 1 - taps // 2), (0, 0)))
    mag = sum(np.abs(w[k]) * xp[k:k + m] for k in range(taps))
    assert np.all(np.abs(got - want) <= 4 * 2.0**-24 * mag)
    pallas = np.asarray(JSC.dwconv(jnp.asarray(x), jnp.asarray(w),
                                   interpret=True))
    assert np.all(np.abs(got - pallas) <= 4 * 2.0**-24 * mag)


@pytest.mark.parametrize("r,c", [(2048, 32), (1024, 64), (512, 96),
                                 (256, 192)])
def test_bfp8_quant_matches_reference(r, c):
    """At the standalone quant's widths on the X3D-M path (24, 48, 96 and
    192 channels, padded to the block)."""
    x = _rand(r * c, r, c, scale=4.0)
    man, exp = bfp8_quant(torch.from_numpy(x))
    jman, jexp = jref.bfp8_quant_ref(jnp.asarray(x), block=32)
    _payload_close(man, exp, jman, jexp, x)


@pytest.mark.parametrize("m_out,c", [(32, 24), (1, 48), (45, 40)])
def test_pool_encode_matches_reference(m_out, c):
    """The mean of two rows is exact on both sides; the payload agrees
    within the reference codec's tolerance."""
    x = _rand(m_out + c, 2 * m_out, c, scale=3.0)
    y, (man, exp) = TSC.pool(torch.from_numpy(x), m_out, encode=True)
    jy, (jman, jexp) = JSC.pool(jnp.asarray(x), m_out, encode=True,
                                interpret=True)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(jref.pool_ref(jnp.asarray(x), m_out)))
    assert man.shape == (m_out, 32 * -(-c // 32))
    _payload_close(man, exp, jman, jexp, y.numpy())
    assert torch.equal(tref.pool_ref(torch.from_numpy(x), m_out), y)
