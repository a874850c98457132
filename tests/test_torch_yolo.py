"""The YOLO head through the port on the CPU: the third slice of the main
path.

* the YOLOv8n-width head at P3 = 160 x 160 positions on the u200 sheet:
  the port's DSE emits the reference's plan JSON byte for byte and the same
  SpillReport, and one tick of the pipelined streamer launches, per plan,
  the table ``chip_smoke.py`` holds the card to (counted on the CPU at
  the wrappers, which run their plain versions here);
* the plain version of the conv2d egress encode (``_conv_enc_kernel``)
  against the reference's Pallas kernel in interpret mode: ``y`` within the
  matmul tolerance, the payload within the reference codec's tolerance
  (``tests/test_torch_kernels.py`` says why), and bit for bit the
  standalone encode of the same ``y``.
"""
import collections
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp                                     # noqa: E402
import torch                                                # noqa: E402

from repro.core import DSEConfig as JDSEConfig              # noqa: E402
from repro.core import builders as jbuilders                # noqa: E402
from repro.core.dse import run_dse as jrun_dse              # noqa: E402
from repro.core.plan import plan_from_dse as jplan_from_dse  # noqa: E402
from repro.core.resources import get_device as jget_device  # noqa: E402
from repro.kernels import streaming_conv as JSC             # noqa: E402
from repro.runtime.executor import lower_plan as jlower_plan  # noqa: E402

import repro_torch                                          # noqa: E402
from repro_torch.core import DSEConfig as TDSEConfig        # noqa: E402
from repro_torch.core import builders as tbuilders          # noqa: E402
from repro_torch.core.dse import run_dse as trun_dse        # noqa: E402
from repro_torch.core.plan import hand_cut_plan             # noqa: E402
from repro_torch.core.plan import plan_from_dse as tplan_from_dse  # noqa: E402
from repro_torch.core.resources import get_device as tget_device  # noqa: E402
from repro_torch.kernels import ref as tref                 # noqa: E402
from repro_torch.kernels import streaming_conv as TSC       # noqa: E402
from repro_torch.kernels.bfp8 import bfp8_quant_values      # noqa: E402
from repro_torch.runtime import executor as tex             # noqa: E402

# YOLOv8n's neck widths at the 1280 setting's P3 (160 x 160)
YOLO = dict(positions=160 * 160, widths=(64, 128, 256), head=64)
MATMUL_TOL = 2e-4


def _u200_cfg(pkg_cfg):
    return pkg_cfg(batch=1, codecs=("none", "bfp8"), word_bits=16,
                   cut_kinds=("pool", "conv"))


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


@pytest.fixture(scope="module")
def yolo_plans():
    """(reference graph, reference plan, port graph, port plan)."""
    jg = jbuilders.build_yolo_head_exec(**YOLO)
    tg = tbuilders.build_yolo_head_exec(**YOLO)
    jdev, tdev = jget_device("u200"), tget_device("u200")
    jp = jplan_from_dse(jg.name, jdev.name,
                        jrun_dse(jg, jdev, _u200_cfg(JDSEConfig)),
                        microbatch=8)
    tp = tplan_from_dse(tg.name, tdev.name,
                        trun_dse(tg, tdev, _u200_cfg(TDSEConfig)),
                        microbatch=8)
    return jg, jp, tg, tp


def test_yolo_plan_equals_reference(yolo_plans):
    _, jp, _, tp = yolo_plans
    assert tp.to_json() == jp.to_json()
    assert tp.n_stages == 1
    assert [(s.src, s.dst, s.codec) for s in tp.streams if s.evicted] == [
        ("conv_24", "output_31", "bfp8"), ("conv_27", "output_31", "bfp8")]
    assert {n: lp.weight_static_fraction for n, lp in tp.layers.items()
            if lp.weight_static_fraction < 1.0} == dict.fromkeys(
        ("conv_8", "conv_12", "conv_15", "conv_18", "conv_21"), 0.0)


def test_yolo_spill_report_equals_reference(yolo_plans):
    jg, jp, tg, tp = yolo_plans
    jrep = jlower_plan(jg, jp, kernel_mode="reference").report
    trep = tex.analyze_plan(tg, tp, use_kernels=True).report()
    assert ([dataclasses.asdict(s) for s in trep.spills]
            == [dataclasses.asdict(s) for s in jrep.spills])
    assert trep.summary() == jrep.summary()
    assert trep.summary()["spill_offchip_bits"] // 8 == 2_534_400


class _Counting:
    """Counts the kernel wrappers' calls by the kernel each launches on a
    CUDA tensor (``plain_dot``: a fragmented layer whose K pads to 128 or
    less, which ``streamed_matmul_padded`` leaves to ``torch.matmul``)."""

    def __init__(self, monkeypatch):
        self.counts = collections.Counter()
        for name in ("conv2d", "act_relu", "pool", "dwconv"):
            self._wrap(monkeypatch, TSC, name, lambda a, k, n=name: (
                f"{n}_encode" if k.get("encode") else n))
        self._wrap(monkeypatch, tex, "streamed_matmul_padded",
                   lambda a, k: ("streamed_matmul" if a[0].shape[1] > 128
                                 else "plain_dot"))
        for name in ("bfp8_quant", "bfp8_dequant"):
            self._wrap(monkeypatch, tex, name, lambda a, k, n=name: n)

    def _wrap(self, monkeypatch, mod, name, key):
        f = getattr(mod, name)

        def counted(*a, **k):
            self.counts[key(a, k)] += 1
            return f(*a, **k)
        monkeypatch.setattr(mod, name, counted)


@pytest.mark.parametrize("plan_kind,table", [
    # the DSE plan: conv_24 and conv_27 encode their evicted output in
    # their own launch; conv_12/15/18/21 stream their weights through
    # streamed_matmul, conv_8 (K = 128: no dynamic block) is a plain dot
    ("dse", {"conv2d": 6, "conv2d_encode": 2, "streamed_matmul": 4,
             "plain_dot": 1, "act_relu": 6, "pool": 4, "bfp8_dequant": 2}),
    # the 3-stage plan: 6 BFP8 edges, 3 of them decoded from the crossing
    # shift registers at the tick, 3 crossings raw
    ("three_stage", {"conv2d": 10, "conv2d_encode": 3, "act_relu": 3,
                     "act_relu_encode": 3, "pool": 4, "bfp8_dequant": 6}),
])
def test_yolo_tick_launch_table(yolo_plans, monkeypatch, plan_kind, table):
    """One stream of one microbatch runs T = S ticks, every stage at every
    tick; each tick launches the path's table."""
    _, _, tg, tp = yolo_plans
    if plan_kind == "three_stage":
        tg = tbuilders.build_yolo_head_exec(**YOLO)
        tp = hand_cut_plan(tg)
        crossing = {(s.src, s.dst) for s in tp.streams
                    if tp.layers[s.src].stage != tp.layers[s.dst].stage}
        evicted = {(s.src, s.dst) for s in tp.streams if s.evicted}
        assert crossing - evicted == {("concat_11", "conv_12"),
                                      ("conv_18", "pool_19"),
                                      ("conv_18", "conv_25")}
        assert evicted & crossing == {("act_3", "concat_14"),
                                      ("act_9", "concat_20"),
                                      ("conv_24", "output_31")}
        assert len(evicted) == 6
    c = repro_torch.compile(repro_torch.CompileSpec(
        model=tg, device="u200", strategy="manual-plan", plan=tp,
        mode="pipelined", microbatches=1, torch_device="cpu"))
    xs = torch.from_numpy(_rand(0, 1, *c.input_shape()))
    counting = _Counting(monkeypatch)
    ys = c.run(xs)
    assert tuple(ys.shape) == (1, 64 * (25600 + 12800 + 6400))
    ticks = c.executor.report.ticks
    assert ticks == tp.n_stages
    assert {k: n / ticks for k, n in counting.counts.items()} == table


# =============================================================================
# the plain conv2d egress encode against the reference's Pallas kernel
# =============================================================================

@pytest.mark.parametrize("m,k,n", [(45, 40, 24), (256, 64, 64),
                                   (130, 17, 100), (33, 384, 128),
                                   (7, 5, 1)])
def test_conv2d_encode_matches_reference(m, k, n):
    x, w = _rand(m * k, m, k), _rand(n, k, n, scale=1.0 / np.sqrt(k))
    y, (man, exp) = TSC.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                               encode=True)
    jy, (jman, jexp) = JSC.conv2d(jnp.asarray(x), jnp.asarray(w),
                                  encode=True, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=MATMUL_TOL,
                               atol=MATMUL_TOL)
    cq = -(-n // 32) * 32
    assert man.shape == (m, cq) and exp.shape == (m, cq // 32)
    assert man.dtype == exp.dtype == torch.int8
    _payload_close(man, exp, jman, jexp, y.numpy())
    # the same f32 y on both sides: the port's fused encode of the
    # reference's y against the reference's payload
    yq = torch.nn.functional.pad(torch.from_numpy(np.array(jy)),
                                 (0, cq - n))
    rman, rexp = bfp8_quant_values(yq, block=32)
    _payload_close(rman, rexp, jman, jexp, np.asarray(jy))
    # inside the port: the fused y is the plain conv's, the payload the
    # standalone encode of the block-padded y, bit for bit
    assert torch.equal(y, tref.conv2d_ref(torch.from_numpy(x),
                                          torch.from_numpy(w)))
    pman, pexp = bfp8_quant_values(
        torch.nn.functional.pad(y, (0, cq - n)), block=32)
    assert torch.equal(man, pman) and torch.equal(exp, pexp)
    assert torch.all(man[:, n:] == 0)


def _payload_close(tman, texp, jman, jexp, y):
    """Exponents equal away from powers of two, a mantissa off by at most
    one step, and in at most 1e-3 of the values (the reference's f32
    ``log2``/``exp2`` are inexact; ROADMAP.md, Queue 3)."""
    tman, texp = tman.numpy(), texp.numpy()
    jman, jexp = np.asarray(jman), np.asarray(jexp)
    m, cq = tman.shape
    yq = np.zeros((m, cq), np.float32)
    yq[:, :y.shape[1]] = y
    a = np.abs(yq.reshape(m, cq // 32, 32)).max(-1).astype(np.float64)
    a = np.where(a > 0, a, 1.0)
    same = ~(np.abs(a / np.exp2(np.round(np.log2(a))) - 1.0) < 2.0**-16)
    np.testing.assert_array_equal(texp[same], jexp[same])
    dman = np.abs(tman.astype(np.int32) - jman.astype(np.int32))[
        np.repeat(same, 32, axis=1)]
    assert dman.max(initial=0) <= 1 and (dman != 0).mean() <= 1e-3
