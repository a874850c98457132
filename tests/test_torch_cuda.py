"""The port's CUDA kernels and executor on the card.

Every test here needs an NVIDIA GPU and the CUDA toolkit (the kernels are
built from ``src/repro_torch/csrc`` at first use); without a card they
skip.  Run them on the card with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (DSEConfig, build_unet_exec,  # noqa: E402
                              build_x3d_exec)
from repro_torch.core.resources import Device               # noqa: E402
from repro_torch.kernels import ref                         # noqa: E402
from repro_torch.kernels import streaming_conv as SC        # noqa: E402
from repro_torch.kernels.bfp8 import (bfp8_dequant,         # noqa: E402
                                      bfp8_quant, bfp8_quant_values)
from repro_torch.kernels.library import launches, reset_launches  # noqa: E402
from repro_torch.kernels.streamed_matmul import (           # noqa: E402
    streamed_matmul, streamed_matmul_padded)

pytestmark = pytest.mark.cuda

# a memory-starved sheet: the DSE evicts and fragments everything it can
TINY = Device("tiny_stream", compute_units=4096, onchip_bits=300_000,
              offchip_gbps=64.0, freq_mhz=500.0, reconfig_s=0.0)
DSE = DSEConfig(batch=1, codecs=("none", "bfp8"), word_bits=16,
                cut_kinds=("output",))


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("m,c", [(77, 45), (256, 64), (1000, 512)])
def test_act_relu_bit_exact(gen, m, c):
    x = torch.randn(m, c, generator=gen, device="cuda")
    assert torch.equal(_bits(SC.act_relu(x)), _bits(ref.act_relu_ref(x)))
    y, (man, exp) = SC.act_relu(x, encode=True)
    yq = torch.nn.functional.pad(ref.act_relu_ref(x), (0, (-c) % 32))
    pman, pexp = bfp8_quant_values(yq, block=32)
    assert torch.equal(_bits(y), _bits(ref.act_relu_ref(x)))
    assert torch.equal(man, pman) and torch.equal(exp, pexp)


def test_act_relu_encode_non_finite_blocks(gen):
    """Blocks that hold a NaN or an infinity encode as the plain version
    does: exponent 0, a NaN's mantissa 0, an infinity clipped."""
    x = torch.randn(6, 96, generator=gen, device="cuda")
    x[0, 3] = x[2, 9] = float("nan")
    x[1, 40] = x[2, 70] = float("inf")
    x[3, 64] = -float("inf")
    x[4, 5], x[4, 6] = float("nan"), -float("nan")
    y, (man, exp) = SC.act_relu(x, encode=True)
    pman, pexp = bfp8_quant_values(ref.act_relu_ref(x), block=32)
    assert torch.equal(_bits(y), _bits(ref.act_relu_ref(x)))
    assert torch.equal(man, pman) and torch.equal(exp, pexp)
    assert exp[0, 0] == 0 and man[0, 3] == 0 and man[1, 40] == 127


@pytest.mark.parametrize("m,c,m_out", [(64, 40, 32), (300, 96, 150),
                                       (4096, 64, 1)])
def test_pool(gen, m, c, m_out):
    x = torch.randn(m, c, generator=gen, device="cuda")
    got, want = SC.pool(x, m_out), ref.pool_ref(x, m_out)
    if m // m_out == 2:
        assert torch.equal(_bits(got), _bits(want))
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("m,c,m_out", [(262144, 48, 1), (131072, 96, 1),
                                       (65536, 192, 1), (32768, 384, 1),
                                       (3 * 70001, 40, 3), (1000, 24, 1)])
def test_global_pool_within_its_tolerance(gen, m, c, m_out):
    """The tree reduction sums in another order than the plain mean: per
    channel |kernel - plain| <= 1e-5 * mean |x| (the first four are the
    SE global pools of X3D-M; x has both signs, as dwconv output has)."""
    x = torch.randn(m, c, generator=gen, device="cuda") + 0.1
    got, want = SC.pool(x, m_out), ref.pool_ref(x, m_out)
    lim = 1e-5 * x.abs().reshape(m_out, m // m_out, c).mean(1)
    assert bool(((got - want).abs() <= lim).all())


@pytest.mark.parametrize("m,c", [(64, 24), (300, 96), (2, 24)])
def test_pool_encode_bit_exact(gen, m, c):
    x = torch.randn(2 * m, c, generator=gen, device="cuda") * 3
    x[0, 0] = float("nan")
    x[5 % (2 * m), 1] = float("inf")
    y, (man, exp) = SC.pool(x, m, encode=True)
    want = ref.pool_ref(x, m)
    pman, pexp = bfp8_quant_values(
        torch.nn.functional.pad(want, (0, (-c) % 32)), block=32)
    nan = torch.isnan(want)             # a NaN's payload bits may differ
    assert torch.equal(torch.isnan(y), nan)
    assert torch.equal(_bits(y)[~nan], _bits(want)[~nan])
    assert torch.equal(man, pman) and torch.equal(exp, pexp)


@pytest.mark.parametrize("r,c", [(4096, 32), (300, 64), (77, 192)])
def test_bfp8_quant_bit_exact(gen, r, c):
    x = torch.randn(r, c, generator=gen, device="cuda") * 5
    x[::7] *= 2.0 ** -130                       # subnormal blocks
    x[1::9, :32] = 0.0
    x[2, 3] = float("nan")
    x[3, c - 1] = float("inf")
    x[4, 5], x[4, 6] = -float("inf"), -0.0
    man, exp = bfp8_quant(x)
    pman, pexp = bfp8_quant_values(x, block=32)
    assert torch.equal(man, pman) and torch.equal(exp, pexp)


@pytest.mark.parametrize("m,c,taps", [(1, 24, 3), (2, 48, 3), (1000, 96, 3),
                                      (4097, 384, 3), (300, 24, 5),
                                      (77, 40, 2)])
def test_dwconv_bit_exact(gen, m, c, taps):
    """Halo rows at both ends of the tile and of x, and +-0.0 inputs: the
    kernel rounds each product and sum as the plain tap sum does."""
    x = torch.randn(m, c, generator=gen, device="cuda")
    w = torch.randn(taps, c, generator=gen, device="cuda")
    x[0, :4] = -0.0
    x[-1, 4:8] = 0.0
    w[:, 0] = -0.0
    w[0, 1] = -1.0
    got, want = SC.dwconv(x, w), ref.dwconv_ref(x, w)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("m,k,n", [(1, 32, 48), (1, 384, 32), (1, 48, 32),
                                   (32768, 216, 32), (77, 45, 130),
                                   (300, 17, 5)])
def test_conv2d(gen, m, k, n):
    x = torch.randn(m, k, generator=gen, device="cuda")
    w = torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k)
    got = SC.conv2d(x, w)
    assert got.shape == (m, n)
    torch.testing.assert_close(got, ref.conv2d_ref(x, w), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("m,k,n", [(25600, 64, 64), (12800, 384, 128),
                                   (77, 45, 130), (300, 17, 5), (1, 1, 1)])
def test_conv2d_encode_bit_exact(gen, m, k, n):
    """The fused y is the plain conv2d kernel's bit for bit, the payload
    bfp8_quant of that y padded to the block; rows past m and columns past
    n are not written beyond the payload's zero padding."""
    x = torch.randn(m, k, generator=gen, device="cuda")
    w = torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k)
    y, (man, exp) = SC.conv2d(x, w, encode=True)
    assert torch.equal(_bits(y), _bits(SC.conv2d(x, w)))
    pman, pexp = bfp8_quant_values(
        torch.nn.functional.pad(y, (0, (-n) % 32)), block=32)
    assert torch.equal(man, pman) and torch.equal(exp, pexp)
    torch.testing.assert_close(y, ref.conv2d_ref(x, w), rtol=2e-4,
                               atol=2e-4)


def test_bfp8_dequant_bit_exact(gen):
    man = torch.randint(-128, 128, (300, 96), generator=gen, device="cuda",
                        dtype=torch.int8)
    exp = torch.randint(-128, 128, (300, 3), generator=gen, device="cuda",
                        dtype=torch.int8)
    assert torch.equal(_bits(bfp8_dequant(man, exp)),
                       _bits(ref.bfp8_dequant_ref(man, exp)))


@pytest.mark.parametrize("m,k,n,f", [(128, 256, 128, 0.0),
                                     (1000, 300, 200, 0.5),
                                     (77, 1536, 130, 0.25)])
def test_streamed_matmul(gen, m, k, n, f):
    x = torch.randn(m, k, generator=gen, device="cuda")
    w = torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k)
    torch.testing.assert_close(streamed_matmul_padded(x, w, static_fraction=f),
                               ref.conv2d_ref(x, w), rtol=2e-4, atol=2e-4)


def test_wrappers_refuse_what_the_kernels_cannot_take(gen):
    x = torch.randn(256, 256, generator=gen, device="cuda")
    with pytest.raises(ValueError):
        streamed_matmul(x.t(), x[:128], x[128:])          # not contiguous
    with pytest.raises(ValueError):
        SC.conv2d(x.t(), x)                               # not contiguous
    with pytest.raises(ValueError):
        bfp8_quant(x[:, :40])                             # C % 32 != 0
    with pytest.raises(ValueError):
        bfp8_quant(x.to(torch.float64))
    with pytest.raises(ValueError):
        SC.dwconv(x, x[:3, :128])                         # channels differ


def test_staged_executor_on_the_card(gen):
    """A plan that evicts two skips through BFP8 and fragments every weight
    layer runs through the kernels and stays on the reference route."""
    import repro_torch
    g = build_unet_exec(positions=256, base=64, levels=3)
    spec = dict(model=g, device=TINY, dse=DSE, torch_device="cuda")
    main = repro_torch.compile(repro_torch.CompileSpec(**spec))
    refc = repro_torch.compile(repro_torch.CompileSpec(
        **spec, strategy="manual-plan", plan=main.plan,
        kernel_mode="reference"))
    x = torch.randn(main.input_shape(), generator=gen, device="cuda")
    reset_launches()
    y = main.run(x)
    counts = launches()
    yr = refc.run(x)
    torch.cuda.synchronize()
    assert counts["act_relu_encode"] == 2 and counts["bfp8_dequant"] == 2
    assert counts["streamed_matmul"] > 0 and counts["pool"] == 2
    assert float((y - yr).abs().max()) <= 2e-2 * float(yr.abs().max())


def test_x3d_frame_on_the_card(gen):
    """A small X3D whose plan evicts 4 edges through BFP8 runs through the
    conv2d, dwconv, pool encode and standalone quant kernels and stays on
    the reference route."""
    import repro_torch
    g = build_x3d_exec(positions=64, cin=3, widths=(24, 48), expansion=2,
                       depth=2)
    spec = dict(model=g, device=TINY, dse=DSE, torch_device="cuda")
    main = repro_torch.compile(repro_torch.CompileSpec(**spec))
    refc = repro_torch.compile(repro_torch.CompileSpec(
        **spec, strategy="manual-plan", plan=main.plan,
        kernel_mode="reference"))
    x = torch.randn(main.input_shape(), generator=gen, device="cuda")
    reset_launches()
    y = main.run(x)
    counts = launches()
    yr = refc.run(x)
    torch.cuda.synchronize()
    assert counts["conv2d"] == 4 and counts["dwconv"] == 5
    assert counts["pool_encode"] == 1 and counts["bfp8_quant"] == 2
    assert counts["bfp8_dequant"] == 4 and counts["pool"] == 3
    assert float((y - yr).abs().max()) <= 2e-2 * float(yr.abs().max())


def _codec(y):
    """The codec's payload of y, its channels padded to the block."""
    return bfp8_quant_values(
        torch.nn.functional.pad(y, (0, (-y.shape[1]) % 32)), block=32)


def _codec_payload(gen, m, c):
    """The payload of a random (m, c) stripe, with random bytes in its
    padding channels: kernels and plain versions read only the first c."""
    man, exp = _codec(torch.randn(m, c, generator=gen, device="cuda") * 2)
    if c % 32:
        man[:, c:] = torch.randint(-127, 128, (m, man.shape[1] - c),
                                   generator=gen, device="cuda",
                                   dtype=torch.int8)
    return man, exp


def _split(got, encode):
    return got if encode else (got, None)


def _assert_payload(got, want):
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("m,k,n", [(262144, 3, 24), (77, 40, 130),
                                   (1, 384, 32), (4099, 24, 48)])
@pytest.mark.parametrize("encode", [False, True])
def test_conv2d_decode_variants(gen, m, k, n, encode):
    """y is the conv2d kernel's on the decode kernel's output bit for bit,
    the payload the codec's of that y, and y within 2e-4 of the plain
    version."""
    pay = _codec_payload(gen, m, k)
    w = torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k)
    y, ypay = _split(SC.conv2d(None, w, payload=pay, encode=encode), encode)
    xd = bfp8_dequant(*pay)[:, :k].contiguous()
    assert torch.equal(_bits(y), _bits(SC.conv2d(xd, w)))
    if encode:
        _assert_payload(ypay, _codec(y))
    torch.testing.assert_close(y, ref.conv2d_ref(xd, w), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("m,c,taps", [(1, 24, 3), (77, 40, 3),
                                      (4099, 48, 3), (300, 3, 5)])
@pytest.mark.parametrize("variant", ["encode", "decode", "decode_encode"])
def test_dwconv_codec_variants_bit_exact(gen, m, c, taps, variant):
    """y and payload bit for bit the plain decode -> dwconv -> encode, at
    c = 48 too, where a warp of the plain kernel spans two rows."""
    dec, enc = "decode" in variant, variant.endswith("encode")
    pay = _codec_payload(gen, m, c) if dec else None
    x = None if dec else torch.randn(m, c, generator=gen, device="cuda")
    w = torch.randn(taps, c, generator=gen, device="cuda")
    got = _split(SC.dwconv(x, w, payload=pay, encode=enc), enc)
    want = _split(SC._plain(lambda h: ref.dwconv_ref(h, w), x, c, pay, enc,
                            32), enc)
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    if enc:
        _assert_payload(got[1], want[1])


@pytest.mark.parametrize("m_out,k,c", [(128, 2, 40), (1, 262144, 48),
                                       (1, 8198, 24), (3, 70001, 3)])
@pytest.mark.parametrize("variant", ["encode", "decode", "decode_encode"])
def test_pool_codec_variants(gen, m_out, k, c, variant):
    """y is the pool kernel's on the (decoded) input bit for bit at every
    k, the payload the codec's of that y; against the plain mean y is bit
    for bit at k = 2 and within 1e-5 x mean |x| per channel above."""
    dec, enc = "decode" in variant, variant.endswith("encode")
    pay = _codec_payload(gen, m_out * k, c) if dec else None
    x = (bfp8_dequant(*pay)[:, :c].contiguous() if dec else
         torch.randn(m_out * k, c, generator=gen, device="cuda") + 0.1)
    y, ypay = _split(SC.pool(None if dec else x, m_out, c=c, payload=pay,
                             encode=enc), enc)
    assert torch.equal(_bits(y), _bits(SC.pool(x, m_out)))
    if enc:
        _assert_payload(ypay, _codec(y))
    want = ref.pool_ref(x, m_out)
    if k == 2:
        assert torch.equal(_bits(y), _bits(want))
    else:
        lim = 1e-5 * x.abs().reshape(m_out, k, c).mean(1)
        assert bool(((y - want).abs() <= lim).all())


@pytest.mark.parametrize("m,c", [(77, 3), (300, 40), (4096, 96)])
def test_act_relu_decode_encode_bit_exact(gen, m, c):
    pay = _codec_payload(gen, m, c)
    y, ypay = SC.act_relu(None, c=c, payload=pay, encode=True)
    wy, wpay = SC._plain(ref.act_relu_ref, None, c, pay, True, 32)
    assert torch.equal(_bits(y), _bits(wy))
    _assert_payload(ypay, wpay)


@pytest.mark.parametrize("m,c", [(77, 3), (4099, 24), (300, 40),
                                 (25600, 64), (4096, 96)])
def test_act_relu_decode_bit_exact(gen, m, c):
    """The decode alone, at ragged widths (random padding bytes in the
    payload) and at the YOLO head's: bit for bit its plain version and
    relu on the standalone decode kernel's output."""
    pay = _codec_payload(gen, m, c)
    y = SC.act_relu(None, c=c, payload=pay)
    want = SC._plain(ref.act_relu_ref, None, c, pay, False, 32)
    assert torch.equal(_bits(y), _bits(want))
    dec = bfp8_dequant(*pay)[:, :c].contiguous()
    assert torch.equal(_bits(y), _bits(SC.act_relu(dec)))


@pytest.mark.parametrize("thresh", [512.0, 64.0, 0.0])
def test_hand_cut_x3d_from_an_artifact_on_the_card(gen, tmp_path, thresh):
    """The small X3D under a hand-cut one-stage plan, compiled on the CPU,
    saved, and loaded on the card: it runs through the codec kernels and
    stays within tolerance of reference mode."""
    import repro_torch
    from repro_torch.core import hand_cut_plan
    g = build_x3d_exec(positions=64, cin=3, widths=(24, 48), expansion=2,
                       depth=2)
    saved = repro_torch.compile(repro_torch.CompileSpec(
        model=g, strategy="manual-plan", torch_device="cpu",
        plan=hand_cut_plan(g, 1, depth_thresh=thresh)))
    main = repro_torch.Compiled.load(saved.save(tmp_path / "x3d.smof.json"))
    refc = repro_torch.compile(repro_torch.CompileSpec(
        model=main.graph, strategy="manual-plan", plan=main.plan,
        kernel_mode="reference"))
    refc.executor.params = main.executor.params
    x = torch.randn(main.input_shape(), generator=gen, device="cuda")
    reset_launches()
    y = main.run(x)
    counts = launches()
    yr = refc.run(x)
    torch.cuda.synchronize()
    fused = {k: n for k, n in counts.items() if "decode" in k or k in (
        "conv2d_encode", "dwconv_encode")}
    assert sum(fused.values()) > 0
    assert float((y - yr).abs().max()) <= 2e-2 * float(yr.abs().max())


def test_pipelined_stream_on_the_card(gen):
    """A small YOLO head under a 3-stage plan that evicts its skips through
    BFP8, pipelined: every microbatch equals the staged executor on the
    same plan bit for bit, and the conv2d egress encode ran."""
    import repro_torch
    from repro_torch.core import build_yolo_head_exec, hand_cut_plan
    g = build_yolo_head_exec(positions=256, widths=(32, 64, 128), head=32)
    plan = hand_cut_plan(g, depth_thresh=512.0)
    spec = dict(model=g, strategy="manual-plan", plan=plan,
                torch_device="cuda")
    pipe = repro_torch.compile(repro_torch.CompileSpec(
        **spec, mode="pipelined", microbatches=4))
    staged = repro_torch.compile(repro_torch.CompileSpec(**spec))
    staged.executor.params = pipe.executor.params
    xs = torch.randn((4,) + pipe.input_shape(), generator=gen,
                     device="cuda")
    reset_launches()
    ys = pipe.run(xs)
    counts = launches()
    torch.cuda.synchronize()
    assert counts["conv2d_encode"] > 0
    for b in range(4):
        assert torch.equal(_bits(ys[b]), _bits(staged.run(xs[b])))


def test_raw_and_bfp8_crossings_of_one_producer_on_the_card(gen):
    """The small UNet cut into seven stages of three vertices: act_3 and
    act_6 each cross raw to the next stage and BFP8-evicted to a later one.
    Each crossing's off-chip hop carries its own form, and every
    microbatch equals the staged executor bit for bit."""
    import repro_torch
    from repro_torch.core import build_unet_exec, hand_cut_plan
    g = build_unet_exec()
    spec = dict(model=g, strategy="manual-plan", torch_device="cuda",
                plan=hand_cut_plan(g, 7))
    pipe = repro_torch.compile(repro_torch.CompileSpec(
        **spec, mode="pipelined", microbatches=4))
    staged = repro_torch.compile(repro_torch.CompileSpec(**spec))
    staged.executor.params = pipe.executor.params
    xs = torch.randn((4,) + pipe.input_shape(), generator=gen,
                     device="cuda")
    ys = pipe.run(xs)
    for b in range(4):
        assert torch.equal(_bits(ys[b]), _bits(staged.run(xs[b])))
