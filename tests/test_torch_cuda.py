"""The port's CUDA kernels and executor on the card.

Every test here needs an NVIDIA GPU and the CUDA toolkit (the kernels are
built from ``src/repro_torch/csrc`` at first use); without a card they
skip.  Run them on the card with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import math

import numpy as np
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
from repro_torch.testing import oracle                      # noqa: E402

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


def _hold_to_reference(main, refc, x, y, yr):
    """As chip_smoke.py's phase 3 (oracle.hold_to_reference on the staged
    executors of the same plan): every vertex of the kernel route held to
    its plain version on its own inputs, the output to frame_bound."""
    oracle.hold_to_reference(main.executor, refc.executor, refc.run, x, y,
                             yr)


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


# the last two: the UNet's ragged launches (22,080 rows padded to 22,144;
# 11,040 to 11,136)
@pytest.mark.parametrize("m,k,n,f", [(128, 256, 128, 0.0),
                                     (1000, 300, 200, 0.5),
                                     (77, 1536, 130, 0.25),
                                     (22080, 1024, 512, 0.5),
                                     (11040, 512, 1024, 0.25)])
def test_streamed_matmul(gen, m, k, n, f):
    x = torch.randn(m, k, generator=gen, device="cuda")
    w = torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k)
    torch.testing.assert_close(streamed_matmul_padded(x, w, static_fraction=f),
                               ref.conv2d_ref(x, w), rtol=2e-4, atol=2e-4)


def test_streamed_matmul_rows_do_not_depend_on_m(gen):
    """A row's result is summed in an order set by K alone: the first half
    of the rows on their own give the same bits as in the whole launch
    (what the staged, pipelined and served paths' bit-equality rests on)."""
    x = torch.randn(22272, 1024, generator=gen, device="cuda")
    w = torch.randn(1024, 512, generator=gen, device="cuda") / 32.0
    whole = streamed_matmul(x, w[:512], w[512:])
    half = streamed_matmul(x[:11136].contiguous(), w[:512], w[512:])
    assert torch.equal(_bits(whole[:11136]), _bits(half))


@pytest.mark.parametrize("kind", ["streamed_matmul", "flash_attention"])
def test_two_launches_are_bit_equal(gen, kind):
    from repro_torch.kernels.flash_attention import flash_attention
    if kind == "streamed_matmul":
        x = torch.randn(22144, 1024, generator=gen, device="cuda")
        w = torch.randn(1024, 512, generator=gen, device="cuda") / 32.0
        run = lambda: streamed_matmul(x, w[:512], w[512:])     # noqa: E731
    else:
        q, k, v = (torch.randn(1, 512, 32, 128, generator=gen, device="cuda")
                   for _ in range(3))
        run = lambda: flash_attention(q, k, v)                 # noqa: E731
    reset_launches()
    a, b = run(), run()
    torch.cuda.synchronize()
    assert launches()[kind] == 2
    assert torch.equal(_bits(a), _bits(b))


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
    _hold_to_reference(main, refc, x, y, yr)


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
    _hold_to_reference(main, refc, x, y, yr)


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


def _offset_view(t, elems):
    """A contiguous copy of t whose data starts ``elems`` elements into its
    storage: for f32 a base 4 bytes past 16-byte alignment, for int8 one
    byte past."""
    buf = torch.empty(t.numel() + elems, dtype=t.dtype, device=t.device)
    out = buf[elems:].view(t.shape)
    out.copy_(t)
    return out


CONV_K, CONV_N = (3, 5, 216, 384), (1, 24, 33, 48, 96, 128)


@pytest.mark.parametrize("m", [1, 31, 3200])
@pytest.mark.parametrize("variant", ["", "_encode", "_decode",
                                     "_decode_encode"])
def test_conv2d_variants_at_ragged_shapes(gen, m, variant):
    """Every conv2d variant at every k in CONV_K and n in CONV_N, ragged
    (k % 4 != 0, n % 32 != 0) and at m = 1: inputs whose rows are not
    16-byte aligned (a row-offset view at odd k, a base offset at every
    k, a mantissa base one byte off) give the aligned launch's bits, as
    do three column tiles a block (bc = 96) and a second launch on the
    same inputs; y is within 2e-4 of the plain version, the codec
    variants' y bit for bit the plain kernel's (on the decode kernel's
    output with the decode) and their payload the codec's of that y."""
    dec, enc = "_decode" in variant, variant.endswith("_encode")
    for k in CONV_K:
        for n in CONV_N:
            w = torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k)
            if dec:
                pay = _codec_payload(gen, m, k)
                xd = bfp8_dequant(*pay)[:, :k].contiguous()
                shifted = [(_offset_view(pay[0], 1), pay[1])]

                def run(p, bc=0):
                    return SC.conv2d(None, w, payload=p, encode=enc, bc=bc)
                got = run(pay)
                tiled3 = run(pay, 96)
            else:
                xd = torch.randn(m + 1, k, generator=gen, device="cuda")
                shifted = [xd[1:], _offset_view(xd[1:], 1)]
                xd = xd[1:].contiguous()

                def run(h, bc=0):
                    return SC.conv2d(h, w, encode=enc, bc=bc)
                got = run(xd)
                tiled3 = run(xd, 96)
            y, ypay = _split(got, enc)
            torch.testing.assert_close(y, ref.conv2d_ref(xd, w), rtol=2e-4,
                                       atol=2e-4)
            if dec or enc:
                assert torch.equal(_bits(y), _bits(SC.conv2d(xd, w))), (k, n)
            if enc:
                _assert_payload(ypay, _codec(y))
            again = run(pay if dec else xd)
            for out in [run(other) for other in shifted] + [tiled3, again]:
                o, opay = _split(out, enc)
                assert torch.equal(_bits(o), _bits(y)), (k, n)
                if enc:
                    _assert_payload(opay, ypay)


def _specials(gen, m, c):
    """A random (m, c) stripe with NaN, +-inf and -0.0 in some blocks and
    whole blocks of -0.0."""
    x = torch.randn(m, c, generator=gen, device="cuda") * 3
    x[::3, 0] = float("nan")
    x[1::5, c - 1] = float("inf")
    x[2::7, c // 2] = -float("inf")
    x[3::4, : min(c, 32)] = -0.0
    x[::2, c // 3] = -0.0
    return x


@pytest.mark.parametrize("c", [1, 3, 33, 64])
@pytest.mark.parametrize("m", [1, 77, 4099])
def test_act_relu_family_bit_exact_with_specials(gen, m, c):
    """relu, relu -> encode and decode -> relu -> encode at ragged c and
    m, with NaN, inf and -0.0 blocks: y bit for bit the plain version's
    (NaN and -0.0 pass through) at every row tile, payloads bit for bit
    the standalone codec's; an input not aligned for the wide loads gives
    the same bits."""
    x = _specials(gen, m, c)
    want = ref.act_relu_ref(x)
    for bm in SC.TILE_BM_CHOICES:   # row blocks that start or end mid-float4
        assert torch.equal(_bits(SC.act_relu(x, bm=bm)), _bits(want))
    for xin in (x, _offset_view(x, 1)):
        y, ypay = SC.act_relu(xin, encode=True)
        assert torch.equal(_bits(y), _bits(want))
        pman, pexp = bfp8_quant(torch.nn.functional.pad(want,
                                                        (0, (-c) % 32)))
        _assert_payload(ypay, (pman, pexp))
        _assert_payload(ypay, _codec(want))
    pay = _codec_payload(gen, m, c)
    pay[1][::5] = torch.tensor([-128, 0, 127], dtype=torch.int8,
                               device="cuda").repeat(
                                   pay[1].shape[1])[:pay[1].shape[1]]
    wy, wpay = SC._plain(ref.act_relu_ref, None, c, pay, True, 32)
    for p in (pay, (_offset_view(pay[0], 1), pay[1])):
        y, ypay = SC.act_relu(None, c=c, payload=p, encode=True)
        assert torch.equal(_bits(y), _bits(wy))
        _assert_payload(ypay, wpay)
        dec = bfp8_dequant(*pay)[:, :c].contiguous()
        assert torch.equal(_bits(y), _bits(SC.act_relu(dec, encode=True)[0]))


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


RAGGED_M = (1, 31, 4099)
RAGGED_C = (1, 3, 24, 45, 48, 96, 384)
POOL_K = (2, 3, 8, 9, 257, "m")     # "m": all m rows to one output row
DW_TAPS = (1, 2, 3, 5)
POOL_TOL = 1e-5                     # chip_smoke.py's, of mean |x|


def _serial_mean(x, m_out):
    """The pool kernels' order over k <= 8 rows: each channel summed in
    order from 0, then divided by k.  The divisor is a tensor, so the card
    divides; by a Python number it would multiply by the reciprocal."""
    k = x.shape[0] // m_out
    xv = x.view(m_out, k, x.shape[1])
    s = torch.zeros_like(xv[:, 0])
    for j in range(k):
        s = s + xv[:, j]
    return s / torch.full_like(s, float(k))


def _flat(out):
    return [out] if isinstance(out, torch.Tensor) else [out[0], *out[1]]


@pytest.mark.parametrize("kind", [op + var for op in ("pool", "dwconv")
                                  for var in ("", "_encode", "_decode",
                                              "_decode_encode")])
def test_pool_and_dwconv_variants_at_ragged_shapes(gen, kind):
    """Every pool and dwconv variant at m in RAGGED_M and c in RAGGED_C,
    pool at k in POOL_K (m output rows of k, or all m rows to one) and
    dwconv at taps in DW_TAPS.  Inputs whose rows are not 16-byte aligned
    (a row-offset view, a base-offset view, a mantissa base one byte off),
    read one by one, give the aligned launch's bits, and so does a second
    launch.  y is bit for bit the plain version's (dwconv; pool at k <= 8,
    whose order is the serial sum from 0, the plain mean's bits at k = 2),
    or within POOL_TOL x mean |x| per channel of the plain mean (pool at
    k > 8); a decoding variant's y is bit for bit the un-fused kernel's on
    the standalone decode's output, an encoding variant's payload the
    codec's of its y."""
    op = kind.split("_")[0]
    dec, enc = "_decode" in kind, kind.endswith("_encode")
    for m in RAGGED_M:
        for c in RAGGED_C:
            for arg in POOL_K if op == "pool" else DW_TAPS:
                if op == "pool":
                    m_out, k = (1, m) if arg == "m" else (m, arg)
                    rows = m_out * k

                    def run(xin, pay, m_out=m_out, c=c, enc=enc):
                        return SC.pool(xin, m_out, c=c, payload=pay,
                                       encode=enc)
                else:
                    rows = m
                    w = torch.randn(arg, c, generator=gen, device="cuda")

                    def run(xin, pay, w=w, enc=enc):
                        return SC.dwconv(xin, w, payload=pay, encode=enc)
                if dec:
                    pay = _codec_payload(gen, rows, c)
                    x = bfp8_dequant(*pay)[:, :c].contiguous()
                    forms = [(None, pay),
                             (None, (_offset_view(pay[0], 1), pay[1]))]
                else:
                    buf = torch.randn(rows + 1, c, generator=gen,
                                      device="cuda") + 0.1
                    x = buf[1:].clone()
                    forms = [(x, None), (buf[1:], None),
                             (_offset_view(x, 1), None)]
                got = run(*forms[0])
                for xin, p in forms[1:] + forms[:1]:
                    for a, b in zip(_flat(run(xin, p)), _flat(got)):
                        assert torch.equal(_bits(a), _bits(b)), (m, c, arg)
                y, ypay = _split(got, enc)
                if enc:
                    _assert_payload(ypay, _codec(y))
                if op == "dwconv":
                    want = ref.dwconv_ref(x, w)
                    if dec:
                        assert torch.equal(_bits(y), _bits(SC.dwconv(x, w)))
                elif k <= SC.POOL_SERIAL_MAX_K:
                    want = _serial_mean(x, m_out)
                    if k == 2:
                        assert torch.equal(_bits(y),
                                           _bits(ref.pool_ref(x, m_out)))
                else:
                    want = ref.pool_ref(x, m_out)
                    lim = POOL_TOL * x.abs().reshape(m_out, k, c).mean(1)
                    assert bool(((y - want).abs() <= lim).all()), (m, c, k)
                    want = None
                if op == "pool" and dec:
                    assert torch.equal(_bits(y), _bits(SC.pool(x, m_out)))
                if want is not None:
                    assert torch.equal(_bits(y), _bits(want)), (m, c, arg)


CODEC_C = (1, 3, 24, 40, 48, 64, 96)
CODEC_ROWS = (1, 77, 4099)


def _codec_specials(gen, r, c):
    """A random (r, c) stripe with subnormal rows, all-zero blocks, NaN and
    +-inf in some blocks."""
    x = torch.randn(r, c, generator=gen, device="cuda") * 3
    x[::4] *= 2.0 ** -130
    x[1::5, : min(c, 32)] = 0.0
    x[2::7, c // 2] = float("nan")
    x[3::6, c - 1] = float("inf")
    x[3::6, 0] = -float("inf")
    return x


@pytest.mark.parametrize("c", CODEC_C)
def test_bfp8_stripe_forms_bit_exact(gen, c):
    """bfp8_quant(x, width=w) of an (r, c) stripe and bfp8_dequant(man,
    exp, c=c) bit for bit their plain versions at r in CODEC_ROWS, widths
    w and w + 32 (a block of padding alone), with the edge-case blocks;
    a stripe or payload not aligned for the wide accesses, read one by one,
    gives the same bits; random payload bytes (any exponent, random
    padding mantissas) decode as the plain version decodes them."""
    for r in CODEC_ROWS:
        x = _codec_specials(gen, r, c)
        for width in (32 * -(-c // 32), 32 * -(-c // 32) + 32):
            want = bfp8_quant_values(x, block=32, width=width)
            for xin in (x, _offset_view(x, 1)):
                _assert_payload(bfp8_quant(xin, width=width), want)
            rand = (torch.randint(-128, 128, (r, width), generator=gen,
                                  device="cuda", dtype=torch.int8),
                    torch.randint(-128, 128, (r, width // 32), generator=gen,
                                  device="cuda", dtype=torch.int8))
            for man, exp in (want, rand):
                wy = ref.bfp8_dequant_ref(man, exp, c=c)
                for m in (man, _offset_view(man, 1)):
                    y = bfp8_dequant(m, exp, c=c)
                    assert y.shape == (r, c)
                    assert torch.equal(_bits(y), _bits(wy)), (r, c, width)


@pytest.mark.parametrize("taps", [9, 11])
@pytest.mark.parametrize("variant", ["", "_encode", "_decode",
                                     "_decode_encode"])
def test_dwconv_over_many_taps_bit_exact(gen, variant, taps):
    """More taps than the window kernel's instances (csrc/dwconv.cu,
    dwconv_any_taps_kernel): every variant bit for bit the plain version at
    m in RAGGED_M, c in RAGGED_C, with +-0.0 inputs and weights; a decoding
    variant's y the plain dwconv kernel's on the standalone decode."""
    dec, enc = "_decode" in variant, variant.endswith("_encode")
    for m in RAGGED_M:
        for c in RAGGED_C:
            w = torch.randn(taps, c, generator=gen, device="cuda")
            w[:, 0] = -0.0
            pay = _codec_payload(gen, m, c) if dec else None
            x = None
            if not dec:
                x = torch.randn(m, c, generator=gen, device="cuda")
                x[0, : min(c, 4)] = -0.0
            got = _split(SC.dwconv(x, w, payload=pay, encode=enc), enc)
            want = _split(SC._plain(lambda h: ref.dwconv_ref(h, w), x, c,
                                    pay, enc, 32), enc)
            assert torch.equal(_bits(got[0]), _bits(want[0])), (m, c)
            if enc:
                _assert_payload(got[1], want[1])
            if dec:
                xd = bfp8_dequant(*pay, c=c)
                assert torch.equal(_bits(got[0]), _bits(SC.dwconv(xd, w)))


def test_pools_on_two_streams_count_apart(gen):
    """Two pools over more than 8 rows (each finds its last block by the
    counters) launched at once on two CUDA streams, many times over: each
    result bit for bit its serial launch on the default stream."""
    xs = [torch.randn(m_out * k, c, generator=gen, device="cuda")
          for m_out, k, c in ((3, 70001, 40), (1, 262144, 48))]
    m_outs = (3, 1)
    serial = [SC.pool(x, m) for x, m in zip(xs, m_outs)]
    streams = [torch.cuda.Stream() for _ in xs]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(8):
        for i, (x, m) in enumerate(zip(xs, m_outs)):
            with torch.cuda.stream(streams[i]):
                outs[i].append(SC.pool(x, m))
    torch.cuda.synchronize()
    for want, got in zip(serial, outs):
        for y in got:
            assert torch.equal(_bits(y), _bits(want))
    keys = {k for k in SC._POOL_COUNTERS if k[0] == xs[0].device}
    assert {s.cuda_stream for s in streams} <= {k[1] for k in keys}


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
    _hold_to_reference(main, refc, x, y, yr)


def test_pipelined_stream_on_the_card(gen):
    """A small YOLO head under a 3-stage plan that evicts its skips through
    BFP8, pipelined: every microbatch equals the staged executor on the
    same plan bit for bit, the conv2d egress encode ran, and each
    microbatch holds against pipelined reference mode as chip_smoke.py's
    phase 3 holds it (vertices on the staged executor, the microbatch
    within its stream_bounds bound)."""
    import repro_torch
    from repro_torch.core import build_yolo_head_exec, hand_cut_plan
    g = build_yolo_head_exec(positions=256, widths=(32, 64, 128), head=32)
    plan = hand_cut_plan(g, depth_thresh=512.0)
    spec = dict(model=g, strategy="manual-plan", plan=plan,
                torch_device="cuda")
    pipe = repro_torch.compile(repro_torch.CompileSpec(
        **spec, mode="pipelined", microbatches=4))
    staged = repro_torch.compile(repro_torch.CompileSpec(**spec))
    pref = repro_torch.compile(repro_torch.CompileSpec(
        **spec, mode="pipelined", microbatches=4, kernel_mode="reference"))
    sref = repro_torch.compile(repro_torch.CompileSpec(
        **spec, kernel_mode="reference"))
    for c in (staged, pref, sref):
        c.executor.params = pipe.executor.params
    xs = torch.randn((4,) + pipe.input_shape(), generator=gen,
                     device="cuda")
    reset_launches()
    ys = pipe.run(xs)
    counts = launches()
    torch.cuda.synchronize()
    assert counts["conv2d_encode"] > 0
    yrs = pref.run(xs)
    bounds = oracle.stream_bounds(pref.run, xs, yrs)
    last = staged.executor.analysis.topo[-1]
    for b in range(4):
        vals = staged.executor.run_intermediates(xs[b])
        assert torch.equal(_bits(ys[b]), _bits(vals[last]))
        oracle.hold_to_reference(staged.executor, sref.executor, sref.run,
                                 xs[b], ys[b], yrs[b], bound=bounds[b],
                                 values=vals)


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


# -- flash_attention -----------------------------------------------------------

# (B, S, H, D): any S at B = 2, H = 3 (ragged tail rows and key tiles), 80
# heads at every other head width, then the LM path's shapes (yi-6b: 32
# heads of 128, prompts of 71 and 512)
FLASH_SHAPES = ([(2, S, 3, D) for D in (16, 64, 128)
                 for S in (1, 63, 64, 300, 512)]
                + [(2, 300, 40, D) for D in (16, 32, 64)]
                + [(1, 71, 32, 128), (1, 512, 32, 128)])


@pytest.mark.parametrize("B,S,H,D", FLASH_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_against_its_plain_version(gen, B, S, H, D, causal):
    """The kernel against the plain scan within rtol = atol = 2e-4 (the
    online softmax sums in another order), one launch a call."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.attention import chunked_attention
    q, k, v = (torch.randn(B, S, H, D, generator=gen, device="cuda")
               for _ in range(3))
    reset_launches()
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert launches()["flash_attention"] == 1
    want = chunked_attention(q, k, v, causal=causal, chunk=min(1024, S),
                             skip_masked=causal)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(got, ref.flash_attention_ref(
        q, k, v, causal=causal), rtol=2e-4, atol=2e-4)


# (B, Sq, Sk, H, D): keys of their own length, non-causal (the cross
# attention's: a decode step's one row, a prompt, ragged Sk and whisper's
# 1500 frames), and the wider head
FLASH_CROSS_SHAPES = [(4, Sq, Sk, 20, 64) for Sq in (1, 64, 77)
                      for Sk in (1, 37, 1499, 1500)] + [(2, 33, 130, 8, 128)]


@pytest.mark.parametrize("B,Sq,Sk,H,D", FLASH_CROSS_SHAPES)
def test_flash_attention_over_keys_of_their_own_length(gen, B, Sq, Sk, H,
                                                        D):
    """Non-causal q (B, Sq, H, D) over k, v (B, Sk, H, D): within rtol =
    atol = 2e-4 of the plain scan and the plain softmax, one launch, a
    second launch bit for bit the first; causal with Sk != Sq refused."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.attention import chunked_attention
    q = torch.randn(B, Sq, H, D, generator=gen, device="cuda")
    k, v = (torch.randn(B, Sk, H, D, generator=gen, device="cuda")
            for _ in range(2))
    reset_launches()
    got = flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert launches()["flash_attention"] == 1
    torch.testing.assert_close(got, chunked_attention(
        q, k, v, causal=False, chunk=min(1024, Sk)), rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(got, ref.flash_attention_ref(
        q, k, v, causal=False), rtol=2e-4, atol=2e-4)
    assert torch.equal(_bits(flash_attention(q, k, v, causal=False)),
                       _bits(got))
    if Sk != Sq:
        with pytest.raises(ValueError):
            flash_attention(q, k, v, causal=True)


def test_whisper_steps_run_the_kernel(gen):
    """Reduced whisper (2 encoder and 2 decoder layers) through the step
    builders on the card: one flash launch per encoder layer and two per
    decoder layer in a prefill, one per decoder layer in a decode step;
    the last logits and every cache leaf within 2e-4 x max|plain| of the
    plain route on the same weights, then three decode steps' logits."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import init_cache, init_params
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step
    cfg = ARCHS["whisper-large-v3"].reduced(n_layers=2)
    params = init_params(gen, cfg)
    B, S, s_max = 2, 11, 32
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                     device="cuda"),
             "enc_frames": torch.randn(B, cfg.enc_frames, cfg.d_model,
                                       generator=gen, device="cuda")}
    out = {}
    for kernels in (True, False):
        pre = make_prefill_step(cfg, B, s_max, use_kernels=kernels)
        dec = make_decode_step(cfg, B, s_max, use_kernels=kernels)
        reset_launches()
        logits, cache = pre(params, init_cache(cfg, B, s_max), batch)
        torch.cuda.synchronize()
        n = cfg.encoder_layers + 2 * cfg.n_layers
        assert launches()["flash_attention"] == (n if kernels else 0)
        steps = [logits]
        for t in range(3):
            # the same tokens on both routes: the prompt's first three
            logits, cache = dec(params, cache, batch["tokens"][:, t:t + 1],
                                torch.full((B,), S + t, device="cuda"))
            steps.append(logits)
        torch.cuda.synchronize()
        assert launches()["flash_attention"] == (
            n + 3 * cfg.n_layers if kernels else 0)
        out[kernels] = steps, cache
    (sk, ck), (sp, cp) = out[True], out[False]
    for got, want in list(zip(sk, sp)) + [(ck["pos_0"][n], cp["pos_0"][n])
                                          for n in ("k", "v", "xk", "xv")]:
        tol = 2e-4 * float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=0, atol=tol)
    # a gradient through the encoder's and the cross attention: the lse
    # instance and both backward kernels (remat "full": each decoder group
    # forward and recomputed), every leaf within 2e-4 x max(1, max|plain|)
    # of the plain route's
    from repro_torch.runtime.steps import loss_and_grads
    labels = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                           device="cuda")
    grads = {}
    for kernels in (True, False):
        reset_launches()
        grads[kernels] = loss_and_grads(params, cfg, batch["tokens"], labels,
                                        enc_frames=batch["enc_frames"],
                                        use_kernels=kernels)
        torch.cuda.synchronize()
        E, L = cfg.encoder_layers, cfg.n_layers
        assert launches() == dict.fromkeys(launches(), 0) | ({
            "flash_attention_lse": E + 2 * 2 * L,
            "flash_attention_bwd_dq": E + 2 * L,
            "flash_attention_bwd_dkdv": E + 2 * L} if kernels else {})
    (lk, gk), (lp, gp) = grads[True], grads[False]
    _within(lk, lp, "loss")
    from repro_torch.models.model import _leaves
    for (n, g), (_, w) in zip(_leaves(gk), _leaves(gp)):
        _within(g, w, n)


def test_flash_attention_raises_without_its_library(gen, monkeypatch,
                                                    tmp_path):
    """No kernel library (it cannot be built): the wrapper and the
    engine's prefill raise; nothing runs the plain version instead."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import library
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import init_params
    from repro_torch.serving import ServingEngine
    monkeypatch.setattr(library, "_LIBRARY", None)
    monkeypatch.setattr(library, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(library, "_nvcc", lambda: str(tmp_path / "no-nvcc"))
    q = torch.randn(1, 8, 2, 16, generator=gen, device="cuda")
    with pytest.raises((RuntimeError, OSError)):
        flash_attention(q, q, q)
    cfg = ARCHS["yi-6b"].reduced()
    eng = ServingEngine(cfg, init_params(gen, cfg), device="cuda")
    with pytest.raises((RuntimeError, OSError)):
        eng.run_prefill(np.arange(5))


def test_engine_prefill_runs_the_kernel(gen):
    """The serving prefill on the card: one flash launch per layer, first
    logits and KV pages within 2e-4 x max|plain| of the plain route on
    the same weights."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import init_params
    from repro_torch.serving import ServingEngine
    cfg = ARCHS["yi-6b"].reduced(n_layers=3)
    params = init_params(gen, cfg)
    kern = ServingEngine(cfg, params, s_max=128, device="cuda")
    plain = ServingEngine(cfg, params, s_max=128, device="cuda",
                          kernel_mode="reference")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, 77)
    reset_launches()
    lk, ck = kern.run_prefill(prompt)
    torch.cuda.synchronize()
    assert launches()["flash_attention"] == cfg.n_layers
    lp, cp = plain.run_prefill(prompt)
    assert launches()["flash_attention"] == cfg.n_layers
    for got, want in [(lk, lp)] + [(ck[pj][n], cp[pj][n]) for pj in cp
                                   for n in ("k", "v")]:
        tol = 2e-4 * float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=0, atol=tol)


def test_moe_engine_prefill_routes_within_near_ties(gen):
    """olmoe reduced (3 layers, capacity factor 1.25) served on the card,
    prompts of 77, 512 and 130 tokens: one flash launch per layer, every
    prefill held to the plain route on the same weights by the router
    rule of chip_smoke.py (``testing.routing.hold_routing``: the routes
    choose alike, or part at a plain-route near-tie); where they choose
    alike, first logits and KV pages within 2e-4 x max|plain|."""
    import dataclasses
    from repro_torch.configs import ARCHS
    from repro_torch.models import init_params
    from repro_torch.serving import ServingEngine
    from repro_torch.testing.routing import RoutingTape, hold_routing
    cfg = ARCHS["olmoe-1b-7b"].reduced(n_layers=3)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.25))
    params = init_params(gen, cfg)
    kern = ServingEngine(cfg, params, s_max=600, device="cuda")
    plain = ServingEngine(cfg, params, s_max=600, device="cuda",
                          kernel_mode="reference")
    rng = np.random.default_rng(0)
    for n in (77, 512, 130):
        prompt = rng.integers(0, cfg.vocab, n)
        reset_launches()
        with RoutingTape() as tape:
            lk, ck = kern.run_prefill(prompt)
            torch.cuda.synchronize()
            assert launches()["flash_attention"] == cfg.n_layers
            rk = tape.take()
            lp, cp = plain.run_prefill(prompt)
            rp = tape.take()
        assert launches()["flash_attention"] == cfg.n_layers
        assert len(rk) == len(rp) == cfg.n_layers
        hold = hold_routing(rk, rp, 2e-4)
        if hold.parted is None:
            held = [(lk, lp)] + [(ck[pj][n], cp[pj][n]) for pj in cp
                                 for n in ("k", "v")]
        else:
            # the layers up to the one whose routing parted
            held = [(ck[pj][n][:hold.parted + 1],
                     cp[pj][n][:hold.parted + 1])
                    for pj in cp for n in ("k", "v")]
        for got, want in held:
            tol = 2e-4 * float(want.abs().max())
            torch.testing.assert_close(got, want, rtol=0, atol=tol)


# -- the plan's tiles ----------------------------------------------------------

def _tiled_calls(gen, kind):
    """(call(bm, bc) -> outputs as a flat list, bc choices it takes) for a
    tiled wrapper variant at ragged shapes."""
    op = kind.split("_")[0]                 # conv2d, dwconv, pool, act
    dec, enc = "_decode" in kind, kind.endswith("_encode")
    m, c = 300, 40
    tree = "_tree" in kind                  # k = 300: the tree passes
    if tree:
        m = 900
    x = torch.randn(m, c, generator=gen, device="cuda") * 3
    pay = _codec(x) if dec else None
    xin = None if dec else x
    kw = dict(payload=pay, encode=enc)
    if op == "conv2d":
        w = torch.randn(c, 130, generator=gen, device="cuda") / math.sqrt(c)
        fn = lambda bm, bc: SC.conv2d(xin, w, bm=bm, bc=bc, **kw)  # noqa: E731
        bcs = SC.TILE_BC_CHOICES
    elif op == "dwconv":
        w = torch.randn(3, c, generator=gen, device="cuda")
        fn = lambda bm, bc: SC.dwconv(xin, w, bm=bm, **kw)       # noqa: E731
        bcs = (0,)
    elif op == "pool":
        m_out = 3 if tree else 150
        fn = lambda bm, bc: SC.pool(xin, m_out, c=c, bm=bm,      # noqa: E731
                                    **kw)
        bcs = (0,)
    else:
        fn = lambda bm, bc: SC.act_relu(xin, c=c, bm=bm, **kw)   # noqa: E731
        bcs = (0,)

    def call(bm, bc):
        out = fn(bm, bc)
        return list(out[:1]) + list(out[1]) if enc else [out]
    return call, bcs


TILED = [f"{op}{var}" for op in ("conv2d", "dwconv", "pool", "act_relu")
         for var in ("", "_encode", "_decode", "_decode_encode")] + [
    "pool_tree", "pool_tree_encode"]


@pytest.mark.parametrize("kind", TILED)
def test_every_tile_gives_the_untiled_result(gen, kind):
    """Every TILE_BM_CHOICES x TILE_BC_CHOICES value a kernel takes gives
    output bit-equal to tile 0 (ragged rows and channels)."""
    call, bcs = _tiled_calls(gen, kind)
    want = call(0, 0)
    for bm in SC.TILE_BM_CHOICES:
        for bc in bcs:
            for g, w in zip(call(bm, bc), want):
                assert torch.equal(_bits(g), _bits(w)), (kind, bm, bc)


# -- the closed-loop autotuner ------------------------------------------------

def test_measure_pipelined_fps_times_with_cuda_events(gen, monkeypatch):
    """On the card a stream is timed by two CUDA events a run (warm-up
    included), and the rate is ticks over the best run."""
    import repro_torch
    from repro_torch.core import build_yolo_head_exec
    from repro_torch.optim.autotune import measure_pipelined_fps
    made, real = [], torch.cuda.Event

    def Event(*a, **k):
        made.append(real(*a, **k))
        return made[-1]
    c = repro_torch.compile(repro_torch.CompileSpec(
        model=build_yolo_head_exec(positions=256), mode="pipelined",
        microbatches=4, torch_device="cuda"))
    xs = torch.randn((4,) + c.input_shape(), generator=gen, device="cuda")
    monkeypatch.setattr(torch.cuda, "Event", Event)
    fps = measure_pipelined_fps(c.executor, xs, repeats=2, warmup=1)
    assert len(made) == 2 * 3
    assert math.isfinite(fps) and fps > 0


def test_autotuned_server_on_the_card(gen):
    """GraphStreamServer.autotuned with the kernel route on the card: every
    candidate ran its kernels, a staged frame of the winner launches
    exactly ``launch_table``, and every served result is the staged
    executor's on the same plan, bit for bit."""
    import repro_torch
    from repro_torch.core import build_yolo_head_exec
    from repro_torch.optim.autotune import AutotuneConfig
    from repro_torch.runtime.executor import launch_table
    from repro_torch.serving import GraphStreamServer
    g = build_yolo_head_exec(positions=256, widths=(32, 64, 128), head=32)
    cfg = AutotuneConfig(n_candidates=4, microbatches=4, repeats=1,
                         warmup=1, kernel_mode="cuda")
    reset_launches()
    srv = GraphStreamServer.autotuned(g, "u200", autotune_cfg=cfg,
                                      kernel_mode="cuda")
    assert launches()["conv2d"] > 0
    res = srv.autotune_result
    assert len(res.trajectory) == 4 and res.best_fps >= res.baseline_fps
    assert srv.executor.plan is res.best_plan and srv.microbatches == 4
    staged = repro_torch.compile(repro_torch.CompileSpec(
        model=g, strategy="manual-plan", plan=res.best_plan,
        kernel_mode="cuda"))
    staged.executor.params = srv.executor.params
    frames = [torch.randn(staged.input_shape(), generator=gen,
                          device="cuda") for _ in range(6)]
    reset_launches()
    staged.run(frames[0])
    torch.cuda.synchronize()
    table = {k: n for k, n in launch_table(g, res.best_plan).items()
             if k != "plain_dot"}
    assert {k: n for k, n in launches().items() if n} == table
    tickets = [srv.submit(f) for f in frames]
    srv.flush()
    for t, f in zip(tickets, frames):
        assert torch.equal(_bits(srv.result(t)), _bits(staged.run(f)))


# -- flash attention's gradient and the train step ------------------------------

# (B, S, H, D): ragged S at every head width, causal and not; S one below
# and one above the backward kernels' 32-row tiles and 64-row blocks and
# their doubles at the narrowest and widest heads; then yi-6b's train shape
# (32 heads of 128 at S = 1024)
BWD_SHAPES = ([(2, S, 3, D) for D in (16, 32, 64, 128)
               for S in (1, 63, 64, 130, 300)]
              + [(2, S, 3, D) for D in (16, 128)
                 for S in (31, 33, 65, 127, 129)]
              + [(1, 1024, 32, 128)])


def _within(got, want, what=""):
    """Within 2e-4 x max(1, max|plain|), the port's vertex tolerance."""
    lim = 2e-4 * max(1.0, float(want.abs().max()))
    err = float((got.double() - want.double()).abs().max())
    assert err <= lim, f"{what}: {err} > {lim}"


@pytest.mark.parametrize("B,S,H,D", BWD_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_lse_variant_against_its_plain_version(gen, B, S, H, D,
                                                     causal):
    """The lse instance: o bit for bit the serving instance's (one kernel
    body), o and lse within tolerance of chunked_attention's."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_lse)
    from repro_torch.models.attention import chunked_attention
    q, k, v = (torch.randn(B, S, H, D, generator=gen, device="cuda")
               for _ in range(3))
    reset_launches()
    o, lse, _ = flash_attention_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert launches()["flash_attention_lse"] == 1
    assert launches()["flash_attention"] == 0
    assert torch.equal(_bits(o), _bits(flash_attention(q, k, v,
                                                       causal=causal)))
    po, plse, _ = chunked_attention(q, k, v, causal=causal,
                                    chunk=min(1024, S), skip_masked=causal,
                                    return_lse=True)
    _within(o, po, "o")
    _within(lse, plse, "lse")


@pytest.mark.parametrize("B,S,H,D", BWD_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_kernels_against_their_plain_versions(gen, B, S, H,
                                                             D, causal):
    """dq (and delta) and dk, dv within tolerance of the blockwise plain
    versions on the same o and lse, one launch of each kernel, and a
    second pair of launches bit for bit the first."""
    from repro_torch.kernels import flash_attention as FA
    q, k, v, do = (torch.randn(B, S, H, D, generator=gen, device="cuda")
                   for _ in range(4))
    o, lse, _ = FA.flash_attention_lse(q, k, v, causal=causal)
    reset_launches()
    got = FA.flash_attention_backward(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert launches()["flash_attention_bwd_dq"] == 1
    assert launches()["flash_attention_bwd_dkdv"] == 1
    want = FA.flash_attention_backward_plain(q, k, v, o, lse, do, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _within(g, w, name)
    again = FA.flash_attention_backward(q, k, v, o, lse, do, causal)
    for g, a in zip(got, again):
        assert torch.equal(_bits(g), _bits(a))


# (B, Sq, Sk, H, D): keys of their own length for the training instances
# (non-causal): ragged Sk against one row and a prompt, whisper's cross and
# encoder attention at batch 1, a wide head
TRAIN_CROSS_SHAPES = ([(2, Sq, Sk, 4, 64) for Sq in (1, 64)
                       for Sk in (1, 37, 1499)]
                      + [(1, 448, 1500, 20, 64), (1, 1500, 1500, 20, 64),
                         (2, 33, 130, 3, 128), (2, 130, 33, 3, 16)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,Sq,Sk,H,D", TRAIN_CROSS_SHAPES)
def test_flash_training_kernels_over_keys_of_their_own_length(gen, B, Sq, Sk,
                                                              H, D, dtype):
    """The lse instance and both backward kernels, non-causal, q (B, Sq,
    H, D) over k, v (B, Sk, H, D): o, lse, o in f32, dq, delta, dk and dv
    against their plain versions (f32: within 2e-4 x max(1, max|plain|);
    bf16: within one bf16 ulp plus twice the f32 sums' slack, lse, o in f32
    and delta as f32), one launch each, a second pair of backward launches bit for bit
    the first; a causal call at Sk != Sq refused."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models.attention import chunked_attention
    from repro_torch.testing.ulp import f32_slack
    q, do = (torch.randn(B, Sq, H, D, generator=gen, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn(B, Sk, H, D, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    plain = chunked_attention(q, k, v, causal=False, chunk=min(1024, Sk),
                              return_lse=True)
    reset_launches()
    got = FA.flash_attention_lse(q, k, v, causal=False)
    _, plse, po = plain
    dq = FA.flash_attention_bwd_dq(q, k, v, po, do, plse, False)
    pdq = FA.flash_attention_bwd_dq_plain(q, k, v, po, do, plse, False)
    dkdv = FA.flash_attention_bwd_dkdv(q, k, v, do, plse, pdq[1], False)
    pdkdv = FA.flash_attention_bwd_dkdv_plain(q, k, v, do, plse, pdq[1],
                                              False)
    torch.cuda.synchronize()
    suffix = "" if dtype == torch.float32 else "_bf16"
    assert {n: c for n, c in launches().items() if c} == {
        f"flash_attention_lse{suffix}": 1,
        f"flash_attention_bwd_dq{suffix}": 1,
        f"flash_attention_bwd_dkdv{suffix}": 1}
    assert dkdv[0].shape == dkdv[1].shape == k.shape
    if dtype == torch.float32:
        for name, g, w in zip(("o", "lse", "o wide", "dq", "delta", "dk",
                               "dv"), (*got, *dq, *dkdv),
                              (*plain, *pdq, *pdkdv)):
            _within(g, w, name)
    else:
        sl = f32_slack(q, k, v, False, do)
        _within_one_bf16_ulp(got, plain, (sl["o"],))
        _within_one_bf16_ulp(dq, pdq, (sl["dq"],))
        _within_one_bf16_ulp(dkdv, pdkdv, (sl["dk"], sl["dv"]))
    again = (*FA.flash_attention_bwd_dq(q, k, v, po, do, plse, False),
             *FA.flash_attention_bwd_dkdv(q, k, v, do, plse, pdq[1], False))
    for g, a in zip((*dq, *dkdv), again):
        assert torch.equal(g.view(torch.int16) if g.dtype == torch.bfloat16
                           else _bits(g), a.view(torch.int16)
                           if a.dtype == torch.bfloat16 else _bits(a))
    if Sk != Sq:
        with pytest.raises(ValueError):
            FA.flash_attention_lse(q, k, v, causal=True)
        with pytest.raises(ValueError):
            FA.flash_attention_bwd_dq(q, k, v, po, do, plse, True)


@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_flash_backward_kernels_fit_the_card(gen, D):
    """Each f32 backward kernel launches at least one block an SM with its
    shared memory (planes of 64 rows x D in hi and lo for two operands, a
    2-stage ring of two 32-row tiles, D rows of at least 32 floats, its
    slices and row statistics) within the H100's 227 KB a block; each bf16
    one two blocks (two stationary operands of 64 bf16 rows, a 3-stage
    ring of two 32-row tiles, D of the rows or lse and D of 3 tiles)."""
    from repro_torch.kernels.flash_attention import backward_occupancy
    ld = max(D, 32)
    want = {"flash_attention_bwd_dq": 4 * 64 * D * 4
            + 4 * (4 * 32 * ld + 4 * 16 * 36 + 2 * 64),
            "flash_attention_bwd_dkdv": 4 * 64 * D * 4
            + 4 * (4 * 32 * ld + 8 * 16 * 36 + 4 * 32),
            "flash_attention_bwd_dq_bf16": 2 * (2 * 64 * D + 6 * 32 * D)
            + 4 * 64,
            "flash_attention_bwd_dkdv_bf16": 2 * (2 * 64 * D + 6 * 32 * D)
            + 4 * 6 * 32}
    got = backward_occupancy(D)
    assert set(got) == set(want)
    for name, (nbytes, regs, blocks) in got.items():
        assert nbytes == want[name] <= 232_448, name
        assert 0 < regs <= 255 and blocks >= (
            2 if name.endswith("_bf16") else 1), (name, regs, blocks)


@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_flash_forward_bf16_kernels_fit_the_card(gen, D):
    """Each bf16 forward kernel (csrc/flash_attention_bf16.cu) launches at
    least two blocks an SM, as designed, with its shared memory (q^ of 64
    rows and a 3-stage ring of a k and a v tile of BF16_FORWARD_TILE keys,
    D bf16 values a row) within the H100's 227 KB a block and at most 255
    registers a thread."""
    from repro_torch.kernels.flash_attention import (BF16_FORWARD_TILE,
                                                     forward_occupancy)
    want = 2 * (64 * D + 6 * BF16_FORWARD_TILE * D)
    got = forward_occupancy(D)
    assert set(got) == {"flash_attention_bf16", "flash_attention_lse_bf16"}
    for name, (nbytes, regs, blocks) in got.items():
        assert nbytes == want <= 232_448, name
        assert 0 < regs <= 255 and blocks >= 2, (name, regs, blocks)


def test_flash_attention_autograd_on_the_card(gen):
    """FlashAttention.apply: its gradient is the two kernels', and the
    gradient of the plain scan through autograd agrees."""
    from repro_torch.kernels.flash_attention import FlashAttention
    from repro_torch.models.attention import chunked_attention
    q, k, v, do = (torch.randn(1, 300, 4, 64, generator=gen, device="cuda")
                   for _ in range(4))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    reset_launches()
    FlashAttention.apply(*leaves, True).backward(do)
    torch.cuda.synchronize()
    n = launches()
    assert (n["flash_attention_lse"], n["flash_attention_bwd_dq"],
            n["flash_attention_bwd_dkdv"], n["flash_attention"]) == (1, 1, 1,
                                                                     0)
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    chunked_attention(*plain, causal=True, chunk=300).backward(do)
    for name, a, b in zip("qkv", leaves, plain):
        _within(a.grad, b.grad, f"d{name}")


def test_reduced_train_step_kernel_route_against_plain(gen):
    """yi-6b cut to 3 layers, remat "full": the loss and every gradient
    leaf of the kernel route within tolerance of the plain route's on the
    same weights; the lse forward twice a layer (step and recompute), each
    backward kernel once a layer, and no other kernel."""
    from repro_torch.configs import ARCHS
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.kernels.library import SIGNATURES
    from repro_torch.models import init_params
    from repro_torch.models.model import _leaves
    from repro_torch.runtime.steps import loss_and_grads
    cfg = ARCHS["yi-6b"].reduced(n_layers=3)
    params = init_params(gen, cfg)
    b = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=256,
                                 global_batch=2)).batch_at(0)
    toks, labs = (torch.from_numpy(b[k]).cuda() for k in ("tokens", "labels"))
    reset_launches()
    lk, gk = loss_and_grads(params, cfg, toks, labs, remat="full")
    torch.cuda.synchronize()
    L = cfg.n_layers
    assert launches() == dict.fromkeys(SIGNATURES, 0) | {
        "flash_attention_lse": 2 * L, "flash_attention_bwd_dq": L,
        "flash_attention_bwd_dkdv": L}
    lp, gp = loss_and_grads(params, cfg, toks, labs, remat="full",
                            use_kernels=False)
    _within(lk, lp, "loss")
    for (name, g), (_, w) in zip(_leaves(gk), _leaves(gp)):
        _within(g, w, name)


@pytest.mark.parametrize("bfp8", [False, True])
def test_checkpoint_resume_on_the_card(gen, tmp_path, bfp8):
    """Four steps uninterrupted against two, a save, a restore into a fresh
    loop and two more: bit for bit with raw checkpoints.  With BFP8 ones
    the restore is within the reference's bound (2% of each float leaf's
    max), and steps 3-4 finite: int8 AdamW turns a small change of a state
    into an unbounded update where a row's int8 v rounds to 0, so they are
    not held to the uninterrupted run."""
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.configs import ARCHS
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.models import init_params
    from repro_torch.models.model import _leaves
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.runtime.fault import FaultConfig, FaultTolerantLoop
    from repro_torch.runtime.steps import make_train_step
    cfg = ARCHS["yi-6b"].reduced()
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4,
                          quantize_states=True)
    step = make_train_step(cfg, opt_cfg, microbatches=2, device="cuda")
    data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=128,
                                    global_batch=2))

    def run(state, b):
        p, o = state
        p, o, _ = step(p, o, b)
        return (p, o)

    def fresh():
        p = init_params(torch.Generator(device="cuda").manual_seed(1), cfg)
        return (p, init_opt_state(p, opt_cfg))

    whole = FaultTolerantLoop(run, CheckpointStore(str(tmp_path / "a")),
                              FaultConfig(checkpoint_every=50)).run(
        fresh(), data.batch_at, start_step=0, num_steps=4)
    store = CheckpointStore(str(tmp_path / "b"), bfp8=bfp8)
    saved = FaultTolerantLoop(run, store, FaultConfig(checkpoint_every=2)).run(
        fresh(), data.batch_at, start_step=0, num_steps=2)
    loop = FaultTolerantLoop(run, store, FaultConfig(checkpoint_every=50))
    state, start = loop.try_restore(fresh())
    assert start == 2
    for (name, a), (_, b) in zip(_leaves({"p": saved[0], "o": saved[1]}),
                                 _leaves({"p": state[0], "o": state[1]})):
        assert a.dtype == b.dtype, name
        if bfp8 and a.is_floating_point():
            assert float((a - b).abs().max()) < 0.02 * float(
                a.abs().max()), name
        else:
            assert torch.equal(a, b), name
    resumed = loop.run(state, data.batch_at, start_step=2, num_steps=2)
    for (name, a), (_, b) in zip(_leaves({"p": whole[0], "o": whole[1]}),
                                 _leaves({"p": resumed[0],
                                          "o": resumed[1]})):
        assert a.dtype == b.dtype, name
        if not bfp8:
            assert torch.equal(a, b), name
        elif a.is_floating_point():
            assert bool(b.isfinite().all()), name


# =============================================================================
# the bf16 instances of the attention kernels, and the staged LM executor
# =============================================================================

def _within_one_bf16_ulp(got, want, slack):
    """Every bf16 element within one ulp of the plain value plus twice its
    f32 sums' slack (``slack``, one per bf16 output in order:
    testing.ulp.f32_slack); f32 outputs (lse, delta) within 2e-4 x max(1,
    max|plain|)."""
    from repro_torch.testing.ulp import past_one_ulp
    slack = iter(slack)
    for g, w in zip(got, want):
        if w.dtype == torch.bfloat16:
            assert past_one_ulp(g, w, next(slack)) == 0
        else:
            err = (g.double() - w.double()).abs()
            top = max(1.0, float(w.double().abs().max()))
            assert float(err.max()) <= 2e-4 * top


@pytest.mark.parametrize("B,S,H,D", [(1, 64, 2, 16), (2, 300, 2, 64),
                                     (1, 77, 4, 128), (2, 130, 2, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_instances_within_one_ulp(gen, B, S, H, D, causal):
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models.attention import chunked_attention
    from repro_torch.testing.ulp import f32_slack
    q, k, v, do = (torch.randn(B, S, H, D, generator=gen,
                               device="cuda").bfloat16() for _ in range(4))
    plain = chunked_attention(q, k, v, causal=causal, chunk=min(1024, S),
                              skip_masked=causal, return_lse=True)
    sl = f32_slack(q, k, v, causal, do)
    reset_launches()
    _within_one_bf16_ulp((FA.flash_attention(q, k, v, causal=causal),),
                         plain[:1], (sl["o"],))
    # o, lse and o in f32 (within 2e-4 x max(1, max|plain|), as lse)
    got = FA.flash_attention_lse(q, k, v, causal=causal)
    _within_one_bf16_ulp(got, plain, (sl["o"],))
    _, lse, o = plain
    dq = FA.flash_attention_bwd_dq(q, k, v, o, do, lse, causal)
    pdq = FA.flash_attention_bwd_dq_plain(q, k, v, o, do, lse, causal)
    _within_one_bf16_ulp(dq, pdq, (sl["dq"],))
    dkdv = FA.flash_attention_bwd_dkdv(q, k, v, do, lse, pdq[1], causal)
    _within_one_bf16_ulp(dkdv, FA.flash_attention_bwd_dkdv_plain(
        q, k, v, do, lse, pdq[1], causal), (sl["dk"], sl["dv"]))
    n = launches()
    assert all(n[f"{k}_bf16"] == 1 for k in (
        "flash_attention", "flash_attention_lse", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkdv"))
    assert torch.equal(FA.flash_attention(q, k, v, causal=causal).view(
        torch.int16), FA.flash_attention(q, k, v, causal=causal).view(
        torch.int16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_staged_executor_is_the_monolithic_forward(gen, dtype):
    """Reduced yi-6b staged over 4 stages with the codec off: bit for bit
    the monolithic forward on the kernel route."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import forward, init_params, project_logits
    from repro_torch.runtime.reconfigure import StagedExecutor
    cfg = ARCHS["yi-6b"].reduced(n_layers=4)
    params = init_params(gen, cfg, dtype=dtype)
    toks = torch.randint(0, cfg.vocab, (2, 64), generator=gen,
                         device="cuda")
    with torch.no_grad():
        x, _, _ = forward(params, cfg, toks)
        want = project_logits(params, cfg, x)
    ex = StagedExecutor(cfg, params, n_stages=4, compress_boundary=False,
                        dtype=dtype)
    assert ex.host_params["embed"].device.type == "cpu"
    assert torch.equal(ex.forward_logits(toks), want)
    assert len(ex.timings) == 4
