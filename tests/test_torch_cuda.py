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


def _payload(m, c):
    cq = -(-c // 32) * 32
    return (torch.zeros(m, cq, dtype=torch.int8, device="cuda"),
            torch.zeros(m, cq // 32, dtype=torch.int8, device="cuda"))


@pytest.mark.parametrize("variant", ["conv2d ingress", "conv2d egress",
                                     "dwconv ingress", "dwconv egress",
                                     "pool ingress", "act_relu ingress"])
def test_unported_kernel_raises_on_the_card(gen, variant):
    """The fused codec variants no plan of the main path reaches have no
    kernel: the card refuses rather than run their plain versions."""
    x = torch.randn(64, 40, generator=gen, device="cuda")
    op, kind = variant.split()
    kw = (dict(payload=_payload(64, 40)) if kind == "ingress"
          else dict(encode=True))
    xin = None if kind == "ingress" else x
    with pytest.raises(NotImplementedError, match=op):
        if op == "conv2d":
            SC.conv2d(xin, x[:40, :24].contiguous(), **kw)
        elif op == "dwconv":
            SC.dwconv(xin, x[:3].contiguous(), **kw)
        elif op == "pool":
            SC.pool(xin, 32, c=40, **kw)
        else:
            SC.act_relu(xin, c=40, **kw)
