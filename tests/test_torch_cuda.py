"""The port's CUDA kernels and executor on the card.

Every test here needs an NVIDIA GPU and the CUDA toolkit (the kernels are
built from ``src/repro_torch/csrc`` at first use); without a card they
skip.  Run them on the card with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import DSEConfig, build_unet_exec     # noqa: E402
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
    with pytest.raises(NotImplementedError):
        bfp8_quant(x)
    with pytest.raises(NotImplementedError):
        SC.conv2d(x, x)


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


def test_unported_kernel_raises_on_the_card(gen):
    """An un-fragmented conv needs the conv2d kernel, which is not ported:
    the card refuses rather than run its plain version."""
    import repro_torch
    c = repro_torch.compile(repro_torch.CompileSpec(
        model=build_unet_exec(positions=256, base=64, levels=3),
        device="zcu102", torch_device="cuda"))
    with pytest.raises(NotImplementedError, match="conv2d"):
        c.run(torch.randn(c.input_shape(), generator=gen, device="cuda"))
