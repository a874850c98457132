"""The standalone BFP8 codec's stripe forms on the CPU, and ``dwconv`` over
more taps than the card's window kernel is built for.

``bfp8_quant(x, width=W)`` quantises an (R, c) stripe into a W-wide payload
and ``bfp8_dequant(man, exp, c=c)`` decodes the c channels it carries, so
the executor's spill halves make no padded or cut copy.  Here the plain
versions (which the CUDA kernels are held to bit for bit on the card,
``tests/test_torch_cuda.py``) are held:

* bit for bit to the composition they replace, pad with zeros then
  quantise, dequantise then cut, and so are ``bfp8_spill_encode`` /
  ``bfp8_spill_decode`` on both routes;
* to the reference package's Pallas codec in interpret mode on the padded
  stripe, within its tolerance (``test_torch_kernels.py`` says why the
  reference's codec is inexact: exponents equal away from powers of two, a
  mantissa off by at most one step, decoded values within rtol 2e-6).

The port's plain ``dwconv`` at 9 and 11 taps, all four codec variants, is
held to the reference's Pallas ``dwconv`` in interpret mode within rtol =
atol = 1e-5, the tolerance ``test_torch_pool_dwconv.py`` holds 3 taps to.
"""
import math

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp                                     # noqa: E402
import torch                                                # noqa: E402

from repro.kernels import bfp8 as jbfp8                     # noqa: E402
from repro.kernels import streaming_conv as JSC             # noqa: E402

from repro_torch.kernels import ref as tref                 # noqa: E402
from repro_torch.kernels import streaming_conv as TSC       # noqa: E402
from repro_torch.kernels.bfp8 import (bfp8_dequant,         # noqa: E402
                                      bfp8_dequant_values, bfp8_quant,
                                      bfp8_quant_values)
from repro_torch.runtime import executor as tex             # noqa: E402

from test_torch_kernels import _assert_payload_close        # noqa: E402
from test_torch_pool_dwconv import _hold, _inputs           # noqa: E402

WIDTHS = (1, 3, 24, 40, 48, 64, 96)
ROWS = (1, 5, 77)


def _stripe(seed, r, c):
    """A seeded (r, c) stripe with a zero block, a subnormal row, NaN and
    +-inf in some rows."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(r, c)) * 3).astype(np.float32)
    x[::4] *= np.float32(2.0 ** -130)
    if r > 1:
        x[1, : min(c, 32)] = 0.0
    if r > 2:
        x[2, c // 2] = np.nan
    if r > 3:
        x[3, c - 1], x[3, 0] = np.inf, -np.inf
    return x


def _padded(x, width):
    return torch.nn.functional.pad(x, (0, width - x.shape[1]))


def _width(c):
    return 32 * -(-c // 32)


@pytest.mark.parametrize("r", ROWS)
@pytest.mark.parametrize("c", WIDTHS)
def test_stripe_forms_equal_pad_then_quantise_and_dequantise_then_cut(r, c):
    """Both forms, and the wrappers' CPU route, at widths w and w + 32 (a
    whole block of padding quantises as zeros with exponent 0)."""
    x = torch.from_numpy(_stripe(r * 100 + c, r, c))
    for width in (_width(c), _width(c) + 32):
        want = bfp8_quant_values(_padded(x, width), block=32)
        for got in (bfp8_quant_values(x, block=32, width=width),
                    bfp8_quant(x, width=width),
                    tref.bfp8_quant_ref(x, width=width)):
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
        man, exp = want
        full = bfp8_dequant_values(man, exp, block=32)
        cut = full[:, :c].contiguous()
        for got in (bfp8_dequant_values(man, exp, block=32, c=c),
                    bfp8_dequant(man, exp, c=c),
                    tref.bfp8_dequant_ref(man, exp, c=c)):
            assert got.shape == (r, c) and got.is_contiguous()
            assert torch.equal(got.view(torch.int32), cut.view(torch.int32))
        assert torch.equal(bfp8_dequant(man, exp).view(torch.int32),
                           full.view(torch.int32))


@pytest.mark.parametrize("r", ROWS)
@pytest.mark.parametrize("c", WIDTHS)
def test_stripe_forms_match_the_reference_codec(r, c):
    """The reference quantises and dequantises the padded stripe (it takes
    no width); the port's stripe forms agree within its tolerance."""
    rng = np.random.default_rng(r * 31 + c)
    x = (rng.normal(size=(r, c)) * 3).astype(np.float32)
    x[::3, : min(c, 32)] = 0.0      # blocks of zeros, exponent 0
    w = _width(c)
    jx = jnp.pad(jnp.asarray(x), ((0, 0), (0, w - c)))
    jman, jexp = jbfp8.bfp8_quant(jx, block=32, rows=math.gcd(r, 256),
                                  interpret=True)
    man, exp = bfp8_quant(torch.from_numpy(x), width=w)
    _assert_payload_close(man, exp, jman, jexp, x)
    back = bfp8_dequant(man, exp, c=c)
    jback = np.asarray(jbfp8.bfp8_dequant(
        jnp.asarray(man.numpy()), jnp.asarray(exp.numpy()),
        rows=math.gcd(r, 256), interpret=True))[:, :c]
    np.testing.assert_allclose(back.numpy(), jback, rtol=2e-6, atol=0)


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("c", WIDTHS)
def test_spill_halves_give_the_padded_payloads(c, use_kernels):
    """``bfp8_spill_encode`` / ``bfp8_spill_decode`` on the CPU: the
    payload of the stripe padded to the block with zeros, and its decode
    cut to c, as the executor built them with ``F.pad`` and a cut copy."""
    x = torch.from_numpy(_stripe(c, 77, c))
    man, exp = tex.bfp8_spill_encode(x, use_kernels=use_kernels)
    wman, wexp = tref.bfp8_quant_ref(_padded(x, _width(c)))
    assert torch.equal(man, wman) and torch.equal(exp, wexp)
    y = tex.bfp8_spill_decode((man, exp), c, use_kernels=use_kernels)
    want = tref.bfp8_dequant_ref(man, exp)[:, :c].contiguous()
    assert y.shape == (77, c)
    assert torch.equal(y.view(torch.int32), want.view(torch.int32))
    assert torch.equal(
        tex._bfp8_roundtrip(x, use_kernels=use_kernels).view(torch.int32),
        want.view(torch.int32))


def test_codec_refuses_widths_that_do_not_carry_the_stripe():
    x = torch.zeros(4, 40)
    with pytest.raises(ValueError):
        bfp8_quant(x)                       # c % 32 != 0 without a width
    with pytest.raises(ValueError):
        bfp8_quant(x, width=32)             # narrower than c
    with pytest.raises(ValueError):
        bfp8_quant(x, width=48)             # not whole blocks
    man, exp = bfp8_quant(x, width=64)
    with pytest.raises(ValueError):
        bfp8_dequant(man, exp, c=65)


@pytest.mark.parametrize("taps", [9, 11])
@pytest.mark.parametrize("c", [24, 40])
@pytest.mark.parametrize("variant", ["", "_encode", "_decode",
                                     "_decode_encode"])
def test_dwconv_over_many_taps_matches_pallas(variant, c, taps):
    """The halo of 4 and 5 rows at both ends of 61 rows."""
    dec, enc = "_decode" in variant, variant.endswith("_encode")
    (tx, tpay), (jx, jpay) = _inputs(3 * c + taps + len(variant), 61, c, dec)
    w = np.random.default_rng(c + taps).normal(size=(taps, c)).astype(
        np.float32)
    got = TSC.dwconv(tx, torch.from_numpy(w), payload=tpay, encode=enc)
    want = JSC.dwconv(jx, jnp.asarray(w), payload=jpay, encode=enc,
                      interpret=True)
    _hold(got, want, enc)
