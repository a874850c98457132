"""The port's kernel wrappers on the CPU, where each runs its plain
version, held against the reference package's Pallas kernels run as the
reference's own tests run them (``interpret=True``), and the BFP8 codec
held against exact float arithmetic.

Tolerances:
* act_relu and pool with k = 2 are exact (the same f32 operations);
* the global pool sums in another order: rtol = atol = 1e-6;
* streamed_matmul sums in another order than XLA's dot: rtol = atol =
  2e-4, the reference's own executor tolerance;
* the BFP8 codec: the port reads the exponent exactly from the float's
  bits and builds exact powers of two.  The reference takes
  ``ceil(log2(amax))`` and ``exp2`` in f32, and XLA:CPU's ``exp2`` is off
  by a few ulps even at integer arguments.  So dequantised values agree
  within rtol = 2e-6, exponents agree except for blocks whose amax lies
  within 2^-16 (relative) of a power of two, and a mantissa may move by
  one step where ``x / scale`` lies next to a rounding boundary.
"""
import math

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp                                     # noqa: E402
import torch                                                # noqa: E402

from repro.kernels import bfp8 as jbfp8                     # noqa: E402
from repro.kernels import ops as jops                       # noqa: E402
from repro.kernels import streaming_conv as JSC             # noqa: E402
from repro.kernels.streamed_matmul import \
    streamed_matmul_padded as j_smm_padded                  # noqa: E402

from repro_torch.kernels import ops as tops                 # noqa: E402
from repro_torch.kernels import ref as tref                 # noqa: E402
from repro_torch.kernels import streaming_conv as TSC       # noqa: E402
from repro_torch.kernels.bfp8 import (bfp8_dequant, bfp8_exponent,  # noqa: E402
                                      bfp8_quant, bfp8_quant_values,
                                      bfp8_scale)
from repro_torch.kernels.library import launches           # noqa: E402
from repro_torch.kernels.streamed_matmul import (           # noqa: E402
    smem_bytes, streamed_matmul, streamed_matmul_padded)

SHAPES = [(28, 24), (45, 40), (64, 64), (256, 96)]


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _near_pow2(amax):
    """Blocks whose amax lies within 2^-16 (relative) of a power of two."""
    a = np.where(amax > 0, amax, 1.0).astype(np.float64)
    return np.abs(a / np.exp2(np.round(np.log2(a))) - 1.0) < 2.0**-16


def _assert_payload_close(tman, texp, jman, jexp, y):
    """Port payload vs the reference's, within the codec tolerance above."""
    tman, texp = tman.numpy(), texp.numpy()
    jman, jexp = np.asarray(jman), np.asarray(jexp)
    m, cq = tman.shape
    yq = np.zeros((m, cq), np.float32)
    yq[:, :y.shape[1]] = y
    amax = np.abs(yq.reshape(m, cq // 32, 32)).max(-1)
    same = ~_near_pow2(amax)
    np.testing.assert_array_equal(texp[same], jexp[same])
    rows = np.repeat(same, 32, axis=1)
    dman = np.abs(tman.astype(np.int32) - jman.astype(np.int32))[rows]
    assert dman.max(initial=0) <= 1
    moved = (dman != 0).mean() if dman.size else 0.0
    assert moved <= 1e-3


# =============================================================================
# the plain versions against the reference's kernels
# =============================================================================

@pytest.mark.parametrize("m,c", SHAPES)
def test_act_relu_matches_reference(m, c):
    x = _rand(m * c, m, c)
    got = TSC.act_relu(_t(x))
    want = np.asarray(JSC.act_relu(jnp.asarray(x), interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m,c", SHAPES)
def test_act_relu_encode_matches_reference(m, c):
    x = _rand(m + c, m, c, scale=3.0)
    y, (man, exp) = TSC.act_relu(_t(x), encode=True)
    jy, (jman, jexp) = JSC.act_relu(jnp.asarray(x), encode=True,
                                    interpret=True)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    assert man.shape == (m, -(-c // 32) * 32) and exp.shape == (m, -(-c // 32))
    _assert_payload_close(man, exp, jman, jexp, y.numpy())


@pytest.mark.parametrize("m,c", SHAPES)
def test_pool_k2_matches_reference(m, c):
    x = _rand(7 * m + c, 2 * m, c)
    got = TSC.pool(_t(x), m)
    want = np.asarray(JSC.pool(jnp.asarray(x), m, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m,c", SHAPES)
def test_global_pool_matches_reference(m, c):
    x = _rand(11 * m + c, m, c)
    got = TSC.pool(_t(x), 1)
    want = np.asarray(JSC.pool(jnp.asarray(x), 1, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("rows,c", [(64, 32), (256, 96), (300, 64)])
def test_bfp8_dequant_matches_reference(rows, c):
    rng = np.random.default_rng(rows + c)
    man = rng.integers(-127, 128, (rows, c)).astype(np.int8)
    exp = rng.integers(-30, 31, (rows, c // 32)).astype(np.int8)
    got = bfp8_dequant(_t(man), _t(exp))
    want = np.asarray(jbfp8.bfp8_dequant(jnp.asarray(man), jnp.asarray(exp),
                                         rows=math.gcd(rows, 256),
                                         interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=0)


@pytest.mark.parametrize("K", [100, 256, 1536])
@pytest.mark.parametrize("static_fraction", [0.0, 0.5])
def test_streamed_matmul_padded_matches_reference(K, static_fraction):
    M, N = 77, 130
    x, w = _rand(K, M, K), _rand(K + 1, K, N, scale=K ** -0.5)
    got = streamed_matmul_padded(_t(x), _t(w),
                                 static_fraction=static_fraction)
    want = np.asarray(j_smm_padded(jnp.asarray(x), jnp.asarray(w),
                                   static_fraction=static_fraction,
                                   interpret=True))
    assert got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_streamed_matmul_refuses_unaligned_operands():
    x = torch.zeros(128, 256)
    with pytest.raises(ValueError):
        streamed_matmul(x, torch.zeros(100, 128), torch.zeros(156, 128))
    with pytest.raises(ValueError):
        streamed_matmul(torch.zeros(100, 256), torch.zeros(128, 128),
                        torch.zeros(128, 128))
    y = streamed_matmul(x, torch.ones(128, 128), torch.ones(128, 128))
    assert y.shape == (128, 128)
    assert smem_bytes() == 3 * (128 * 36 + 32 * 136) * 4


# =============================================================================
# the BFP8 codec is exact
# =============================================================================

def _edge_amax():
    """2^k (1 + j 2^-23) for j in -3..3 across the normal range and into
    the subnormals."""
    vals = []
    for k in range(-140, 40):
        for j in range(-3, 4):
            v = np.float32(math.ldexp(1.0 + j * 2.0**-23, k))
            if v > 0:
                vals.append(v)
    return np.array(vals, dtype=np.float32)


def _exact_ceil_log2(a: float) -> int:
    f, e = math.frexp(max(a, float(np.float32(1e-38))))
    return e - 1 if f == 0.5 else e


def test_exponent_is_exact_at_powers_of_two():
    amax = _edge_amax()
    got = bfp8_exponent(_t(amax)).numpy()
    want = [_exact_ceil_log2(float(a)) for a in amax]
    np.testing.assert_array_equal(got, want)
    assert bfp8_exponent(_t(np.zeros(3, np.float32))).tolist() == [0, 0, 0]


def test_scale_is_an_exact_power_of_two():
    e = np.arange(-128, 128, dtype=np.int32)
    got = bfp8_scale(_t(e)).numpy()
    want = np.array([math.ldexp(1.0, int(k) - 6) for k in e], np.float32)
    np.testing.assert_array_equal(got, want)


def test_quant_and_dequant_are_exact():
    """Mantissas are rint(x / 2^(exp-6)) with ties to even, clipped, and the
    dequantised values man * 2^(exp-6), in exact arithmetic."""
    amax = _edge_amax()
    x = _rand(5, amax.size, 32).clip(-1, 1) * amax[:, None] * 0.999
    x[:, 0] = amax
    x[1::3, 5] = amax[1::3] * (2.5 / 64)       # ties at power-of-two amax
    x[::4] = 0.0
    man, exp = bfp8_quant(_t(x))
    e = np.array([_exact_ceil_log2(float(a)) if a > 0 else 0
                  for a in np.abs(x).max(1)])
    np.testing.assert_array_equal(exp.numpy()[:, 0], e)
    q = np.clip(np.round(x.astype(np.float64) / np.ldexp(1.0, e - 6)[:, None]),
                -127, 127)
    np.testing.assert_array_equal(man.numpy(), q.astype(np.int8))
    back = bfp8_dequant(man, exp).numpy()
    want = (q * np.ldexp(1.0, e - 6)[:, None]).astype(np.float32)
    np.testing.assert_array_equal(back, want)


def test_quant_of_non_finite_blocks():
    """A block that holds a NaN or an infinity gets exponent 0, so scale
    2^-6; a NaN's mantissa is 0 and an infinity clips to +-127.  The CUDA
    encode is held to the same on the card (test_torch_cuda.py)."""
    x = np.full((4, 64), 0.01, np.float32)
    x[0, 3] = np.nan
    x[1, 40] = np.inf
    x[2, 9], x[2, 50] = np.nan, -np.inf
    man, exp = bfp8_quant(_t(x))
    e = _exact_ceil_log2(0.01)
    assert exp.tolist() == [[0, e], [e, 0], [0, 0], [e, e]]
    finite = {0: round(0.01 * 64), e: round(0.01 / math.ldexp(1.0, e - 6))}
    want = np.empty_like(x, dtype=np.int8)
    for r in range(4):
        for b in range(2):
            want[r, 32 * b:32 * b + 32] = finite[int(exp[r, b])]
    want[0, 3] = want[2, 9] = 0
    want[1, 40], want[2, 50] = 127, -127
    np.testing.assert_array_equal(man.numpy(), want)


def test_quant_matches_reference_away_from_powers_of_two():
    x = _rand(9, 256, 256, scale=5.0)
    man, exp = bfp8_quant_values(_t(x), block=32)
    jman, jexp = jbfp8.bfp8_quant(jnp.asarray(x), block=32, interpret=True)
    _assert_payload_close(man, exp, jman, jexp, x)


# =============================================================================
# dispatch on the CPU: plain versions, no launches
# =============================================================================

def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    before = launches()
    x = _t(_rand(3, 64, 48))
    y, (man, exp) = TSC.act_relu(x, encode=True)
    TSC.pool(x, 32)
    bfp8_dequant(man, exp)
    streamed_matmul_padded(x, _t(_rand(4, 48, 256)))
    w = _t(_rand(6, 48, 40))
    np.testing.assert_array_equal(TSC.conv2d(x, w).numpy(),
                                  tref.conv2d_ref(x, w).numpy())
    assert launches() == before


@pytest.mark.parametrize("kind", ["conv", "pool", "act", "dwconv"])
@pytest.mark.parametrize("variant", ["ingress", "egress", "both"])
def test_fused_plain_variants_match_reference(kind, variant):
    """The fused-codec variants on the CPU (the kernel route of the executor
    reaches them for graphs other than the main path) equal the
    reference's Pallas bodies up to the codec tolerance."""
    m, c, cout = 45, 40, 24
    x = _rand(len(kind) + len(variant), m, c, scale=2.0)
    jx, tx = jnp.asarray(x), _t(x)
    ingress, egress = variant in ("ingress", "both"), variant != "ingress"
    jpay = jbfp8.bfp8_quant_values(jnp.pad(jx, ((0, 0), (0, 64 - c))),
                                   block=32) if ingress else None
    tpay = bfp8_quant_values(torch.nn.functional.pad(tx, (0, 64 - c)),
                             block=32) if ingress else None
    if ingress:        # the same payload on both sides
        tpay = tuple(_t(np.asarray(a)) for a in jpay)
    w = _rand(7, c, cout) if kind == "conv" else _rand(8, 3, c)
    args = dict(payload=tpay, encode=egress)
    jargs = dict(payload=jpay, encode=egress, interpret=True)
    if kind == "conv":
        got = TSC.conv2d(None if ingress else tx, _t(w), **args)
        want = JSC.conv2d(None if ingress else jx, jnp.asarray(w), **jargs)
    elif kind == "dwconv":
        got = TSC.dwconv(None if ingress else tx, _t(w), **args)
        want = JSC.dwconv(None if ingress else jx, jnp.asarray(w), **jargs)
    elif kind == "pool":
        got = TSC.pool(None if ingress else tx, 15, c=c, **args)
        want = JSC.pool(None if ingress else jx, 15, c=c, **jargs)
    else:
        got = TSC.act_relu(None if ingress else tx, c=c, **args)
        want = JSC.act_relu(None if ingress else jx, c=c, **jargs)
    ty, jy = (got[0], want[0]) if egress else (got, want)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    if egress:
        _assert_payload_close(*got[1], *want[1], ty.numpy())


# =============================================================================
# the registry
# =============================================================================

def test_registry_mirrors_reference():
    assert tops.lowerable_kinds() == jops.lowerable_kinds()
    assert tops.fusable_kinds() == jops.fusable_kinds()
    body, is_kernel = tops.kernel_for("act", use_kernels=True)
    assert body is TSC.act_relu and is_kernel
    body, is_kernel = tops.kernel_for("act", use_kernels=False)
    assert body is tref.act_relu_ref and not is_kernel
    assert tops.kernel_for("concat", use_kernels=True)[1] is False
    assert tops.kernel_for("nope", use_kernels=True) == (None, False)
