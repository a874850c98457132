"""The numerics of the 3xTF32 split (``src/repro_torch/csrc/tf32x3.cuh``)
on the CPU.

``streamed_matmul``, ``flash_attention`` and ``conv2d`` run their
products on the tensor cores in TF32, whose operands keep 10 of f32's 23
mantissa bits.
Each f32 operand is split into ``hi + lo`` (``ref.tf32_split``) and a
product is taken as ``a_lo b_hi + a_hi b_lo + a_hi b_hi``.  Here that
product is emulated in the kernels' order (per slice of 8 along K, the
three terms one after the other into one f32 accumulator; each TF32
product is exact in f32) and held to the plain f32 product, and to the
reference package's, within rtol = atol = 2e-4 (``MATMUL_TOL`` and
``FLASH_TOL`` of ``chip_smoke.py``), at the UNet's launch shapes cut to
2048 rows, at the attention's two products at S = 512, D = 128, at the
four further products its backward kernels take there (dO v^T over D; dS
k, P^T dO and dS^T q^ over S, with P and dS made as the plain backward
makes them), and at conv2d's launch shapes cut to 2048 rows (K from 3 to
384, N from 24 to 128, one A operand decoded from its BFP8 payload),
where the split holds that bound too.  One TF32 product, ``a_hi b_hi``
alone, breaks that bound at every one of those shapes, which is why the
split exists.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                     # noqa: E402

from repro.kernels import ref as jref                       # noqa: E402

from repro_torch.kernels import ref                         # noqa: E402

TOL = 2e-4
ROWS = 2048


def _slices(a, b, terms):
    """sum over K slices of 8, in order, of each term's product into one
    f32 accumulator: ``terms`` maps (a_hi, a_lo), (b_hi, b_lo) to the
    operand pairs of each product, in the order they are issued."""
    ah, al = ref.tf32_split(a)
    bh, bl = ref.tf32_split(b)
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k0 in range(0, a.shape[1], 8):
        ks = slice(k0, k0 + 8)
        for x, y in terms((ah[:, ks], al[:, ks]), (bh[ks], bl[ks])):
            acc = acc + x @ y
    return acc


def tf32x3_matmul(a, b):
    return _slices(a, b, lambda A, B: ((A[1], B[0]), (A[0], B[1]),
                                       (A[0], B[0])))


def tf32_matmul(a, b):
    return _slices(a, b, lambda A, B: ((A[0], B[0]),))


# K x N of the UNet's streamed_matmul launches (M cut to ROWS)
UNET = [(256, 512), (512, 1024), (1024, 512), (512, 256), (256, 128)]


def _unet(K, N):
    rng = np.random.default_rng(K + N)
    x = rng.standard_normal((ROWS, K), dtype=np.float32)
    w = rng.standard_normal((K, N), dtype=np.float32) / np.float32(K ** 0.5)
    ks = K // 2
    want_j = np.asarray(jref.streamed_matmul_ref(
        jnp.asarray(x), jnp.asarray(w[:ks]), jnp.asarray(w[ks:])))
    return torch.from_numpy(x), torch.from_numpy(w), want_j


def _attention(product):
    """The attention's products at S = 512, D = 128: scores (q D^-1/2) k^T
    over D, or causal softmax probabilities times v over S; and its
    backward's, from the same q, k, v and a seeded dO, with P = exp(s -
    lse) and dS = P (dP - rowsum(dO O)) as the plain backward makes them:
    dO v^T over D ("dov"), dS k ("dsk"), P^T dO ("pdo") and dS^T (q
    D^-1/2) ("dsq") over S."""
    S, D = 512, 128
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((S, D), dtype=np.float32)
               for _ in range(3))
    q = q * np.float32(D ** -0.5)
    s = np.where(np.tril(np.ones((S, S), bool)), q @ k.T,
                 np.float32(-2.0 ** 30))
    if product == "qk":
        a, b = q, np.ascontiguousarray(k.T)
    elif product == "pv":
        a = np.exp(s - s.max(1, keepdims=True))
        a = a / a.sum(1, keepdims=True)
        b = v
    else:
        do = rng.standard_normal((S, D), dtype=np.float32)
        m = s.max(1, keepdims=True)
        p = np.exp(s - (m + np.log(np.exp(s - m).sum(1, keepdims=True))))
        ds = p * (do @ v.T - (do * (p @ v)).sum(1, keepdims=True))
        a, b = {"dov": (do, v.T), "dsk": (ds, k), "pdo": (p.T, do),
                "dsq": (ds.T, q)}[product]
        a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    want_j = np.asarray(jnp.dot(jnp.asarray(a), jnp.asarray(b)))
    return torch.from_numpy(a), torch.from_numpy(b), want_j


# K x N of conv2d's launches (M cut to ROWS): X3D-M's stem (K < 8, one
# slice of 8 mostly zeros), the YOLO head, the 3-stage plan's conv_12,
# X3D-M's classifier head, and an N that is no multiple of the 32-column
# tile; "dec": x is the decode of its BFP8 payload (48 channels, 16 of
# padding), as the decoding variants read it
CONV = [(3, 24), (64, 64), (384, 128), (216, 32), (96, 48)]


def _conv(K, N, decoded=False):
    rng = np.random.default_rng(1000 + K + N + decoded)
    x = rng.standard_normal((ROWS, K), dtype=np.float32)
    w = rng.standard_normal((K, N), dtype=np.float32) / np.float32(K ** 0.5)
    if not decoded:
        want_j = np.asarray(jref.conv2d_ref(jnp.asarray(x), jnp.asarray(w)))
        return torch.from_numpy(x), torch.from_numpy(w), want_j
    xp = np.pad(x * np.float32(2), ((0, 0), (0, (-K) % 32)))
    man, exp = jref.bfp8_quant_ref(jnp.asarray(xp))
    xd_j = jref.bfp8_dequant_ref(man, exp)[:, :K]
    xd = ref.bfp8_dequant_ref(torch.from_numpy(np.array(man)),
                              torch.from_numpy(np.array(exp)))[:, :K]
    assert np.array_equal(xd.numpy(), np.asarray(xd_j))
    want_j = np.asarray(jref.conv2d_ref(xd_j, jnp.asarray(w)))
    return xd.contiguous(), torch.from_numpy(w), want_j


CASES = ([pytest.param(("unet", K, N), id=f"unet-K{K}-N{N}")
          for K, N in UNET]
         + [pytest.param(("attn", p), id=f"attn-{p}-S512-D128")
            for p in ("qk", "pv", "dov", "dsk", "pdo", "dsq")]
         + [pytest.param(("conv", K, N), id=f"conv-K{K}-N{N}")
            for K, N in CONV]
         + [pytest.param(("conv-dec", 48, 96), id="conv-dec-K48-N96")])


def _operands(case):
    if case[0] == "unet":
        return _unet(*case[1:])
    if case[0] == "attn":
        return _attention(case[1])
    return _conv(*case[1:], decoded=case[0] == "conv-dec")


@pytest.mark.parametrize("case", CASES)
def test_split_product_holds_f32_parity(case):
    a, b, want_j = _operands(case)
    got = tf32x3_matmul(a, b)
    torch.testing.assert_close(got, a @ b, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), want_j, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", CASES)
def test_one_tf32_product_breaks_the_bound(case):
    """Every case, the backward's four products included: each sums 128
    (dO v^T) to 512 (dS k, P^T dO, dS^T q^) terms whose TF32 roundings
    (2^-11 of each operand) add up to 1e-3 to 2e-2, above 2e-4 of outputs
    as large as 3 to 56."""
    a, b, _ = _operands(case)
    want = a @ b
    err = (tf32_matmul(a, b) - want).abs()
    assert bool((err > TOL + TOL * want.abs()).any()), float(err.max())


def test_tf32_split_rounds_to_nearest_ties_away():
    one_ulp = 2.0 ** -10                        # TF32's ulp at 1
    x = torch.tensor([1.0 + one_ulp / 2,         # a tie: away from zero
                      -(1.0 + one_ulp / 2),
                      1.0 + one_ulp / 2 - 2.0 ** -23,   # below the tie: down
                      1.0 + 3 * one_ulp / 2,     # a tie between odd and even
                      3.0, 0.0, -0.0])
    hi, lo = ref.tf32_split(x)
    want = torch.tensor([1.0 + one_ulp, -(1.0 + one_ulp), 1.0,
                         1.0 + 2 * one_ulp, 3.0, 0.0, -0.0])
    assert torch.equal(hi.view(torch.int32), want.view(torch.int32))
    # hi + lo leaves at most 2^-22 |x| behind, and x - hi is exact
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(100_000, dtype=np.float32)
                         * np.float32(1e3) ** rng.uniform(-1, 1, 100_000)
                         .astype(np.float32))
    hi, lo = ref.tf32_split(x)
    for part in (hi, lo):
        assert bool(((part.view(torch.int32) & 0x1FFF) == 0).all())
    assert torch.equal((x - hi).double(), x.double() - hi.double())
    assert bool((hi.double() + lo.double() - x.double()).abs().le(
        2.0 ** -22 * x.double().abs()).all())
