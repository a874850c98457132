"""The port's ``flash_attention`` on the CPU against the reference package's
Pallas kernel (interpret mode) and its oracle.

On a CPU tensor the port's wrapper runs its plain version,
``models.attention.chunked_attention`` with causal block skipping; the
port's ``flash_attention_ref`` is plain softmax attention.  Both are held
to the Pallas kernel and to ``repro.kernels.ref.flash_attention_ref``
within rtol = atol = 2e-4, the reference's own tolerance for its kernel
(``tests/test_kernels.py``): the online softmax sums in another order than
the plain softmax.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                     # noqa: E402

from repro.kernels import ref as jref                       # noqa: E402
from repro.models import attention as JA                    # noqa: E402
from repro.kernels.flash_attention import (                 # noqa: E402
    flash_attention as jflash)

from repro_torch.kernels import ops, ref                    # noqa: E402
from repro_torch.kernels.flash_attention import (           # noqa: E402
    flash_attention)

TOL = 2e-4


def _qkv(shape, seed, kv_heads=None):
    """q, k, v from a seeded numpy generator; with ``kv_heads`` the k and v
    heads are that many, repeated to H (the GQA layout the prefill gives
    the kernel)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(shape, dtype=np.float32)
    B, S, H, D = shape
    kh = kv_heads or H
    k, v = (np.repeat(rng.standard_normal((B, S, kh, D), dtype=np.float32),
                      H // kh, axis=2) for _ in range(2))
    return q, k, v


CASES = [((2, 256, 2, 64), None), ((2, 512, 4, 128), None),
         ((1, 256, 8, 32), 2)]


@pytest.mark.parametrize("shape,kv_heads", CASES,
                         ids=["S256H2D64", "S512H4D128", "gqa-S256H8KV2D32"])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_routes_match_the_pallas_kernel(shape, kv_heads, causal):
    q, k, v = _qkv(shape, 3, kv_heads)
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, bq=128, bk=128, interpret=True))
    jplain = np.asarray(jref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for got in (flash_attention(tq, tk, tv, causal=causal),
                ops.flash_attn(tq, tk, tv, causal=causal),
                ref.flash_attention_ref(tq, tk, tv, causal=causal)):
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got.numpy(), jplain, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("S", [1, 63, 300])
def test_any_length_on_the_plain_route(S):
    """The port takes S that no Pallas block divides: its plain route
    against the plain softmax, causal and not."""
    q, k, v = map(torch.from_numpy, _qkv((1, S, 2, 16), S))
    for causal in (True, False):
        torch.testing.assert_close(
            flash_attention(q, k, v, causal=causal),
            ref.flash_attention_ref(q, k, v, causal=causal),
            rtol=TOL, atol=TOL)


def test_wrapper_refuses_mismatched_shapes():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError):
        flash_attention(q, q[:, :4], q)


@pytest.mark.parametrize("Sq", [1, 64])
@pytest.mark.parametrize("Sk", [1, 37, 1499])
def test_keys_of_their_own_length_on_the_plain_route(Sq, Sk):
    """Non-causal attention over Sk keys (the cross attention's, Sq = 1 in
    a decode step) against the reference's plain softmax and its
    chunked_attention, the oracle of its kernel."""
    rng = np.random.default_rng(Sq * Sk)
    q = rng.standard_normal((2, Sq, 2, 64), dtype=np.float32)
    k, v = (rng.standard_normal((2, Sk, 2, 64), dtype=np.float32)
            for _ in range(2))
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=False)
    assert got.shape == (2, Sq, 2, 64)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    for want in (jref.flash_attention_ref(jq, jk, jv, causal=False),
                 JA.chunked_attention(jq, jk, jv, causal=False,
                                      chunk=min(512, Sk))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)


def test_causal_keys_of_their_own_length_are_refused():
    """A causal call's keys are the queries' positions: Sk != Sq is
    refused, as are k and v of different lengths and zero keys."""
    q, k = torch.zeros(1, 8, 2, 16), torch.zeros(1, 5, 2, 16)
    with pytest.raises(ValueError, match="one \\(B, S, H, D\\)"):
        flash_attention(q, k, k, causal=True)
    with pytest.raises(ValueError):
        flash_attention(q, k, q, causal=False)
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :0], k[:, :0], causal=False)
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(1, 5, 3, 16), torch.zeros(1, 5, 3, 16),
                        causal=False)
