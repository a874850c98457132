"""``pool`` and ``dwconv``, each with its three BFP8 codec variants, on the
CPU: the plain versions the CUDA kernels are held to on the card, against
the reference package's Pallas kernels run in interpret mode, at the
channel widths the paths launch them with (X3D-M's 24-192 and their
expansions to 384, the YOLO head's 64-128); and the pool's scratch, walked
over every block of its one-launch layout.

Tolerances: y within rtol = atol = 1e-5 (the reference's mean and tap sum
may round in another order, and its BFP8 decode is off by a few ulps, see
test_torch_kernels.py), a plain pool over 2 rows bit for bit (the same two
f32 operations); a payload within the reference codec's tolerance
(test_torch_x3d._payload_close).
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp                                     # noqa: E402
import torch                                                # noqa: E402

from repro.kernels import bfp8 as jbfp8                     # noqa: E402
from repro.kernels import streaming_conv as JSC             # noqa: E402

from repro_torch.kernels import streaming_conv as TSC       # noqa: E402

from test_torch_x3d import _payload_close                   # noqa: E402

WIDTHS = (24, 48, 64, 96, 128, 192, 384)
VARIANTS = ("", "_encode", "_decode", "_decode_encode")


def _inputs(seed, m, c, dec):
    """(port input, reference input): x on both sides, or with the decode
    one payload of x with random bytes in its padding channels."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(m, c)) * 2).astype(np.float32)
    if not dec:
        return (torch.from_numpy(x), None), (jnp.asarray(x), None)
    cq = -(-c // 32) * 32
    man, exp = (np.array(a) for a in jbfp8.bfp8_quant_values(
        jnp.pad(jnp.asarray(x), ((0, 0), (0, cq - c))), block=32))
    man[:, c:] = rng.integers(-127, 128, (m, cq - c))
    return ((None, (torch.from_numpy(man), torch.from_numpy(exp))),
            (None, (jnp.asarray(man), jnp.asarray(exp))))


def _hold(got, want, enc, exact=False):
    ty, jy = (got[0], want[0]) if enc else (got, want)
    if exact:
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    else:
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-5)
    if enc:
        _payload_close(*got[1], *want[1], ty.numpy())


@pytest.mark.parametrize("k", [2, "rows"])
@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_pool_variant_plain_version_matches_pallas(variant, c, k):
    """A 2:1 stage pool (64 rows to 32) and a global pool (63 rows to 1)."""
    dec, enc = "_decode" in variant, variant.endswith("_encode")
    m, m_out = (64, 32) if k == 2 else (63, 1)
    (tx, tpay), (jx, jpay) = _inputs(c + m_out + len(variant), m, c, dec)
    got = TSC.pool(tx, m_out, c=c, payload=tpay, encode=enc)
    want = JSC.pool(jx, m_out, c=c, payload=jpay, encode=enc, interpret=True)
    _hold(got, want, enc, exact=k == 2 and not dec)


@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_dwconv_variant_plain_version_matches_pallas(variant, c):
    """Three temporal taps over 61 rows, 'same' padding at both ends."""
    dec, enc = "_decode" in variant, variant.endswith("_encode")
    (tx, tpay), (jx, jpay) = _inputs(2 * c + len(variant), 61, c, dec)
    w = np.random.default_rng(c).normal(size=(3, c)).astype(np.float32)
    got = TSC.dwconv(tx, torch.from_numpy(w), payload=tpay, encode=enc)
    want = JSC.dwconv(jx, jnp.asarray(w), payload=jpay, encode=enc,
                      interpret=True)
    _hold(got, want, enc)


@pytest.mark.parametrize("c", [3, 24, 48, 384])
@pytest.mark.parametrize("k", [2, 8, 9, 256, 257, 65536, 65537, 262144])
def test_pool_scratch_covers_every_block(k, c):
    """Walk the blocks of the pool's launch at k > POOL_SERIAL_MAX_K from
    its layout: the chunks cover the k rows once, the tiles the c channels
    in whole codec blocks, every block's partial sums fill the
    ``pool_scratch_size`` words once, and every (output row, tile) has a
    counter of its own among ``pool_counters``."""
    m_out = 3
    size = TSC.pool_scratch_size(m_out, k, c)
    counters = TSC.pool_counters(m_out, k, c)
    if k <= TSC.POOL_SERIAL_MAX_K:
        assert size == counters == 0
        return
    tiles, tq, lanes, chunk, chunks = TSC.pool_layout(k, c)
    q4 = -(-c // 4)
    assert tq <= TSC.POOL_TILE_QUADS and lanes * tq <= TSC.POOL_THREADS
    assert tiles * tq >= q4 > (tiles - 1) * tq
    assert tiles == 1 or tq % 8 == 0
    assert chunk == lanes * TSC.POOL_LANE_ROWS
    starts = np.arange(chunks) * chunk
    rows = np.minimum(k, starts + chunk) - starts
    assert (rows > 0).all() and rows.sum() == k
    if chunks == 1:                 # one block an output row: no partials
        assert size == counters == 0
        return
    # block (o, j, t) writes channels 4 q .. 4 q + 3 below c of its tile's
    # quads q, at partial (o, j), and counts on counter (o, t)
    o, j, t = np.meshgrid(np.arange(m_out), np.arange(chunks),
                          np.arange(tiles), indexing="ij")
    q = t.ravel()[:, None] * tq + np.arange(tq)[None, :]
    ch = (4 * q[:, :, None] + np.arange(4)).reshape(q.shape[0], -1)
    at = (o * chunks + j).ravel()[:, None] * c + ch
    written = np.sort(at[ch < c])
    np.testing.assert_array_equal(written, np.arange(size))
    count = np.unique((o * tiles + t).ravel())
    np.testing.assert_array_equal(count, np.arange(counters))
