"""Lossless and calibrated-lossy codecs for off-chip streams (paper §III-A/V-C).

SMOF encodes evicted activations and fragmented weights before they cross the
off-chip boundary, to stretch the DDR bandwidth budget.  The paper supports
Run-Length Encoding and Huffman coding "applied to each data word
independently"; weights have a compile-time-known ratio ``c`` while
activations use a calibration-estimated average ``c_bar`` (with the runtime
variability studied in Fig. 8).

We implement, bit-exactly and with real encode/decode round-trips:

* **RLE** over equal consecutive words — effective on post-ReLU zero runs;
* **Huffman** with canonical codes built from a calibration histogram;
* **BFP8** block-floating-point (shared exponent + int8 mantissas per block)
  — the paper's own §V-A quantisation format, reused here as the TPU-native
  eviction codec (fixed, compile-time-known 8.25 bits/word at block 32).

Ratios are reported as ``encoded_bits / raw_bits`` (smaller is better), the
``c`` / ``c_bar`` of Eq. 2 and Eq. 4.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq

import numpy as np

# =============================================================================
# RLE
# =============================================================================

def rle_encode(words: np.ndarray, max_run: int = 256) -> tuple[np.ndarray, np.ndarray]:
    """Encode a 1-D integer word stream into (values, run_lengths)."""
    w = np.asarray(words).ravel()
    if w.size == 0:
        return w[:0], w[:0].astype(np.int64)
    change = np.flatnonzero(np.diff(w)) + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [w.size]])
    vals, runs = [], []
    for s, e in zip(starts, ends):
        n = e - s
        while n > 0:
            take = min(n, max_run)
            vals.append(w[s]); runs.append(take)
            n -= take
    return np.asarray(vals, dtype=w.dtype), np.asarray(runs, dtype=np.int64)


def rle_decode(vals: np.ndarray, runs: np.ndarray) -> np.ndarray:
    return np.repeat(vals, runs)


def rle_ratio(words: np.ndarray, word_bits: int, run_bits: int = 8) -> float:
    vals, runs = rle_encode(words, max_run=2**run_bits)
    raw = words.size * word_bits
    enc = vals.size * (word_bits + run_bits)
    return enc / max(raw, 1)


# =============================================================================
# Huffman (canonical)
# =============================================================================

@dataclasses.dataclass
class HuffmanCode:
    lengths: dict[int, int]            # symbol -> code length
    codes: dict[int, tuple[int, int]]  # symbol -> (code, length)

    @property
    def symbols(self) -> list[int]:
        return sorted(self.lengths)


def huffman_build(hist: dict[int, int]) -> HuffmanCode:
    """Build a canonical Huffman code from a symbol histogram."""
    if not hist:
        raise ValueError("empty histogram")
    if len(hist) == 1:
        sym = next(iter(hist))
        return HuffmanCode({sym: 1}, {sym: (0, 1)})
    heap = [(cnt, i, [s]) for i, (s, cnt) in enumerate(sorted(hist.items()))]
    heapq.heapify(heap)
    lengths: dict[int, int] = collections.defaultdict(int)
    tie = len(heap)
    while len(heap) > 1:
        c1, _, s1 = heapq.heappop(heap)
        c2, _, s2 = heapq.heappop(heap)
        for s in s1 + s2:
            lengths[s] += 1
        heapq.heappush(heap, (c1 + c2, tie, s1 + s2))
        tie += 1
    # canonical code assignment: sort by (length, symbol)
    order = sorted(lengths, key=lambda s: (lengths[s], s))
    codes: dict[int, tuple[int, int]] = {}
    code, prev_len = 0, 0
    for s in order:
        code <<= (lengths[s] - prev_len)
        codes[s] = (code, lengths[s])
        prev_len = lengths[s]
        code += 1
    return HuffmanCode(dict(lengths), codes)


def huffman_encode(words: np.ndarray, code: HuffmanCode) -> tuple[bytes, int]:
    """Encode to a bitstream; returns (payload, bit_count)."""
    bits = bytearray()
    acc, nacc = 0, 0
    for s in np.asarray(words).ravel().tolist():
        c, ln = code.codes[int(s)]
        acc = (acc << ln) | c
        nacc += ln
        while nacc >= 8:
            nacc -= 8
            bits.append((acc >> nacc) & 0xFF)
    total_bits = sum(code.codes[int(s)][1] for s in np.asarray(words).ravel().tolist())
    if nacc:
        bits.append((acc << (8 - nacc)) & 0xFF)
    return bytes(bits), total_bits


def huffman_decode(payload: bytes, nbits: int, code: HuffmanCode,
                   dtype=np.int64) -> np.ndarray:
    """Decode a bitstream produced by :func:`huffman_encode`."""
    # decoding table: (length, code) -> symbol
    table = {(ln, c): s for s, (c, ln) in code.codes.items()}
    out = []
    acc, nacc, consumed = 0, 0, 0
    it = iter(payload)
    while consumed < nbits:
        if nacc == 0:
            acc = next(it); nacc = 8
        acc_bit = (acc >> (nacc - 1)) & 1
        nacc -= 1
        consumed += 1
        out.append(acc_bit)
    # walk bit-by-bit
    syms, cur, ln = [], 0, 0
    for b in out:
        cur = (cur << 1) | b
        ln += 1
        if (ln, cur) in table:
            syms.append(table[(ln, cur)])
            cur, ln = 0, 0
    return np.asarray(syms, dtype=dtype)


def huffman_ratio(words: np.ndarray, word_bits: int,
                  calibration: np.ndarray | None = None) -> float:
    """Bits-out/bits-in using a code built on ``calibration`` (or the data)."""
    calib = words if calibration is None else calibration
    hist = collections.Counter(np.asarray(calib).ravel().tolist())
    code = huffman_build(dict(hist))
    w = np.asarray(words).ravel()
    # symbols unseen in calibration fall back to an escape of word_bits+1
    enc_bits = 0
    for s in w.tolist():
        enc_bits += code.codes[int(s)][1] if int(s) in code.codes else word_bits + 1
    return enc_bits / max(w.size * word_bits, 1)


# =============================================================================
# BFP8 — block floating point (shared exponent, int8 mantissa)
# =============================================================================

@dataclasses.dataclass
class BFP8Blocks:
    mantissas: np.ndarray  # int8, same count as input
    exponents: np.ndarray  # int8 per block
    block: int
    orig_len: int
    shape: tuple


def bfp8_encode(x: np.ndarray, block: int = 32) -> BFP8Blocks:
    """Channel/block-wise BFP8: one shared exponent per ``block`` values."""
    flat = np.asarray(x, dtype=np.float32).ravel()
    n = flat.size
    pad = (-n) % block
    fp = np.pad(flat, (0, pad))
    fp = fp.reshape(-1, block)
    amax = np.abs(fp).max(axis=1)
    exp = np.where(amax > 0, np.ceil(np.log2(np.maximum(amax, 1e-38))), 0.0)
    scale = 2.0 ** (exp - 6.0)            # 7 mantissa bits incl. sign -> +-127
    man = np.clip(np.round(fp / scale[:, None]), -127, 127).astype(np.int8)
    return BFP8Blocks(man, exp.astype(np.int8), block, n, np.asarray(x).shape)


def bfp8_decode(b: BFP8Blocks) -> np.ndarray:
    scale = 2.0 ** (b.exponents.astype(np.float32) - 6.0)
    out = b.mantissas.astype(np.float32) * scale[:, None]
    return out.ravel()[: b.orig_len].reshape(b.shape)


def bfp8_ratio(word_bits: int = 16, block: int = 32) -> float:
    """Compile-time-known ratio: 8 bits/word + 8 exponent bits per block."""
    return (8.0 + 8.0 / block) / word_bits


# =============================================================================
# Ratio estimation front-end used by the DSE (Eq. 2's c_bar, Eq. 4's c)
# =============================================================================

CODECS = ("none", "rle", "huffman", "bfp8")

# LUT cost per parallel stream for FPGA-mode designs (paper §V-C: "a fixed
# encoding and decoding cost in LUTs and FFs per data stream").
CODEC_LUT_COST = {"none": 0, "rle": 950, "huffman": 5200, "bfp8": 1400}


def estimate_ratio(codec: str, word_bits: int,
                   sample: np.ndarray | None = None,
                   sparsity: float = 0.5) -> float:
    """``c_bar`` for a stream.  With a calibration ``sample`` the ratio is
    measured; otherwise an analytic post-ReLU model parameterised by
    ``sparsity`` (fraction of zero words) is used."""
    if codec == "none":
        return 1.0
    if codec == "bfp8":
        return bfp8_ratio(word_bits)
    if sample is not None:
        q = np.clip(np.round(np.asarray(sample, np.float64) * 127), -127, 127).astype(np.int64)
        return rle_ratio(q, word_bits) if codec == "rle" else huffman_ratio(q, word_bits)
    if codec == "rle":
        # zero runs: geometric run model. expected words kept ~ (1 - s) + s/E[run]
        erun = 1.0 / max(1.0 - sparsity, 1e-3)
        kept = (1.0 - sparsity) + sparsity / erun
        return min(kept * (word_bits + 8) / word_bits, 1.0 + 8.0 / word_bits)
    if codec == "huffman":
        # entropy model: H = s*log(1/s) + (1-s)*(log(1/(1-s)) + word_bits - 1)
        s = min(max(sparsity, 1e-6), 1 - 1e-6)
        h = (-s * np.log2(s) - (1 - s) * np.log2(1 - s)) + (1 - s) * (word_bits - 1)
        return float(min(h / word_bits + 0.02, 1.05))
    raise ValueError(f"unknown codec {codec!r}")
