"""K-mer codec: 2-bit base encoding, reverse complement, canonicalization,
and bulk sliding-window k-mer extraction.

Encoding parity with the reference (QuicKmer.c:43-64):
  base code = (ascii >> 1) & 3  →  A=0, C=1, T=2, G=3
  complement(code) = (code - 2) & 3  (A↔T, C↔G)
  k-mer code = bases packed MSB-first into the low 2k bits of a u64
  canonical  = min(forward, reverse-complement)   [exact for all k here;
               the reference is exact only at k=30 — SURVEY.md Q1]

Two implementations:
  * host path  — numpy uint64, used by file IO, dictionary build, tests
  * device path — jax uint32 (hi, lo) pairs: JAX runs 32-bit by
    default (64-bit is a process-global switch), and every quantity we
    need (probe index, comparisons) decomposes exactly into 32-bit ops.

A "sequence stream" is a uint8 code array where values 0..3 are bases and
SEP (>=4) marks invalid positions: N bases, record separators, padding.
A window of k codes yields a k-mer iff it contains no SEP — this single
rule reproduces the reference's per-line rolling-state reset in count
(QuicKmer.c:399-402, SURVEY.md Q4) and the '>'/N resets in search
(QuicKmer.c:826-852) once the host packer inserts separators at the
right places.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Code for any non-ACGT byte in a packed sequence stream.
SEP = np.uint8(4)

# 256-entry byte → 2-bit-code lookup; non-ACGT(acgt) maps to SEP.
_BASE_LUT = np.full(256, SEP, dtype=np.uint8)
for _b in b"ACGTacgt":
    _BASE_LUT[_b] = (_b >> 1) & 3

_CODE_TO_BASE = np.frombuffer(b"ACTG", dtype=np.uint8)  # code 0,1,2,3


def encode_bases(seq: bytes | np.ndarray) -> np.ndarray:
    """ASCII sequence → uint8 code array (0..3, SEP for non-ACGT)."""
    buf = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, (bytes, bytearray)) else seq
    return _BASE_LUT[buf]


def decode_kmer(code: int, k: int) -> str:
    """u64 k-mer code → ACGT string (MSB-first)."""
    out = bytearray(k)
    for i in range(k - 1, -1, -1):
        out[i] = _CODE_TO_BASE[code & 3]
        code >>= 2
    return out.decode()


def encode_kmer_string(s: str) -> int:
    """ACGT string → canonical u64 code (reference Kmer_encode semantics,
    exact reverse complement)."""
    codes = encode_bases(s.encode())
    if (codes >= 4).any():
        raise ValueError(f"non-ACGT base in k-mer {s!r}")
    k = len(codes)
    fwd = 0
    rc = 0
    for j, c in enumerate(codes):
        fwd = (fwd << 2) | int(c)
        rc |= ((int(c) - 2) & 3) << (2 * j)
    return min(fwd, rc) & ((1 << (2 * k)) - 1)


def revcomp_code(code: int, k: int) -> int:
    """Exact reverse complement of a 2k-bit k-mer code
    (reference Reverse_strand_encoded, QuicKmer.c:101-111)."""
    rc = 0
    for _ in range(k):
        rc = (rc << 2) | ((code - 2) & 3)
        code >>= 2
    return rc & ((1 << (2 * k)) - 1)


# ---------------------------------------------------------------------------
# Host bulk extraction (numpy, u64)
# ---------------------------------------------------------------------------

def sliding_fwd_rc_np(codes: np.ndarray, k: int):
    """Forward and reverse-complement codes of every sliding window
    (NOT canonicalized — callers needing per-strand bit surgery, e.g.
    the neighbor-hit index build, take min themselves).

    Returns (fwd u64[N], rc u64[N], valid bool[N]), N = len(codes)-k+1.
    Window i's base at offset j sits in fwd bits [2(k-1-j), 2(k-j)) and,
    complemented, in rc bits [2j, 2j+2).
    """
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint64), np.zeros(0, bool)
    mask = np.uint64((1 << (2 * k)) - 1)
    fwd = np.zeros(n, np.uint64)
    rc = np.zeros(n, np.uint64)
    top = np.uint64(2 * (k - 1))
    for j in range(k):
        c = codes[j : j + n].astype(np.uint64) & np.uint64(3)
        fwd = ((fwd << np.uint64(2)) | c) & mask
        rcb = (c - np.uint64(2)) & np.uint64(3)
        rc = (rc >> np.uint64(2)) | (rcb << top)
    bad = (codes >= 4).astype(np.int32)
    cs = np.concatenate([[0], np.cumsum(bad)])
    valid = (cs[k:] - cs[:-k]) == 0
    return fwd, rc, valid


def sliding_kmers_np(codes: np.ndarray, k: int):
    """All sliding-window canonical k-mers of a code stream.

    Returns (canon u64[N], valid bool[N]) with N = len(codes) - k + 1.
    valid[i] is False if any of codes[i:i+k] is SEP.
    """
    fwd, rc, valid = sliding_fwd_rc_np(codes, k)
    return np.minimum(fwd, rc), valid


def window_kmers_np(codes: np.ndarray, starts: np.ndarray, k: int):
    """Canonical k-mer of the one window codes[s:s+k] for each s in
    `starts` (all-ACGT windows; u64[len(starts)]). O(len(starts) * k),
    for the few windows the device leaves to the host."""
    fwd = np.zeros(len(starts), np.uint64)
    rc = np.zeros(len(starts), np.uint64)
    top = np.uint64(2 * (k - 1))
    for j in range(k):
        c = codes[starts + j].astype(np.uint64) & np.uint64(3)
        fwd = (fwd << np.uint64(2)) | c
        rc = (rc >> np.uint64(2)) | (((c - np.uint64(2)) & np.uint64(3)) << top)
    return np.minimum(fwd, rc)


def split_u64(x: np.ndarray):
    """u64 array → (hi u32, lo u32)."""
    x = np.asarray(x, dtype=np.uint64)
    return (x >> np.uint64(32)).astype(np.uint32), (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def join_u64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return (np.asarray(hi, np.uint64) << np.uint64(32)) | np.asarray(lo, np.uint64)


# ---------------------------------------------------------------------------
# Device bulk extraction (jax, u32 pairs)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("k",))
def sliding_fwd_rc(codes: jax.Array, k: int):
    """Device sliding-window strand codes as uint32 (hi, lo) pairs,
    NOT canonicalized (callers doing per-strand bit surgery — e.g. the
    neighbor-hit bitmap build — take the min themselves).

    codes: uint8[L] sequence stream (0..3 bases, >=4 separators).
    Returns (fhi, flo, rhi, rlo (u32[N] each), valid bool[N]),
    N = L - k + 1. Window i's base at offset j sits in fwd bits
    [2(k-1-j), 2(k-j)) and, complemented, in rc bits [2j, 2j+2).

    The k-iteration roll is unrolled at trace time (k is static); XLA fuses
    it into a handful of elementwise passes.
    """
    L = codes.shape[0]
    n = L - k + 1
    assert n > 0, "stream shorter than k"
    two_k = 2 * k
    lo_bits = min(32, two_k)
    hi_bits = max(0, two_k - 32)
    lo_mask = jnp.uint32(0xFFFFFFFF if lo_bits == 32 else (1 << lo_bits) - 1)
    hi_mask = jnp.uint32((1 << hi_bits) - 1)
    top = two_k - 2  # bit offset of the most significant base

    c32 = codes.astype(jnp.uint32)
    fhi = jnp.zeros(n, jnp.uint32)
    flo = jnp.zeros(n, jnp.uint32)
    rhi = jnp.zeros(n, jnp.uint32)
    rlo = jnp.zeros(n, jnp.uint32)
    for j in range(k):
        c = jax.lax.dynamic_slice(c32, (j,), (n,)) & jnp.uint32(3)
        # forward: shift left 2, push c at LSB
        fhi = ((fhi << 2) | (flo >> 30)) & hi_mask
        flo = ((flo << 2) | c) & lo_mask
        # reverse: shift right 2, push complement at bit `top`
        rcb = (c - jnp.uint32(2)) & jnp.uint32(3)
        rlo = (rlo >> 2) | ((rhi & jnp.uint32(3)) << 30)
        rhi = rhi >> 2
        if top >= 32:
            rhi = rhi | (rcb << (top - 32))
        else:
            rlo = rlo | (rcb << top)

    bad = (codes >= 4).astype(jnp.int32)
    cs = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(bad)])
    valid = (jax.lax.dynamic_slice(cs, (k,), (n,)) - jax.lax.dynamic_slice(cs, (0,), (n,))) == 0
    return fhi, flo, rhi, rlo, valid


@functools.partial(jax.jit, static_argnames=("k",))
def sliding_kmers(codes: jax.Array, k: int):
    """Device version of sliding_kmers_np on uint32 (hi, lo) pairs.

    codes: uint8[L] sequence stream (0..3 bases, >=4 separators).
    Returns (canon_hi u32[N], canon_lo u32[N], valid bool[N]), N = L - k + 1.
    """
    fhi, flo, rhi, rlo, valid = sliding_fwd_rc(codes, k)
    # canonical = lexicographic min over (hi, lo)
    fwd_less = (fhi < rhi) | ((fhi == rhi) & (flo <= rlo))
    chi = jnp.where(fwd_less, fhi, rhi)
    clo = jnp.where(fwd_less, flo, rlo)
    return chi, clo, valid
