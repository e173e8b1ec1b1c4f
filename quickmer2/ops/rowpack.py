"""2-bit row packing for host→device read transfer.

The count path moves every read byte across the host↔device link
(PCIe) once.
Read rows are u8 codes in {0..3, SEP}; their information content is
2 bits/base plus a sparse validity mask, so packing before device_put
cuts link traffic ~3.5x for free device-side work (a handful of
vector ops to unpack). The unpack reproduces the row matrix exactly,
so counting results are bit-identical with packing on or off
(tests/test_anchored.py::test_packed_h2d_identical).

Layout per batch of rows u8[R, L]:
  codes  u8[R, ceil(L/4)] — 4 bases/byte, little-endian 2-bit lanes
                            (SEP positions carry 0; restored from mask)
  invalid u8[R, ceil(L/8)] — bit i of byte j = 1 where row[8j+i] is
                            not an ACGT code (SEP padding / N bases)

No reference counterpart (the reference's reader and counter share one
address space, QuicKmer.c:386-456); this is the device analog of
keeping the FIFO hand-off narrow.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from quickmer2.ops.codec import SEP


def pack_rows(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host-side pack: u8[R, L] codes → (codes u8[R, ceil(L/4)],
    invalid u8[R, ceil(L/8)])."""
    rows = np.asarray(rows, np.uint8)
    R, L = rows.shape
    L8 = -(-L // 8) * 8
    inval = rows >= 4
    packed = pack_codes(rows)
    iv = inval
    if L8 != L:
        # padding beyond L is invalid by definition
        iv = np.pad(inval, ((0, 0), (0, L8 - L)), constant_values=True)
    bits = np.zeros((R, L8 // 8), np.uint8)
    for i in range(8):
        bits |= iv[:, i::8].astype(np.uint8) << i
    return packed, bits


@functools.partial(jax.jit, static_argnames=("read_len",))
def unpack_rows(packed, invalid, *, read_len: int):
    """Device-side unpack: exact inverse of pack_rows (SEP restored at
    invalid positions). Returns u8[R, read_len]."""
    L = read_len
    shifts = jnp.tile(jnp.array([0, 2, 4, 6], jnp.uint8), -(-L // 4))[:L]
    codes = (jnp.repeat(packed, 4, axis=1)[:, :L] >> shifts) & jnp.uint8(3)
    ishift = jnp.tile(jnp.arange(8, dtype=jnp.uint8), -(-L // 8))[:L]
    inval = (jnp.repeat(invalid, 8, axis=1)[:, :L] >> ishift) & jnp.uint8(1)
    return jnp.where(inval != 0, jnp.uint8(SEP), codes)


# -- "lens" variant: suffix-padded rows need only a length per row -------
#
# Rows from uniform-length FASTQ are [read codes..., SEP padding]: the
# invalid set is exactly a suffix, so a u16 length replaces the L/8-byte
# bitmask (60 → 42 bytes per 160-wide row). Rows with an INTERIOR
# invalid code (an N base) can't use it; pack_batch falls back to the
# bitmask format for any batch containing one.


def row_suffix_lens(rows: np.ndarray) -> np.ndarray | None:
    """u16 lengths if every row's invalid set is a pure suffix, else
    None (some row has an interior invalid code)."""
    rows = np.asarray(rows, np.uint8)
    R, L = rows.shape
    inval = rows >= 4
    n_inval = inval.sum(axis=1)
    first = np.where(n_inval > 0, np.argmax(inval, axis=1), L)
    if not (n_inval == L - first).all():
        return None
    return first.astype(np.uint16)


def pack_codes(rows: np.ndarray) -> np.ndarray:
    """u8[R, ceil(L/4)] 2-bit code lanes (invalid positions carry 0)."""
    rows = np.asarray(rows, np.uint8)
    L = rows.shape[1]
    L4 = -(-L // 4) * 4
    c = np.where(rows >= 4, 0, rows).astype(np.uint8)
    if L4 != L:
        c = np.pad(c, ((0, 0), (0, L4 - L)))
    return (c[:, 0::4] | (c[:, 1::4] << 2) | (c[:, 2::4] << 4)
            | (c[:, 3::4] << 6))


@functools.partial(jax.jit, static_argnames=("read_len",))
def unpack_rows_lens(packed, lens, *, read_len: int):
    """Device-side unpack of the lens format: SEP at positions >= len."""
    L = read_len
    shifts = jnp.tile(jnp.array([0, 2, 4, 6], jnp.uint8), -(-L // 4))[:L]
    codes = (jnp.repeat(packed, 4, axis=1)[:, :L] >> shifts) & jnp.uint8(3)
    pad = jnp.arange(L, dtype=jnp.uint16)[None, :] >= lens[:, None]
    return jnp.where(pad, jnp.uint8(SEP), codes)


def pack_batch(rows: np.ndarray):
    """Choose the narrowest exact format for a batch: ("lens", codes,
    lens) when every row is suffix-padded, else ("mask", codes,
    invalid_bits)."""
    lens = row_suffix_lens(rows)
    if lens is not None:
        return "lens", pack_codes(rows), lens
    packed, bits = pack_rows(rows)
    return "mask", packed, bits


def unpack_batch(fmt: str, packed, aux, *, read_len: int):
    """Device-side dispatcher for pack_batch output (trace-time fmt)."""
    if fmt == "lens":
        return unpack_rows_lens(packed, aux, read_len=read_len)
    return unpack_rows(packed, aux, read_len=read_len)
