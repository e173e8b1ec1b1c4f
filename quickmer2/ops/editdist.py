"""Edit-distance-1/2 neighbor enumeration + occurrence filtering.

Reference: Recurse_edit/Permute_kmer/Kmer_filter_TSK (QuicKmer.c:78-88,
687-736). For every k-mer with occurrence count 1, the reference sums the
occurrence counts of all substitution neighbors at edit distance <= e
(distance-2 pairs restricted to pos2 < pos1, each pair enumerated once),
early-exiting once the partial sum exceeds the threshold d. The early
exit is order-independent (final value = min(total, d+1) in effect), so
the batched formulation below — full neighbor sum, then compare — is
exactly equivalent: a k-mer is deleted iff occr > 1 or sum >= d
(QuicKmer.c:1218-1231).

Neighbor generation is vectorized over a static edit table of
(pos1, delta1, pos2, delta2) tuples: M = 3k single edits plus
9*k*(k-1)/2 double edits (4005 at k=30). Applying an edit is a single
XOR at a variable bit offset on both the forward code and its exact
reverse complement (complement differences XOR-commute: (b^2) patterns),
then canonical = min of the pair.

Quirk-compat mode (SURVEY.md Q2): the reference computes its clear masks
with `3 << (2*pos)` in 32-bit int arithmetic — undefined behavior whose
x86 semantics (shift count mod 32, sign-extended subtraction) corrupt
the generated neighbors for fwd pos >= 16 / rc pos <= k-17. The shipped
GRCh38 dictionaries embed this. `quirk_permute_np` reproduces the mod-32
semantics bit-for-bit (host path, k=30 only) for dictionary parity.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from quickmer2.ops.hash import djb_pair


def edit_table(k: int, edit_distance: int):
    """Static neighbor-edit table: arrays pos1, xor1(1..3), pos2, xor2
    with pos2 = -1 rows for single edits. The xor value IS the delta
    pattern: newbase = base ^ xor reproduces base' = (base+delta)&3 for
    all deltas? No — (base+delta)&3 is not an XOR for delta=1,3. We
    therefore store delta and compute the XOR per element at runtime.
    """
    p1, d1, p2, d2 = [], [], [], []
    for a in range(k):
        for va in (1, 2, 3):
            p1.append(a); d1.append(va); p2.append(-1); d2.append(0)
            if edit_distance >= 2:
                for b in range(a):
                    for vb in (1, 2, 3):
                        p1.append(a); d1.append(va); p2.append(b); d2.append(vb)
    return (np.array(p1, np.int32), np.array(d1, np.uint32),
            np.array(p2, np.int32), np.array(d2, np.uint32))


def _apply_edit_pair(fhi, flo, rhi, rlo, pos, delta, k):
    """Apply one substitution at `pos` (delta in 1..3) to a batch of
    (fwd, rc) u32-pair codes. pos/delta may broadcast against the batch.
    Returns updated (fhi, flo, rhi, rlo)."""
    b = 2 * pos
    in_hi = b >= 32
    sh = jnp.where(in_hi, b - 32, b).astype(jnp.uint32)
    word = jnp.where(in_hi, fhi, flo)
    base = (word >> sh) & jnp.uint32(3)
    nb = (base + delta) & jnp.uint32(3)
    x = base ^ nb
    fhi = fhi ^ jnp.where(in_hi, x << sh, jnp.uint32(0))
    flo = flo ^ jnp.where(in_hi, jnp.uint32(0), x << sh)
    # reverse complement: same XOR pattern at mirrored position
    br = 2 * (k - 1 - pos)
    rin_hi = br >= 32
    rsh = jnp.where(rin_hi, br - 32, br).astype(jnp.uint32)
    rhi = rhi ^ jnp.where(rin_hi, x << rsh, jnp.uint32(0))
    rlo = rlo ^ jnp.where(rin_hi, jnp.uint32(0), x << rsh)
    return fhi, flo, rhi, rlo


@functools.partial(jax.jit, static_argnames=("k", "hash_size", "max_steps"))
def neighbor_occr_sum(khi, klo, rkhi, rklo,
                      table_hi, table_lo, occr,
                      p1, d1, p2, d2, *, k: int, hash_size: int,
                      max_steps: int = 4096):
    """Sum of neighbor occurrence counts for a batch of k-mers.

    k{hi,lo}: canonical codes u32[N]; rk{hi,lo}: their exact reverse
    complements. occr: u8[hash_size] per-slot counts. p1/d1/p2/d2: the
    static edit table (M entries). Returns u32[N] sums over all M
    neighbors present in the table.

    Memory is O(N*M); callers choose N so N*M*4B fits comfortably.
    """
    N = khi.shape[0]
    M = p1.shape[0]
    chi, clo = _neighbor_canon(khi, klo, rkhi, rklo, p1, d1, p2, d2, k)

    idx0 = djb_pair(chi, clo) & jnp.uint32(hash_size - 1)
    step = jnp.where(idx0 & jnp.uint32(hash_size >> 1), -1, 1).astype(jnp.int32)
    idx = idx0.astype(jnp.int32)

    def probe_once(idx):
        ehi = table_hi[idx]
        elo = table_lo[idx]
        return (ehi == chi) & (elo == clo), (ehi == 0) & (elo == 0)

    def cond(state):
        _, done, it = state
        return (~jnp.all(done)) & (it < max_steps)

    def body(state):
        idx, done, it = state
        idx = jnp.where(done, idx, idx + step)
        match, empty = probe_once(idx)
        done = done | match | empty
        return idx, done, it + 1

    match0, empty0 = probe_once(idx)
    idx, _, _ = jax.lax.while_loop(cond, body, (idx, match0 | empty0, jnp.int32(0)))
    match, _ = probe_once(idx)
    # k-mer code 0 "matches" empty slots (occr 0 there) — harmless
    contrib = jnp.where(match, occr[idx].astype(jnp.uint32), jnp.uint32(0))
    return contrib.reshape(N, M).sum(axis=1, dtype=jnp.uint32)


def _neighbor_canon(khi, klo, rkhi, rklo, p1, d1, p2, d2, k):
    """Canonical (hi, lo) of every (k-mer, edit) pair — shared neighbor
    generator for the probe-based sums. Returns flat u32[N*M] pairs."""
    N = khi.shape[0]
    M = p1.shape[0]
    fhi = jnp.broadcast_to(khi[:, None], (N, M))
    flo = jnp.broadcast_to(klo[:, None], (N, M))
    rhi = jnp.broadcast_to(rkhi[:, None], (N, M))
    rlo = jnp.broadcast_to(rklo[:, None], (N, M))
    fhi, flo, rhi, rlo = _apply_edit_pair(fhi, flo, rhi, rlo,
                                          p1[None, :], d1[None, :], k)
    has2 = (p2 >= 0)[None, :]
    p2c = jnp.maximum(p2, 0)[None, :]
    fhi2, flo2, rhi2, rlo2 = _apply_edit_pair(fhi, flo, rhi, rlo,
                                              p2c, d2[None, :], k)
    fhi = jnp.where(has2, fhi2, fhi)
    flo = jnp.where(has2, flo2, flo)
    rhi = jnp.where(has2, rhi2, rhi)
    rlo = jnp.where(has2, rlo2, rlo)
    fwd_less = (fhi < rhi) | ((fhi == rhi) & (flo <= rlo))
    chi = jnp.where(fwd_less, fhi, rhi).reshape(-1)
    clo = jnp.where(fwd_less, flo, rlo).reshape(-1)
    return chi, clo


@functools.partial(jax.jit, static_argnames=("k", "n_buckets"))
def neighbor_occr_sum_packed(khi, klo, rkhi, rklo, rows,
                             p1, d1, p2, d2, *, k: int, n_buckets: int):
    """neighbor_occr_sum against the packed two-choice table
    (ops.packed_table) with the occurrence count carried in each
    entry's pos field: exactly TWO row gathers per neighbor instead of
    the linear-probe while_loop's gather-per-step (up to ~2x17 at 50%
    fill). Output-identical to neighbor_occr_sum on the same
    dictionary contents."""
    from quickmer2.ops.packed_table import probe_packed
    N = khi.shape[0]
    M = p1.shape[0]
    chi, clo = _neighbor_canon(khi, klo, rkhi, rklo, p1, d1, p2, d2, k)
    found, _, occ = probe_packed(rows, chi, clo, n_buckets, jnp.uint32(0))
    contrib = jnp.where(found, occ, jnp.uint32(0))
    return contrib.reshape(N, M).sum(axis=1, dtype=jnp.uint32)


# ---------------------------------------------------------------------------
# Host quirk-compat path (mod-32 shift UB emulation, k=30 only)
# ---------------------------------------------------------------------------

KMER_MASK_30 = np.uint64((1 << 60) - 1)


def quirk_permute_np(fwd: np.ndarray, rc: np.ndarray, pos: int, delta: int, k: int):
    """Bit-exact emulation of Permute_kmer (QuicKmer.c:78-88) including
    the 32-bit `3 << (pos<<1)` UB (x86: count mod 32, sign-extended).

    fwd/rc: u64 arrays (rc in the reference's 60-bit-register layout,
    identical to the exact rc at k=30). Returns mutated (fwd, rc).
    """
    U64 = (1 << 64) - 1
    kmask = (1 << (2 * k)) - 1

    def clear_mask(bitpos: int) -> np.uint64:
        # int32 `3 << bitpos`: hardware masks the count mod 32; the int
        # result sign-extends to 64 bits; then Kmer_mask MINUS it (a
        # wrapping subtract, not an and-not) forms the "clear" mask.
        v32 = (3 << (bitpos & 31)) & 0xFFFFFFFF
        v = v32 - (1 << 32) if v32 & 0x80000000 else v32
        return np.uint64((kmask - v) & U64)

    base = (fwd >> np.uint64(2 * pos)) & np.uint64(3)  # 64-bit shift: correct in ref
    nb = (base + np.uint64(delta)) & np.uint64(3)
    fwd = (fwd & clear_mask(2 * pos)) | (nb << np.uint64(2 * pos))
    rb = (nb - np.uint64(2)) & np.uint64(3)
    rpos = 2 * (k - 1 - pos)
    rc = (rc & clear_mask(rpos)) | (rb << np.uint64(rpos))
    return fwd, rc


def neighbor_occr_sum_quirk_np(kmers: np.ndarray, table: np.ndarray,
                               occr: np.ndarray, hash_size: int,
                               k: int, edit_distance: int) -> np.ndarray:
    """Host quirk-compat neighbor sum (vectorized over the k-mer batch,
    python loop over the O(k^2) edit table). Deletion decisions match the
    reference binary bit-for-bit (verified by differential test E6)."""
    from quickmer2.ops.codec import split_u64
    from quickmer2.ops import hash as qhash

    kmers = np.asarray(kmers, dtype=np.uint64)
    # the reference recomputes the exact rc register before filtering
    # (Reverse_strand_encoded, QuicKmer.c:728)
    rc = np.zeros_like(kmers)
    tmp = kmers.copy()
    for _ in range(k):
        rc = (rc << np.uint64(2)) | ((tmp - np.uint64(2)) & np.uint64(3))
        tmp >>= np.uint64(2)
    rc &= np.uint64((1 << (2 * k)) - 1)

    total = np.zeros(len(kmers), dtype=np.uint64)

    def probe_and_add(f, r):
        canon = np.minimum(f, r)
        slots, found = qhash.probe_lookup_np(table, canon, hash_size)
        total[:] = total + np.where(found, occr[slots].astype(np.uint64), np.uint64(0))

    for p1 in range(k):
        for v1 in (1, 2, 3):
            f1, r1 = quirk_permute_np(kmers.copy(), rc.copy(), p1, v1, k)
            if edit_distance >= 2:
                for p2 in range(p1):
                    for v2 in (1, 2, 3):
                        f2, r2 = quirk_permute_np(f1.copy(), r1.copy(), p2, v2, k)
                        probe_and_add(f2, r2)
            probe_and_add(f1, r1)
    return total
