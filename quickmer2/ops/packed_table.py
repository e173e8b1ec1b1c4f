"""Packed bucketized two-choice dictionary table — a fixed-cost probe
layout.

The reference's linear-probe layout (variable-length scans) costs a
full-batch gather per probe STEP on a vector machine, and the
while_loop runs to the longest cluster (~17 steps at 50% fill), i.e.
~34 gathers/k-mer. This layout resolves every probe in EXACTLY two row
gathers:

  * B buckets of C=2 entries; each bucket is one contiguous 32B row of
    8 u32: [hi, lo, rank, pos] x 2 (pos = global genome end position,
    used by the anchored fast path; 0 when unknown);
  * every key lives in bucket h1(key) or h2(key) (two-choice placement,
    first-fit h1 at build time); probe gathers both rows and compares
    all 4 entries in registers;
  * empty entries are (0,0) — k-mer code 0 is reserved (quirk Q3), so
    (hi|lo)==0 marks empty and a query of 0 can never false-match a
    real entry (it reports found on empties, exactly like the
    reference's Find_hash — callers mask via rank sentinel).

Build is host-side numpy (vectorized first-fit over hash candidates);
guaranteed placement is verified and the bucket count doubles on
overflow (load factor 0.5 at C=2 overflows with probability ~1e-6 per
build; doubling is deterministic).

This is a derived, in-memory layout: the on-disk .qm format and the
reference-compatible linear-probe table remain the interchange format
(SURVEY.md section 4); rank order (and therefore every output artifact)
is unchanged.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

# 2 entries x (hi, lo, rank, pos) = 8 u32 = 32 B per bucket row: the
# narrower row moves half the bytes per gather, and two-choice placement
# at load 0.5 with C=2 still succeeds w.h.p. (doubling on the rare
# failure).
ENTRIES_PER_BUCKET = 2
ROW_WIDTH = 4 * ENTRIES_PER_BUCKET  # 8 u32 = 32 B

_H2_MULT = np.uint32(2654435761)  # Knuth multiplicative hash


def bucket_hashes(h: np.ndarray, n_buckets: int):
    """Two bucket candidates from the DJB low-32 hash (h1 = same home
    bucket family as the reference's probe start; h2 decorrelated: the
    TOP log2(n_buckets) bits of the multiplicative hash, so h2 reaches
    every bucket of a table of any size up to 2^32 buckets)."""
    h1 = h & np.uint32(n_buckets - 1)
    h2 = (h * _H2_MULT) >> np.uint32(32 - _log2(n_buckets))
    return h1, h2


def bucket_hashes_jnp(h, n_buckets: int):
    h1 = h & jnp.uint32(n_buckets - 1)
    h2 = (h * jnp.uint32(int(_H2_MULT))) >> jnp.uint32(32 - _log2(n_buckets))
    return h1, h2


def _log2(n_buckets: int) -> int:
    b = int(n_buckets).bit_length() - 1
    if n_buckets != 1 << b or not 1 <= b <= 32:
        raise ValueError(f"n_buckets {n_buckets} is not a power of two "
                         f"in [2, 2^32]")
    return b


@dataclasses.dataclass
class PackedTable:
    rows: np.ndarray        # u32[B, 16]
    n_buckets: int
    n_kmers: int

    @classmethod
    def build(cls, khi: np.ndarray, klo: np.ndarray, rank: np.ndarray,
              pos: np.ndarray | None = None, load: float = 0.5) -> "PackedTable":
        """khi/klo/rank (+optional pos) per dictionary k-mer (any order)."""
        from quickmer2.ops.hash import djb_pair_np
        n = len(khi)
        if pos is None:
            pos = np.zeros(n, np.uint32)
        n_buckets = 1 << max(
            1, int(np.ceil(np.log2(max(n, 1) / (ENTRIES_PER_BUCKET * load)))))
        h = djb_pair_np(khi, klo)
        while True:
            rows = _try_place(khi, klo, rank, pos, h, n_buckets)
            if rows is not None:
                return cls(rows, n_buckets, n)
            n_buckets <<= 1

    @classmethod
    def from_dictionary(cls, dic, pos: np.ndarray | None = None,
                        load: float = 0.5) -> "PackedTable":
        from quickmer2.ops import codec
        kmers = dic.kmers_in_order
        khi, klo = codec.split_u64(kmers)
        rank = np.arange(len(kmers), dtype=np.uint32)
        return cls.build(khi, klo, rank, pos, load)

    def device_rows(self):
        return jnp.asarray(self.rows)


def _try_place(khi, klo, rank, pos, h, n_buckets):
    """Vectorized two-choice first-fit: several rounds of 'everyone not
    yet placed tries its next candidate slot; ties broken by scatter
    order'. Deterministic (stable order by key index)."""
    n = len(khi)
    fill = np.zeros(n_buckets, np.int64)
    slot_of = np.full(n, -1, np.int64)       # bucket*C + entry
    h1, h2 = bucket_hashes(h, n_buckets)
    pending = np.arange(n)
    for _ in range(2 * ENTRIES_PER_BUCKET + 4):
        if len(pending) == 0:
            break
        # choose candidate bucket: h1 if it has room else h2
        b1 = h1[pending].astype(np.int64)
        b2 = h2[pending].astype(np.int64)
        cand = np.where(fill[b1] < ENTRIES_PER_BUCKET, b1,
                        np.where(fill[b2] < ENTRIES_PER_BUCKET, b2, -1))
        stuck = cand < 0
        if stuck.all():
            break  # remaining keys all need eviction — go to cuckoo
        # first-come order within this round: stable sequential claim via
        # cumulative count per bucket
        order = np.argsort(cand, kind="stable")
        cs = cand[order]
        first_in_group = np.ones(len(cs), bool)
        first_in_group[1:] = cs[1:] != cs[:-1]
        grp_start = np.maximum.accumulate(
            np.where(first_in_group, np.arange(len(cs)), 0))
        offset_in_group = np.arange(len(cs)) - grp_start
        entry = fill[cs] + offset_in_group
        ok = (~stuck[order]) & (entry < ENTRIES_PER_BUCKET)
        placed_idx = pending[order[ok]]
        slot_of[placed_idx] = cs[ok] * ENTRIES_PER_BUCKET + entry[ok]
        np.add.at(fill, cs[ok], 1)
        pending = pending[np.isin(pending, placed_idx, invert=True)]
    if len(pending) and not _cuckoo_evict(pending, slot_of, h1, h2, n_buckets):
        return None
    if (slot_of < 0).any():
        return None
    rows = np.zeros((n_buckets, ROW_WIDTH), np.uint32)
    flat = rows.reshape(-1, 4)
    flat[slot_of, 0] = khi
    flat[slot_of, 1] = klo
    flat[slot_of, 2] = np.asarray(rank, np.uint32)
    flat[slot_of, 3] = np.asarray(pos, np.uint32)
    return rows


def _cuckoo_evict(pending, slot_of, h1, h2, n_buckets) -> bool:
    """Place the (rare, ~0.1%) keys whose both buckets filled during the
    greedy rounds, by deterministic cuckoo random-walk eviction. Mutates
    slot_of in place; returns False if a walk exceeds the kick budget
    (caller doubles the table). The victim entry comes from a
    per-walk LCG seeded by the key: a victim that alternates with the
    kick count can cycle between two full buckets for ever."""
    C = ENTRIES_PER_BUCKET
    occupant = np.full(n_buckets * C, -1, np.int64)
    placed = slot_of >= 0
    occupant[slot_of[placed]] = np.flatnonzero(placed)
    for key in pending:
        cur = int(key)
        bucket = int(h1[cur])
        state = cur
        for _ in range(512):
            base = bucket * C
            empty = -1
            for e in range(C):
                if occupant[base + e] < 0:
                    empty = e
                    break
            if empty >= 0:
                occupant[base + empty] = cur
                slot_of[cur] = base + empty
                break
            state = (state * 6364136223846793005
                     + 1442695040888963407) & 0xFFFFFFFFFFFFFFFF
            victim_e = (state >> 33) % C
            victim = int(occupant[base + victim_e])
            occupant[base + victim_e] = cur
            slot_of[cur] = base + victim_e
            slot_of[victim] = -1
            # victim moves to its alternate bucket
            bucket = int(h2[victim]) if int(h1[victim]) == bucket else int(h1[victim])
            cur = victim
        else:
            return False
    return True


def probe_packed_np(rows: np.ndarray, khi: np.ndarray, klo: np.ndarray,
                    n_buckets: int) -> np.ndarray:
    """Host (numpy) membership probe — same two-row-gather semantics as
    the device probe_packed, found flags only. Used by offline index
    builds (e.g. the neighbor-hit bitmap)."""
    from quickmer2.ops.hash import djb_pair_np
    h = djb_pair_np(khi, klo)
    h1, h2 = bucket_hashes(h, n_buckets)
    found = np.zeros(len(khi), bool)
    for idx in (h1, h2):
        r = rows[idx.astype(np.int64)]
        for e in range(ENTRIES_PER_BUCKET):
            found |= (r[:, 4 * e] == khi) & (r[:, 4 * e + 1] == klo)
    found &= (khi | klo) != 0
    return found


def probe_packed_block(local_rows, khi, klo, n_buckets: int,
                       block_buckets: int, blk_lo, miss_rank):
    """probe_packed against ONE contiguous bucket block of a
    dict-sharded table (rows[blk_lo : blk_lo + block_buckets]). Buckets
    are self-contained, so a key's entry lives on exactly one device:
    local (found, rank, pos) from all devices combine by psum / any.
    Foreign-lane candidates gather row 0 and never match (masked)."""
    from quickmer2.ops.hash import djb_pair
    h = djb_pair(khi, klo)
    i1, i2 = bucket_hashes_jnp(h, n_buckets)
    nonzero_q = (khi | klo) != 0
    found = jnp.zeros(khi.shape, bool)
    rank = jnp.full(khi.shape, miss_rank, jnp.uint32)
    pos = jnp.zeros(khi.shape, jnp.uint32)
    for cand in (i1, i2):
        off = cand - jnp.uint32(blk_lo)          # u32 wrap for foreign
        local = off < jnp.uint32(block_buckets)
        idx = jnp.where(local, off, 0).astype(jnp.int32)
        r = local_rows[idx]
        for e in range(ENTRIES_PER_BUCKET):
            m = local & nonzero_q & (r[:, 4 * e] == khi) \
                & (r[:, 4 * e + 1] == klo)
            found = found | m
            rank = jnp.where(m, r[:, 4 * e + 2], rank)
            pos = jnp.where(m, r[:, 4 * e + 3], pos)
    return found, rank, pos


def probe_packed(rows, khi, klo, n_buckets: int, miss_rank):
    """Device probe: exactly two row gathers. Returns (found bool[N],
    rank u32[N], pos u32[N]); misses get miss_rank and pos 0."""
    from quickmer2.ops.hash import djb_pair
    h = djb_pair(khi, klo)
    i1, i2 = bucket_hashes_jnp(h, n_buckets)
    r1 = rows[i1.astype(jnp.int32)]
    r2 = rows[i2.astype(jnp.int32)]

    # query code 0 would "match" empty entries (whose rank field is 0,
    # not the sentinel) — mask it out; the result is identical to the
    # reference's invisible phantom hit (quirk Q3).
    nonzero_q = (khi | klo) != 0
    found = jnp.zeros(khi.shape, bool)
    rank = jnp.full(khi.shape, miss_rank, jnp.uint32)
    pos = jnp.zeros(khi.shape, jnp.uint32)
    for r in (r1, r2):
        for e in range(ENTRIES_PER_BUCKET):
            m = nonzero_q & (r[:, 4 * e] == khi) & (r[:, 4 * e + 1] == klo)
            found = found | m
            rank = jnp.where(m, r[:, 4 * e + 2], rank)
            pos = jnp.where(m, r[:, 4 * e + 3], pos)
    return found, rank, pos
