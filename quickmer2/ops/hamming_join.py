"""Edit-distance filter as a blocked Hamming join — the search-phase
flagship kernel.

Reference semantics (Recurse_edit, QuicKmer.c:687-736): for each unique
k-mer u, sum the occurrence counts of every substitution neighbor at
Hamming distance 1..e (e ≤ 2), probing neighbors in canonical form.
Enumerating neighbors costs ~3.9k random probes per k-mer at e=2 —
8×10¹² probes for a GRCh38 build. This module inverts the enumeration
into a weighted JOIN that runs as dense elementwise compares:

  sum(u) = Σ_{w ∈ W, 1 ≤ H(w,u) ≤ e} occ(w)

where W = all distinct genome k-mers ∪ their reverse complements
(palindrome duplicates dropped) — every neighbor WORD of u that can
probe successfully is such a w, exactly once.

Pigeonhole: split the k bases into 3 contiguous parts; any pair with
H ≤ 2 agrees exactly on ≥ 1 part. For each part, group W and the
queries by the part's value into padded bucket blocks and compare every
query against its bucket's members with vectorized XOR + popcount —
dense, batched, random-access-free. A pair with m exact parts is found
by exactly the m part-joins whose bucket is intact, so each join
contributes occ·(6/m) and the total is divided by 6 (m ∈ {1,2,3} all
divide 6; m is computed per pair from the XOR itself).

Exactness under bucket overflow: buckets larger than `cpad` are
truncated, so any query whose OWN part value lands in an overflowed
bucket (for any part) is routed to the slow path
(ops.editdist.neighbor_occr_sum_packed — per-neighbor packed-table
probes); for the remaining fast queries every exact-part join of every
relevant pair is intact, because the pair's bucket in an exact part IS
the query's bucket. Differential tests assert fast+slow == brute force
on repeat-heavy genomes (tests/test_hamming_join.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from quickmer2.ops import codec


def part_ranges(k: int) -> list[tuple[int, int]]:
    """Three contiguous base ranges covering [0, k) (bit offsets are
    2x). First part takes the remainder."""
    p = k // 3
    first = k - 2 * p
    return [(0, first), (first, first + p), (first + p, k)]


def _extract_part_np(hi: np.ndarray, lo: np.ndarray, lo_base: int,
                     hi_base: int) -> np.ndarray:
    """Bits [2*lo_base, 2*hi_base) of the 2k-bit (hi,lo) code as u32
    (part width ≤ 16 bases = 32 bits; base 16 is the lo/hi word seam)."""
    a, b = 2 * lo_base, 2 * hi_base
    width = b - a
    assert width <= 32
    v = np.zeros(len(hi), np.uint64)
    full = (np.asarray(lo, np.uint64)
            | (np.asarray(hi, np.uint64) << np.uint64(32)))
    v = (full >> np.uint64(a)) & np.uint64((1 << width) - 1)
    return v.astype(np.uint32)


def _part_masks(k: int):
    """(hi_mask, lo_mask) u32 pairs for each of the 3 parts."""
    masks = []
    for (s, e) in part_ranges(k):
        a, b = 2 * s, 2 * e
        m = ((1 << b) - 1) ^ ((1 << a) - 1)
        masks.append((np.uint32((m >> 32) & 0xFFFFFFFF),
                      np.uint32(m & 0xFFFFFFFF)))
    return masks


def _part_key_device_traced(hi, lo, lo_bit, *, width: int):
    """_part_key_device with a TRACED lo_bit (u32 scalar): one compiled
    kernel serves all three parts (k=30 parts share the same width), so
    a cold run pays one jit compile instead of three."""
    lb = jnp.uint32(lo_bit)
    lbc = lb & jnp.uint32(31)
    lo_part = (lo >> lbc) | jnp.where(lbc == 0, jnp.uint32(0),
                                      hi << ((jnp.uint32(32) - lbc)
                                             & jnp.uint32(31)))
    hi_part = hi >> ((lb - jnp.uint32(32)) & jnp.uint32(31))
    v = jnp.where(lb < 32, lo_part, hi_part)
    return v & jnp.uint32((1 << width) - 1)


def _part_key_device(hi, lo, *, lo_bit: int, width: int):
    """Bits [lo_bit, lo_bit+width) of the (hi,lo) u32-pair code as u32
    (static shifts — lo_bit/width are trace-time Python ints)."""
    if lo_bit >= 32:
        v = hi >> jnp.uint32(lo_bit - 32)
    elif lo_bit + width <= 32:
        v = lo >> jnp.uint32(lo_bit)
    else:
        v = (lo >> jnp.uint32(lo_bit)) | (hi << jnp.uint32(32 - lo_bit))
    return v & jnp.uint32((1 << width) - 1)


@functools.partial(
    jax.jit, donate_argnums=(7,),
    static_argnames=("B", "cpad", "cpad_q", "slab", "e", "width",
                     "mask_hi0", "mask_lo0", "mask_hi1", "mask_lo1",
                     "mask_hi2", "mask_lo2"))
def _part_chunk_join(whi, wlo, wocc, wslot, qhi, qlo, qslot, scaled,
                     lo_bit, *, B: int, cpad: int, cpad_q: int, slab: int,
                     e: int, width: int, mask_hi0, mask_lo0,
                     mask_hi1, mask_lo1, mask_hi2, mask_lo2):
    """One (part, DB-chunk) join, fully device-resident: scatter the
    chunk's words and the queries into padded bucket layouts (keys
    recomputed on device from the codes; only 1-byte in-bucket slots
    cross to the device), then fori_loop over bucket slabs comparing every
    query lane against its bucket's word lanes with XOR+popcount.
    Accumulates occ·(6/m) into `scaled` (u32[nQ+1], donated; lane nQ is
    the trash bin). Word lanes left empty carry occ 0 and contribute
    nothing; ham >= 1 excludes self-pairs."""
    nQ = qhi.shape[0]
    hole_d = B * cpad
    hole_q = B * cpad_q
    keyw = _part_key_device_traced(whi, wlo, lo_bit,
                                   width=width).astype(jnp.int32)
    keyq = _part_key_device_traced(qhi, qlo, lo_bit,
                                   width=width).astype(jnp.int32)
    wf = jnp.where(wslot < cpad, keyw * cpad + wslot.astype(jnp.int32), hole_d)
    qf = jnp.where(qslot < cpad_q, keyq * cpad_q + qslot.astype(jnp.int32),
                   hole_q)
    dh = jnp.zeros(hole_d + 1, jnp.uint32).at[wf].set(
        whi, mode="promise_in_bounds")
    dl = jnp.zeros(hole_d + 1, jnp.uint32).at[wf].set(
        wlo, mode="promise_in_bounds")
    docc = jnp.zeros(hole_d + 1, jnp.uint32).at[wf].set(
        wocc.astype(jnp.uint32), mode="promise_in_bounds")
    docc = docc.at[hole_d].set(0)
    qh = jnp.zeros(hole_q + 1, jnp.uint32).at[qf].set(
        qhi, mode="promise_in_bounds")
    ql = jnp.zeros(hole_q + 1, jnp.uint32).at[qf].set(
        qlo, mode="promise_in_bounds")
    qidx = jnp.full(hole_q + 1, nQ, jnp.int32).at[qf].set(
        jnp.arange(nQ, dtype=jnp.int32), mode="promise_in_bounds")
    qidx = qidx.at[hole_q].set(nQ)

    def body(s, scaled):
        od = s * slab * cpad
        oq = s * slab * cpad_q
        dhs = jax.lax.dynamic_slice(dh, (od,), (slab * cpad,)).reshape(
            slab, cpad)
        dls = jax.lax.dynamic_slice(dl, (od,), (slab * cpad,)).reshape(
            slab, cpad)
        dos = jax.lax.dynamic_slice(docc, (od,), (slab * cpad,)).reshape(
            slab, cpad)
        qhs = jax.lax.dynamic_slice(qh, (oq,), (slab * cpad_q,)).reshape(
            slab, cpad_q)
        qls = jax.lax.dynamic_slice(ql, (oq,), (slab * cpad_q,)).reshape(
            slab, cpad_q)
        xh = qhs[:, :, None] ^ dhs[:, None, :]
        xl = qls[:, :, None] ^ dls[:, None, :]
        # per-base differ bits: fold each 2-bit symbol to its low lane
        yh = (xh | (xh >> 1)) & jnp.uint32(0x55555555)
        yl = (xl | (xl >> 1)) & jnp.uint32(0x55555555)
        ham = (jax.lax.population_count(yh)
               + jax.lax.population_count(yl)).astype(jnp.uint32)
        m = jnp.zeros(xh.shape, jnp.uint32)
        for mh, ml in ((mask_hi0, mask_lo0), (mask_hi1, mask_lo1),
                       (mask_hi2, mask_lo2)):
            exact = ((xh & jnp.uint32(mh)) | (xl & jnp.uint32(ml))) == 0
            m = m + exact.astype(jnp.uint32)
        ok = (ham >= 1) & (ham <= jnp.uint32(e))
        scale = jnp.where(m > 0, jnp.uint32(6) // jnp.maximum(m, 1),
                          jnp.uint32(0))
        contrib = jnp.where(ok, dos[:, None, :] * scale, jnp.uint32(0))
        out = contrib.sum(axis=2, dtype=jnp.uint32).reshape(-1)
        qix = jax.lax.dynamic_slice(qidx, (oq,), (slab * cpad_q,))
        return scaled.at[qix].add(out, mode="promise_in_bounds")

    return jax.lax.fori_loop(0, B // slab, body, scaled)


@functools.partial(
    jax.jit, donate_argnums=(7,),
    static_argnames=("B", "cpad", "cpad_q", "slab", "k", "width"))
def _part_chunk_join_bits(whi, wlo, wslot, qhi, qlo, qfwd, qslot, acc4,
                          lo_bit, *, B: int, cpad: int, cpad_q: int,
                          slab: int, k: int, width: int):
    """One (part, DB-chunk) join emitting NEIGHBOR BITS instead of sums
    (the .qai bitmap formulation — VERDICT r4 Next #6).

    For every (query window, word) pair at Hamming distance EXACTLY 1,
    the differing symbol s and the word's 2-bit value t there determine
    the substitution that turns the window into the word: with the
    query's canonical being its forward strand (qfwd), window offset
    j = k-1-s and genome-strand base b = t; on the rc strand j = s and
    b = (t-2)&3 (codec bit conventions, ops/codec.py:89-114). The pair
    proves variant(window, j, b) is a dictionary member, so bit j of
    the query's base-b plane is set. acc4: u32[nQ+1, 4] per-query bit
    planes (bit j of plane b), donated; a pair is found by every
    exact-part join that holds it, and the planes merge by OR, so the
    multi-part double-find is harmless (unlike the sums join's 6/m
    scaling). Within one call each query occupies exactly one bucket
    slot, so the scatter-add never collides."""
    nQ = qhi.shape[0]
    hole_d = B * cpad
    hole_q = B * cpad_q
    keyw = _part_key_device_traced(whi, wlo, lo_bit,
                                   width=width).astype(jnp.int32)
    keyq = _part_key_device_traced(qhi, qlo, lo_bit,
                                   width=width).astype(jnp.int32)
    wf = jnp.where(wslot < cpad, keyw * cpad + wslot.astype(jnp.int32), hole_d)
    qf = jnp.where(qslot < cpad_q, keyq * cpad_q + qslot.astype(jnp.int32),
                   hole_q)
    dh = jnp.zeros(hole_d + 1, jnp.uint32).at[wf].set(
        whi, mode="promise_in_bounds")
    dl = jnp.zeros(hole_d + 1, jnp.uint32).at[wf].set(
        wlo, mode="promise_in_bounds")
    # live-word flag: layout holes carry (0,0) which could false-match a
    # real all-A query at H=1; mask holes explicitly
    dlive = jnp.zeros(hole_d + 1, jnp.uint32).at[wf].set(
        jnp.uint32(1), mode="promise_in_bounds")
    dlive = dlive.at[hole_d].set(0)
    qh = jnp.zeros(hole_q + 1, jnp.uint32).at[qf].set(
        qhi, mode="promise_in_bounds")
    ql = jnp.zeros(hole_q + 1, jnp.uint32).at[qf].set(
        qlo, mode="promise_in_bounds")
    qfw = jnp.zeros(hole_q + 1, jnp.uint32).at[qf].set(
        qfwd.astype(jnp.uint32), mode="promise_in_bounds")
    qidx = jnp.full(hole_q + 1, nQ, jnp.int32).at[qf].set(
        jnp.arange(nQ, dtype=jnp.int32), mode="promise_in_bounds")
    qidx = qidx.at[hole_q].set(nQ)

    def body(s_i, acc4):
        od = s_i * slab * cpad
        oq = s_i * slab * cpad_q
        dhs = jax.lax.dynamic_slice(dh, (od,), (slab * cpad,)).reshape(
            slab, cpad)
        dls = jax.lax.dynamic_slice(dl, (od,), (slab * cpad,)).reshape(
            slab, cpad)
        dvs = jax.lax.dynamic_slice(dlive, (od,), (slab * cpad,)).reshape(
            slab, cpad)
        qhs = jax.lax.dynamic_slice(qh, (oq,), (slab * cpad_q,)).reshape(
            slab, cpad_q)
        qls = jax.lax.dynamic_slice(ql, (oq,), (slab * cpad_q,)).reshape(
            slab, cpad_q)
        qfs = jax.lax.dynamic_slice(qfw, (oq,), (slab * cpad_q,)).reshape(
            slab, cpad_q)
        xh = qhs[:, :, None] ^ dhs[:, None, :]
        xl = qls[:, :, None] ^ dls[:, None, :]
        yh = (xh | (xh >> 1)) & jnp.uint32(0x55555555)
        yl = (xl | (xl >> 1)) & jnp.uint32(0x55555555)
        ham = (jax.lax.population_count(yh)
               + jax.lax.population_count(yl)).astype(jnp.uint32)
        ok = (ham == 1) & (dvs[:, None, :] != 0)
        # the single differ symbol s: ctz of the one-hot y via
        # popcount(y-1) (bit position), /2 → symbol within the word,
        # +16 when it sits in the hi word
        in_lo = yl != 0
        ylo1 = jax.lax.population_count(yl - 1) >> 1
        yhi1 = (jax.lax.population_count(yh - 1) >> 1) + jnp.uint32(16)
        s_sym = jnp.where(in_lo, ylo1, yhi1).astype(jnp.uint32)
        # word's 2-bit value t at symbol s (per-lane variable shift)
        sh = (s_sym & jnp.uint32(15)) << 1      # clamped lane shifts
        t = jnp.where(in_lo, dls[:, None, :] >> sh,
                      dhs[:, None, :] >> sh) & jnp.uint32(3)
        fwd = qfs[:, :, None] != 0
        j = jnp.where(fwd, jnp.uint32(k - 1) - s_sym, s_sym) & jnp.uint32(31)
        b = jnp.where(fwd, t, (t - jnp.uint32(2)) & jnp.uint32(3))
        jbit = jnp.where(ok, jnp.uint32(1) << j, jnp.uint32(0))
        # distinct symbols → distinct j bits per (query, plane) row, and
        # the DB holds no duplicate words, so a sum over the bucket axis
        # never carries — it equals the OR
        planes = []
        for bb in range(4):
            planes.append(jnp.sum(
                jnp.where(b == bb, jbit, jnp.uint32(0)), axis=2,
                dtype=jnp.uint32))
        vals = jnp.stack(planes, axis=-1).reshape(-1, 4)
        qix = jax.lax.dynamic_slice(qidx, (oq,), (slab * cpad_q,))
        return acc4.at[qix].add(vals, mode="promise_in_bounds")

    return jax.lax.fori_loop(0, B // slab, body, acc4)


def _slots_u8(keys: np.ndarray) -> np.ndarray:
    """Per-entry in-bucket slot (rank among equal keys), in ORIGINAL
    entry order, saturated to u8 — the only per-part array that crosses
    to the device (the device recomputes bucket keys from the codes)."""
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    first = np.ones(len(ks), bool)
    first[1:] = ks[1:] != ks[:-1]
    start = np.maximum.accumulate(np.where(first, np.arange(len(ks)), 0))
    slot_sorted = np.arange(len(ks)) - start
    slot = np.empty(len(ks), np.int64)
    slot[order] = slot_sorted
    return np.minimum(slot, 255).astype(np.uint8)


def hamming_neighbor_sums(unique_kmers: np.ndarray, uniq: np.ndarray,
                          occ: np.ndarray, k: int, e: int,
                          cpad: int = 64, cpad_q: int = 32,
                          chunk_w: int = 12_000_000,
                          chunk_q: int = 4_000_000,
                          slab_buckets: int | None = None,
                          packed_rows=None, n_buckets_packed: int = 0,
                          batch_slow: int = 16384,
                          escalate: int = 0,
                          escalate_min: int = 1024) -> np.ndarray:
    """Neighbor-occurrence sums for `unique_kmers` (queries) against the
    distinct-genome-k-mer multiset (`uniq` canonical u64, `occ` u8/u32
    saturated counts). Exact: identical to brute-force enumeration.

    Execution is device-resident: the word/query codes cross to the
    device once, per-(part, chunk) only 1-byte in-bucket slot arrays follow,
    and the slab loop runs inside one jit (the earlier host-orchestrated
    slab loop re-uploaded every bucket block — ~5.6 GB of transfers for
    an 8 Mb genome). The DB is processed in chunks of `chunk_w` words so
    per-bucket loads stay under `cpad` at any genome size (a pair is
    found in exactly the chunk holding its word, so chunk sums add).

    packed_rows / n_buckets_packed: the packed table over `uniq` with
    occ in the pos payload, used for slow-path queries (overflowed
    buckets); built by the caller (pipelines.search already has it).
    """
    from quickmer2.ops.editdist import edit_table, neighbor_occr_sum_packed
    from quickmer2.ops.packed_table import PackedTable

    assert 1 <= e <= 2
    n = len(unique_kmers)
    if n == 0:
        return np.zeros(0, np.uint32)
    if cpad == 64 and len(uniq) > 20_000_000:
        # repeat-family bucket loads scale with W: at chr21+ scales the
        # cpad-64 overflow routed a slow set large enough to grind ~50
        # minutes of per-neighbor probes (a 40 Mb attempt). Wider pads
        # quadruple the compare volume per bucket (still elementwise
        # work) and shrink the slow set instead;
        # exactness is pad-independent.
        cpad, cpad_q = 128, 64
    assert cpad <= 255 and cpad_q <= 255   # in-bucket slots travel as u8

    # database W = [uniq, rc(uniq)] (static 2n shape), palindromic rc
    # lanes DEAD via slot 255 — the device rebuilds the rc half from
    # the uniq codes (_build_w_device), so only 8 B/distinct + 1 B occ
    # cross to the device instead of ~16 B + occ for both halves
    rc_db = _rc_np(uniq, k)
    pal = rc_db == uniq
    w = np.concatenate([uniq, rc_db])
    w_live = np.concatenate([np.ones(len(uniq), bool), ~pal])
    whi, wlo = codec.split_u64(w)
    qhi, qlo = codec.split_u64(np.asarray(unique_kmers, np.uint64))

    ranges = part_ranges(k)
    masks = _part_masks(k)
    mask_kw = {"mask_hi0": int(masks[0][0]), "mask_lo0": int(masks[0][1]),
               "mask_hi1": int(masks[1][0]), "mask_lo1": int(masks[1][1]),
               "mask_hi2": int(masks[2][0]), "mask_lo2": int(masks[2][1])}

    part_keys_w = [_extract_part_np(whi, wlo, s, t) for (s, t) in ranges]
    part_keys_q = [_extract_part_np(qhi, qlo, s, t) for (s, t) in ranges]
    n_bkts = [1 << (2 * (t - s)) for (s, t) in ranges]

    chunks = [slice(c0, min(c0 + chunk_w, len(w)))
              for c0 in range(0, max(len(w), 1), chunk_w)]

    # slow-path routing, stage 1 (word side): a query is slow when any
    # part's word bucket in any chunk overflows cpad (its pairs there
    # would be dropped). The overflowed-bucket set unions over chunks
    # FIRST, then all queries route with ONE gather per part:
    # O(3·(W + n + buckets)) total, flat in chunk count (the round-3
    # version gathered per (part x chunk) — ~10^12 host ops at GRCh38
    # scale, VERDICT r3 Weak #3 / Next #7).
    slow = np.zeros(n, bool)
    for i in range(3):
        over_w = np.zeros(n_bkts[i], bool)
        for c in chunks:
            hw = np.bincount(part_keys_w[i][c][w_live[c]],
                             minlength=n_bkts[i])
            over_w |= hw > cpad
        slow |= over_w[part_keys_q[i]]
    # stage 2 (query side): queries process in CHUNKS of chunk_q, and
    # the cpad_q overflow condition applies within each chunk — without
    # this, any genome past ~cpad_q * 4^(k/3) distinct k-mers (~34 Mb
    # at k=30) saturates every query bucket and routes EVERYTHING to
    # the slow path (the round-3 40 Mb failure mode: ~30M x 4k slow
    # probes + an HBM blowup). Pair coverage is unaffected: a pair is
    # found by the (query-chunk, word-chunk) cell holding both ends.
    fast_idx_all = np.flatnonzero(~slow)
    sums = np.zeros(n, np.uint64)

    if len(fast_idx_all):
        uhi, ulo = codec.split_u64(uniq)
        whi_d, wlo_d = _build_w_device(jnp.asarray(uhi), jnp.asarray(ulo),
                                       k=k)
        occ_d = jnp.asarray(np.asarray(occ, np.uint8))
        wocc_d = jnp.concatenate([occ_d, occ_d])
        wslots = {}

        def w_slots(i: int, ci: int) -> np.ndarray:
            if (i, ci) not in wslots:
                c = chunks[ci]
                live = w_live[c]
                s8 = np.full(c.stop - c.start, 255, np.uint8)
                s8[live] = _slots_u8(part_keys_w[i][c][live])
                wslots[(i, ci)] = s8
            return wslots[(i, ci)]
        for qc0 in range(0, len(fast_idx_all), chunk_q):
            qsel = fast_idx_all[qc0: qc0 + chunk_q]
            chunk_slow = np.zeros(len(qsel), bool)
            for i in range(3):
                hq = np.bincount(part_keys_q[i][qsel],
                                 minlength=n_bkts[i])
                chunk_slow |= hq[part_keys_q[i][qsel]] > cpad_q
            slow[qsel[chunk_slow]] = True
            qsel = qsel[~chunk_slow]
            if len(qsel) == 0:
                continue
            # bounded pad shapes: full chunks pad to chunk_q (one jit
            # compile per cpad level, not one per data-dependent chunk
            # length — each compile costs seconds); small runs and
            # tails pad to a power of two so tiny inputs stay tiny.
            # Pad lanes carry slot 255 -> layout hole -> contribute 0.
            n_q = len(qsel)
            npad = (chunk_q if n_q > chunk_q // 2
                    else 1 << max(14, (n_q - 1).bit_length()))

            def _padq(a, fill=0):
                out = np.full(npad, fill, a.dtype)
                out[:n_q] = a
                return jnp.asarray(out)

            fqh_d = _padq(qhi[qsel])
            fql_d = _padq(qlo[qsel])
            scaled_d = jnp.zeros(npad + 1, jnp.uint32)
            for i, (s, t) in enumerate(ranges):
                B = n_bkts[i]
                cq = min(cpad_q, cpad)
                slab = slab_buckets or max(
                    1, min(B, (1 << 22) // (cpad * cq)))
                while B % slab:
                    slab >>= 1
                qslot_d = _padq(_slots_u8(part_keys_q[i][qsel]),
                                fill=np.uint8(255))
                for ci, c in enumerate(chunks):
                    scaled_d = _part_chunk_join(
                        whi_d[c], wlo_d[c], wocc_d[c],
                        jnp.asarray(w_slots(i, ci)),
                        fqh_d, fql_d, qslot_d, scaled_d,
                        jnp.uint32(2 * s),
                        B=B, cpad=cpad, cpad_q=cq, slab=slab, e=e,
                        width=2 * (t - s), **mask_kw)
            scaled = np.asarray(jax.device_get(scaled_d)).astype(np.uint64)
            part_sums, rem = divmod(scaled[:n_q], 6)
            assert not rem.any(), "hamming join scale invariant violated"
            sums[qsel] = part_sums
            del fqh_d, fql_d, scaled_d
        del whi_d, wlo_d, wocc_d   # free before the slow-path table

    slow_idx = np.flatnonzero(slow)
    # escalation (OFF by default): the 240-wide re-join's B*240-lane
    # layouts are large and compiled per new shape (a 40 Mb rehearsal
    # stalled in exactly this compile; the bits-join A/B measured the
    # same formulation 2x slower than its alternatives). The slow path below routes
    # through the caller's packed table (device per-neighbor probes)
    # or host searchsorted enumeration — both measured and bounded.
    if len(slow_idx) > escalate_min and escalate > 0 and cpad < 240:
        sums[slow_idx] = hamming_neighbor_sums(
            np.asarray(unique_kmers, np.uint64)[slow_idx], uniq, occ, k, e,
            cpad=240, cpad_q=240, chunk_w=chunk_w, chunk_q=chunk_q,
            packed_rows=packed_rows, n_buckets_packed=n_buckets_packed,
            batch_slow=batch_slow, escalate=escalate - 1,
            escalate_min=escalate_min)
        return np.minimum(sums, np.iinfo(np.uint32).max).astype(np.uint32)
    if len(slow_idx):
        if packed_rows is not None:
            # caller-supplied device table: per-neighbor packed probes
            p1, d1, p2, d2 = (jnp.asarray(a) for a in edit_table(k, e))
            sq = np.asarray(unique_kmers, np.uint64)[slow_idx]
            rc_q = _rc_np(sq, k)
            for off in range(0, len(sq), batch_slow):
                sl = slice(off, min(off + batch_slow, len(sq)))
                kh, kl = codec.split_u64(sq[sl])
                rh, rl = codec.split_u64(rc_q[sl])
                pad = batch_slow - (sl.stop - sl.start)
                if pad:
                    kh, kl, rh, rl = (np.pad(a, (0, pad))
                                      for a in (kh, kl, rh, rl))
                out = neighbor_occr_sum_packed(
                    jnp.asarray(kh), jnp.asarray(kl), jnp.asarray(rh),
                    jnp.asarray(rl), packed_rows, p1, d1, p2, d2,
                    k=k, n_buckets=n_buckets_packed)
                sums[slow_idx[sl]] = np.asarray(out)[: sl.stop - sl.start]
        else:
            # host path: enumerate neighbors vectorized and binary-search
            # the SORTED distinct array (np.unique output) — no device
            # table build (a GRCh38-scale table is GBs and the compiler
            # rejected the resulting program; the slow set is
            # small after query chunking, so O(slow * 4k * log W) host
            # work is cheap)
            sq = np.asarray(unique_kmers, np.uint64)[slow_idx]
            sums[slow_idx] = _slow_sums_sorted_np(sq, uniq, occ, k, e)

    return np.minimum(sums, np.iinfo(np.uint32).max).astype(np.uint32)


@jax.jit
def _or_planes(a, b):
    return a | b


@functools.partial(jax.jit, static_argnames=("k",))
def _build_w_device(dhi, dlo, *, k: int):
    """Word-side device arrays [dict, rc(dict)] — only the dict codes
    cross to the device; the rc half is computed there (_rc_device).
    Palindromic rc duplicates are excluded by host-side slot 255."""
    rh, rl = _rc_device(dhi, dlo, k=k)
    return jnp.concatenate([dhi, rh]), jnp.concatenate([dlo, rl])


@jax.jit
def _plane_mask(acc4):
    """Packed nonzero-row bitmask of the per-query planes — crosses to
    the host at 1 bit/window instead of 16 B/window; the (rare) hot rows
    are then gathered by index (_plane_gather)."""
    return jnp.packbits((acc4 != 0).any(axis=1))


@jax.jit
def _plane_gather(acc4, idx):
    return acc4[idx]


def _fetch_hot_planes(acc_or, n_rows: int):
    """(hot_row_indices, their plane rows) via the compacted two-step
    fetch; ~1%o of windows are hot, so this replaces a 16 B/window D2H
    with ~0.13 B/window + the hot rows."""
    mask = np.unpackbits(np.asarray(jax.device_get(_plane_mask(acc_or))))
    hot = np.flatnonzero(mask[:n_rows]).astype(np.int64)
    if len(hot) == 0:
        return hot, np.zeros((0, 4), np.uint32)
    npad = 1 << max(10, (len(hot) - 1).bit_length())
    idx = np.zeros(npad, np.int32)
    idx[: len(hot)] = hot
    rows = np.asarray(jax.device_get(_plane_gather(acc_or,
                                                   jnp.asarray(idx))))
    return hot, rows[: len(hot)]


def hamming_neighbor_bits(genome_codes: np.ndarray, dict_kmers: np.ndarray,
                          k: int, cpad: int = 64, cpad_q: int = 32,
                          chunk_w: int = 12_000_000,
                          chunk_q: int = 2_000_000,
                          escalate: bool = True,
                          escalate_min: int = 50_000) -> np.ndarray:
    """Neighbor-hit bitmap of the genome against the dictionary as a
    HAMMING JOIN (VERDICT r4 Next #6) — same output as
    ops.anchored.build_neighbor_bits: u8[G], bit b of byte e set iff
    substituting base b at position e inside any valid window yields a
    canonical k-mer in the dictionary.

    The probe formulation pays 3k packed-table probes per genome base
    (~180 random gathers); this joins the genome windows against the
    dictionary at Hamming distance exactly 1 with dense compares —
    each H=1 pair identifies its substitution (position, base) from the
    XOR, accumulated as per-query bit planes and smeared onto genome
    positions. Exact: differential-tested against the probe builder.

    Transfer-lean by construction: queries ride as FIXED contiguous
    window tiles —
    the genome codes cross at 1 B/base and the canonical pairs/strand
    flags are recomputed on device (one small jit); only the 1-byte
    in-bucket slots (3 parts) follow. Host kmerization uses the native
    C qm2_sliding_canon (~100x numpy). Windows in overflowed buckets
    (repeat tracts) enumerate their 3k variants on the host against
    the sorted dictionary; the 240-wide re-join escalation exists but
    is OFF by default (measured 2x slower than host enumeration on a
    realistic 8.8 Mb genome)."""
    import jax.numpy as jnp

    G = len(genome_codes)
    nb = np.zeros(G, np.uint8)
    if G < k or len(dict_kmers) == 0:
        return nb
    dict_kmers = np.asarray(dict_kmers, np.uint64)
    rc_db = _rc_np(dict_kmers, k)
    pal = rc_db == dict_kmers
    # W order = [dict, rc(dict)] with palindromic rc lanes DEAD (slot
    # 255): a static 2n shape the device can rebuild from the dict
    # codes alone — the rc half never crosses to the device
    w = np.concatenate([dict_kmers, rc_db])
    w_live = np.concatenate([np.ones(len(dict_kmers), bool), ~pal])
    whi, wlo = codec.split_u64(w)

    ranges = part_ranges(k)
    n_bkts = [1 << (2 * (t - s)) for (s, t) in ranges]
    part_keys_w = [_extract_part_np(whi, wlo, s, t) for (s, t) in ranges]
    chunks = [slice(c0, min(c0 + chunk_w, len(w)))
              for c0 in range(0, max(len(w), 1), chunk_w)]
    over_w_by_cp: dict = {}

    def over_w(cp: int, i: int) -> np.ndarray:
        if (cp, i) not in over_w_by_cp:
            ov = np.zeros(n_bkts[i], bool)
            for c in chunks:
                hw = np.bincount(part_keys_w[i][c][w_live[c]],
                                 minlength=n_bkts[i])
                ov |= hw > cp
            over_w_by_cp[(cp, i)] = ov
        return over_w_by_cp[(cp, i)]

    dhi, dlo = codec.split_u64(dict_kmers)
    whi_d, wlo_d = _build_w_device(jnp.asarray(dhi), jnp.asarray(dlo), k=k)
    wslots: dict = {}

    def w_slots(cp: int, i: int, ci: int) -> np.ndarray:
        if (cp, i, ci) not in wslots:
            c = chunks[ci]
            live = w_live[c]
            s8 = np.full(c.stop - c.start, 255, np.uint8)
            s8[live] = _slots_u8(part_keys_w[i][c][live])
            wslots[(cp, i, ci)] = s8
        return wslots[(cp, i, ci)]

    def _host_canon(codes):
        from quickmer2.utils import native
        if native.available():
            return native.sliding_canon(codes, k)
        fwd, rc, valid = codec.sliding_fwd_rc_np(codes, k)
        return np.minimum(fwd, rc), valid, fwd <= rc

    def join_tiles(cp: int, cpq: int):
        """Main pass: fixed contiguous window tiles of chunk_q; codes
        cross to the device at 1 B/base, canonical pairs + strand flags are
        derived on device. Returns (gsel, canon, is_fwd) of windows
        left to the next stage."""
        slow_parts = []
        slab = max(1, min(min(n_bkts), (1 << 22) // (cp * cpq)))
        for t0 in range(0, G - k + 1, chunk_q):
            seg = genome_codes[t0: t0 + chunk_q + k - 1]
            pad = chunk_q + k - 1 - len(seg)
            if pad:
                seg = np.concatenate(
                    [seg, np.full(pad, codec.SEP, np.uint8)])
            canon, valid, is_fwd = _host_canon(seg)
            chi, clo = codec.split_u64(canon)
            part_keys_q = [_extract_part_np(chi, clo, s, t)
                           for (s, t) in ranges]
            slow = np.zeros(chunk_q, bool)
            for i in range(3):
                slow |= over_w(cp, i)[part_keys_q[i]]
            active = valid & ~slow
            # per-tile query bucket overflow among ACTIVE windows
            for i in range(3):
                hq = np.bincount(part_keys_q[i][active],
                                 minlength=n_bkts[i])
                over_q = hq[part_keys_q[i]] > cpq
                slow |= over_q & active
                active &= ~over_q
            seg_d = jnp.asarray(seg)
            chi_d, clo_d, fwd_d = _device_kmerize(seg_d, k=k)
            acc_or = jnp.zeros((chunk_q, 4), jnp.uint32)
            for i, (s, t) in enumerate(ranges):
                B = n_bkts[i]
                sl = slab
                while B % sl:
                    sl >>= 1
                qslot = np.full(chunk_q, 255, np.uint8)
                qslot[active] = _slots_u8(part_keys_q[i][active])
                qslot_d = jnp.asarray(qslot)
                for ci, c in enumerate(chunks):
                    fresh = _part_chunk_join_bits(
                        whi_d[c], wlo_d[c], jnp.asarray(w_slots(cp, i, ci)),
                        chi_d, clo_d, fwd_d, qslot_d,
                        jnp.zeros((chunk_q + 1, 4), jnp.uint32),
                        jnp.uint32(2 * s),
                        B=B, cpad=cp, cpad_q=cpq, slab=sl, k=k,
                        width=2 * (t - s))
                    acc_or = _or_planes(acc_or, fresh[:-1])
            hot, rows = _fetch_hot_planes(acc_or, chunk_q)
            _smear_planes(nb, t0 + hot, rows, k)
            leftover = valid & slow
            if leftover.any():
                li = np.flatnonzero(leftover)
                slow_parts.append((t0 + li.astype(np.int64), canon[li],
                                   is_fwd[li]))
            del seg_d, chi_d, clo_d, fwd_d, acc_or
        return slow_parts

    def run_gathered(gsel, canon, is_fwd, cp: int, cpq: int) -> np.ndarray:
        """Escalation pass over a GATHERED (non-contiguous) window set:
        canonical pairs upload directly. Returns the still-unresolved
        mask; resolved windows' bits OR into nb."""
        s_qhi, s_qlo = codec.split_u64(canon)
        part_keys_q = [_extract_part_np(s_qhi, s_qlo, s, t)
                       for (s, t) in ranges]
        slow = np.zeros(len(gsel), bool)
        for i in range(3):
            slow |= over_w(cp, i)[part_keys_q[i]]
        fast_pos = np.flatnonzero(~slow)
        for qc0 in range(0, len(fast_pos), chunk_q):
            qpos = fast_pos[qc0: qc0 + chunk_q]
            chunk_slow = np.zeros(len(qpos), bool)
            for i in range(3):
                hq = np.bincount(part_keys_q[i][qpos], minlength=n_bkts[i])
                chunk_slow |= hq[part_keys_q[i][qpos]] > cpq
            slow[qpos[chunk_slow]] = True
            qpos = qpos[~chunk_slow]
            if len(qpos) == 0:
                continue
            n_q = len(qpos)
            npad = (chunk_q if n_q > chunk_q // 2
                    else 1 << max(14, (n_q - 1).bit_length()))

            def _padq(a, fill=0):
                out = np.full(npad, fill, a.dtype)
                out[:n_q] = a
                return jnp.asarray(out)

            fqh_d = _padq(s_qhi[qpos])
            fql_d = _padq(s_qlo[qpos])
            ffw_d = _padq(is_fwd[qpos])
            acc_or = jnp.zeros((npad, 4), jnp.uint32)
            for i, (s, t) in enumerate(ranges):
                B = n_bkts[i]
                sl = max(1, min(B, (1 << 22) // (cp * cpq)))
                while B % sl:
                    sl >>= 1
                qslot_d = _padq(_slots_u8(part_keys_q[i][qpos]),
                                fill=np.uint8(255))
                for ci, c in enumerate(chunks):
                    fresh = _part_chunk_join_bits(
                        whi_d[c], wlo_d[c], jnp.asarray(w_slots(cp, i, ci)),
                        fqh_d, fql_d, ffw_d, qslot_d,
                        jnp.zeros((npad + 1, 4), jnp.uint32),
                        jnp.uint32(2 * s),
                        B=B, cpad=cp, cpad_q=cpq, slab=sl, k=k,
                        width=2 * (t - s))
                    acc_or = _or_planes(acc_or, fresh[:-1])
            hot, rows = _fetch_hot_planes(acc_or, n_q)
            _smear_planes(nb, gsel[qpos[hot]], rows, k)
            del fqh_d, fql_d, ffw_d, acc_or
        return slow

    slow_parts = join_tiles(cpad, cpad_q)
    if slow_parts:
        gsel = np.concatenate([p[0] for p in slow_parts])
        canon = np.concatenate([p[1] for p in slow_parts])
        is_fwd = np.concatenate([p[2] for p in slow_parts])
        still = np.ones(len(gsel), bool)
        # the 240-wide re-join costs its own jit compiles and large
        # layouts: only worth it when the host enumeration of the slow
        # set would be slower (~90 searchsorted probes per window)
        if escalate and cpad < 240 and len(gsel) > escalate_min:
            still = run_gathered(gsel, canon, is_fwd, 240, 240)
        if still.any():
            other = _rc_np(canon[still], k)
            fwd_q = np.where(is_fwd[still], canon[still], other)
            rc_q = np.where(is_fwd[still], other, canon[still])
            _slow_bits_np(nb, gsel[still], fwd_q, rc_q,
                          np.sort(dict_kmers), k)
    return nb


def _rev2bit32(x):
    """Reverse the 16 2-bit symbols of a u32 (log-step swaps)."""
    x = ((x & jnp.uint32(0x33333333)) << 2) | ((x >> 2) & jnp.uint32(0x33333333))
    x = ((x & jnp.uint32(0x0F0F0F0F)) << 4) | ((x >> 4) & jnp.uint32(0x0F0F0F0F))
    x = ((x & jnp.uint32(0x00FF00FF)) << 8) | ((x >> 8) & jnp.uint32(0x00FF00FF))
    return (x << 16) | (x >> 16)


def _rc_device(hi, lo, *, k: int):
    """Exact reverse complement of 2k-bit codes as u32 pairs on device:
    complement = per-symbol XOR 0b10, then reverse the 32 symbols of
    the u64 and realign to the low 2k bits. Matches _rc_np bit-for-bit
    (complement (c-2)&3 == c^2 for 2-bit codes)."""
    two_k = 2 * k
    hi_bits = max(two_k - 32, 0)
    ch = hi ^ jnp.uint32(0xAAAAAAAA & ((1 << hi_bits) - 1))
    cl = lo ^ jnp.uint32(0xAAAAAAAA & ((1 << min(two_k, 32)) - 1))
    rhi = _rev2bit32(cl)
    rlo = _rev2bit32(ch)
    sh = 64 - two_k
    if sh == 0:
        return rhi, rlo
    if sh < 32:
        return rhi >> sh, (rlo >> sh) | (rhi << (32 - sh))
    return jnp.zeros_like(rhi), rhi >> (sh - 32)


@functools.partial(jax.jit, static_argnames=("k",))
def _device_kmerize(codes, *, k: int):
    """chi/clo/is_fwd of every window of a code tile, on device — the
    join consumes these without the 8 B/window canonical-pair upload."""
    fhi, flo, rhi, rlo, _valid = codec.sliding_fwd_rc(codes, k)
    fwd_less = (fhi < rhi) | ((fhi == rhi) & (flo <= rlo))
    chi = jnp.where(fwd_less, fhi, rhi)
    clo = jnp.where(fwd_less, flo, rlo)
    return chi, clo, fwd_less



def _smear_planes(nb: np.ndarray, qsel: np.ndarray, planes: np.ndarray,
                  k: int) -> None:
    """OR per-window bit planes (u32[n,4], bit j of plane b = hit at
    window offset j, base b) onto genome positions: nb[o+j] |= 1<<b."""
    hot = np.flatnonzero(planes.any(axis=1))    # neighbor hits are rare
    if len(hot) == 0:
        return
    pl = planes[hot]
    osel = qsel[hot]
    for j in range(k):
        bits = ((pl >> np.uint32(j)) & 1).astype(np.uint8)
        byte = (bits[:, 0] | (bits[:, 1] << 1) | (bits[:, 2] << 2)
                | (bits[:, 3] << 3))
        nz = np.flatnonzero(byte)
        if len(nz):
            np.bitwise_or.at(nb, osel[nz] + j, byte[nz])


def _slow_bits_np(nb: np.ndarray, o_idx: np.ndarray, fwd: np.ndarray,
                  rc: np.ndarray, sorted_dict: np.ndarray, k: int,
                  batch: int = 4096) -> None:
    """Host fallback for overflow windows: enumerate all 3k single
    substitutions, canonicalize, membership by searchsorted into the
    sorted dictionary, OR hits into nb. Same enumeration semantics as
    the probe builder (ops.anchored._neighbor_bits_kernel)."""
    for off in range(0, len(o_idx), batch):
        sl = slice(off, off + batch)
        f = fwd[sl]
        r = rc[sl]
        o = o_idx[sl]
        for j in range(k):
            sh_f = np.uint64(2 * (k - 1 - j))
            sh_r = np.uint64(2 * j)
            orig = (f >> sh_f) & np.uint64(3)
            for d in (1, 2, 3):
                b = (orig + np.uint64(d)) & np.uint64(3)
                x = orig ^ b
                mf = f ^ (x << sh_f)
                mr = r ^ (x << sh_r)
                canon = np.minimum(mf, mr)
                idx = np.searchsorted(sorted_dict, canon)
                inb = idx < len(sorted_dict)
                idc = np.minimum(idx, len(sorted_dict) - 1)
                hit = inb & (sorted_dict[idc] == canon)
                if hit.any():
                    np.bitwise_or.at(
                        nb, o[hit] + j,
                        (np.uint8(1) << b[hit].astype(np.uint8)))


def _slow_sums_sorted_np(queries: np.ndarray, uniq_sorted: np.ndarray,
                         occ: np.ndarray, k: int, e: int,
                         batch: int = 512) -> np.ndarray:
    """Neighbor-occurrence sums by vectorized enumeration + searchsorted
    into the sorted distinct array. Exact-math semantics identical to
    the device filter (edit_table enumeration, canonical min)."""
    from quickmer2.ops.editdist import edit_table
    p1, d1, p2, d2 = edit_table(k, e)
    p1 = p1.astype(np.uint64)[None, :]
    d1 = d1.astype(np.uint64)[None, :]
    p2m = np.maximum(p2, 0).astype(np.uint64)[None, :]
    d2m = (d2 * (p2 >= 0)).astype(np.uint64)[None, :]   # delta 0 = no-op
    occ64 = np.asarray(occ, np.uint64)
    out = np.zeros(len(queries), np.uint64)
    rc_all = _rc_np(queries, k)

    def mutate(f, r, pos, delta):
        base = (f >> (np.uint64(2) * pos)) & np.uint64(3)
        nb = (base + delta) & np.uint64(3)
        x = base ^ nb
        f = f ^ (x << (np.uint64(2) * pos))
        r = r ^ (x << (np.uint64(2) * (np.uint64(k - 1) - pos)))
        return f, r

    for off in range(0, len(queries), batch):
        f = queries[off: off + batch, None]
        r = rc_all[off: off + batch, None]
        f1, r1 = mutate(f, r, p1, d1)
        f2, r2 = mutate(f1, r1, p2m, d2m)
        canon = np.minimum(f2, r2)
        idx = np.searchsorted(uniq_sorted, canon)
        inb = idx < len(uniq_sorted)
        idc = np.minimum(idx, len(uniq_sorted) - 1)
        hit = inb & (uniq_sorted[idc] == canon)
        out[off: off + batch] = np.sum(
            np.where(hit, occ64[idc], np.uint64(0)), axis=1)
    return out


def _rc_np(kmers: np.ndarray, k: int) -> np.ndarray:
    rc = np.zeros_like(kmers)
    tmp = np.asarray(kmers, np.uint64).copy()
    for _ in range(k):
        rc = (rc << np.uint64(2)) | ((tmp - np.uint64(2)) & np.uint64(3))
        tmp >>= np.uint64(2)
    return rc & np.uint64((1 << (2 * k)) - 1)
