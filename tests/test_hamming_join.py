"""Blocked Hamming join edit filter vs brute-force neighbor sums.

The join must be EXACT (identical sums) on repeat-heavy genomes that
force bucket overflow and thus exercise the fast/slow split."""

import numpy as np
import pytest

from quickmer2.ops import codec
from quickmer2.ops.hamming_join import (
    hamming_neighbor_sums, part_ranges)
from tests import helpers


def brute_sums(targets, cmap, k, e):
    out = []
    for km in targets:
        total = 0
        for p1 in range(k):
            b1 = (km >> (2 * p1)) & 3
            for v1 in (1, 2, 3):
                n1 = km ^ ((b1 ^ ((b1 + v1) & 3)) << (2 * p1))
                c1 = min(codec.revcomp_code(n1, k), n1)
                total += cmap.get(c1, 0)
                if e >= 2:
                    for p2 in range(p1):
                        b2 = (n1 >> (2 * p2)) & 3
                        for v2 in (1, 2, 3):
                            n2 = n1 ^ ((b2 ^ ((b2 + v2) & 3)) << (2 * p2))
                            c2 = min(codec.revcomp_code(n2, k), n2)
                            total += cmap.get(c2, 0)
        out.append(total)
    return np.array(out, np.uint32)


def _world(rng, k, n_bases, low_complexity=False):
    seq = helpers.random_genome(rng, n_bases)
    mutated = list(seq)
    for pos in rng.integers(0, len(seq), size=n_bases // 40):
        mutated[pos] = "ACGT"[rng.integers(0, 4)]
    genome = seq + "".join(mutated)
    if low_complexity:
        # poly-A / dinucleotide tracts overflow part buckets on purpose
        genome += "A" * 300 + "ACACACACAC" * 40 + helpers.random_genome(rng, 200)
    codes = codec.encode_bases(genome.encode())
    canon, valid = codec.sliding_kmers_np(codes, k)
    kmers = canon[valid & (canon != 0)]
    uniq, counts = np.unique(kmers, return_counts=True)
    occ = np.minimum(counts, 255).astype(np.uint8)
    cmap = dict(zip(uniq.tolist(), occ.astype(int).tolist()))
    return uniq, occ, cmap


@pytest.mark.parametrize("k,e", [(15, 1), (15, 2), (30, 2)])
def test_join_matches_bruteforce(rng, k, e):
    uniq, occ, cmap = _world(rng, k, 2500)
    targets = uniq[occ == 1][:300]
    want = brute_sums(targets.tolist(), cmap, k, e)
    got = hamming_neighbor_sums(targets, uniq, occ, k, e, cpad=8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("chunk_q", [64, 177])
def test_join_query_chunking_exact(rng, chunk_q):
    """Query-side chunking (the >34 Mb saturation fix) must not change
    any sum — pairs are covered once per (query-chunk, word-chunk)
    cell; also forces multiple word chunks."""
    k, e = 15, 2
    uniq, occ, cmap = _world(rng, k, 2500)
    targets = uniq[occ == 1][:300]
    want = brute_sums(targets.tolist(), cmap, k, e)
    got = hamming_neighbor_sums(targets, uniq, occ, k, e, cpad=8,
                                chunk_q=chunk_q, chunk_w=1000)
    np.testing.assert_array_equal(got, want)


def test_join_overflow_slow_path(rng):
    """Low-complexity tracts overflow the part buckets; affected queries
    must take the slow path and still be exact."""
    k = 15
    uniq, occ, cmap = _world(rng, k, 1500, low_complexity=True)
    targets = uniq[occ == 1][:400]
    want = brute_sums(targets.tolist(), cmap, k, e := 2)
    # tiny cpad forces a substantial slow set
    got = hamming_neighbor_sums(targets, uniq, occ, k, e, cpad=4)
    np.testing.assert_array_equal(got, want)
    # same, but the slow set must go through the ESCALATED join round
    # (cpad 240) instead of enumeration — still exact
    got2 = hamming_neighbor_sums(targets, uniq, occ, k, e, cpad=4,
                                 escalate_min=1)
    np.testing.assert_array_equal(got2, want)
    # sanity: overflow actually happened at this cpad
    from quickmer2.ops.hamming_join import _extract_part_np
    whi, wlo = codec.split_u64(uniq)
    overflowed = False
    for (s, t) in part_ranges(k):
        keys = _extract_part_np(whi, wlo, s, t)
        overflowed |= (np.bincount(keys).max() > 4)
    assert overflowed


def test_join_palindrome_and_self(rng):
    """Reverse-complement palindromes must not be double-counted, and a
    k-mer adjacent to its own rc must count itself once (exactly the
    reference's behavior when a mutation of u equals rc(u))."""
    k = 16  # even k admits rc palindromes
    rng2 = np.random.default_rng(11)
    uniq, occ, cmap = _world(rng2, k, 1200)
    targets = uniq[occ == 1][:200]
    want = brute_sums(targets.tolist(), cmap, k, 2)
    got = hamming_neighbor_sums(targets, uniq, occ, k, 2, cpad=8)
    np.testing.assert_array_equal(got, want)


def test_run_search_filter_impls_agree(tmp_path, rng):
    """run_search with the hamming-join filter, the packed-probe
    filter, and the host filter must build identical dictionaries
    (correct-math mode, e=2)."""
    from quickmer2.config import SearchConfig
    from quickmer2.pipelines import search as search_pipe

    seq = helpers.random_genome(rng, 4000)
    noisy = list(seq)
    for pos in rng.integers(0, len(seq), size=150):
        noisy[pos] = "ACGT"[rng.integers(0, 4)]
    fa = str(tmp_path / "g.fa")
    helpers.write_fasta(fa, {"c1": seq + "".join(noisy)})
    cfg = SearchConfig(kmer_size=30, hash_size=1 << 16, edit_distance=2,
                       edit_depth_threshold=1, window_size=50)
    dicts = []
    for impl, dev in (("hamming", True), ("probe", True), ("host", False)):
        d = search_pipe.run_search(
            fa, cfg, out_prefix=str(tmp_path / impl),
            use_device_filter=dev, filter_impl=impl, verbose=False)
        dicts.append(d.kmers_in_order)
    np.testing.assert_array_equal(dicts[0], dicts[1])
    np.testing.assert_array_equal(dicts[0], dicts[2])
    # the filter actually removed something at this threshold
    raw = search_pipe.run_search(
        fa, SearchConfig(kmer_size=30, hash_size=1 << 16, edit_distance=0,
                         window_size=50),
        out_prefix=str(tmp_path / "nofilter"), verbose=False)
    assert len(dicts[0]) < len(raw.kmers_in_order)


def test_neighbor_bits_join_matches_probe_builders(rng):
    """The Hamming-join neighbor-bitmap builder (hamming_neighbor_bits,
    the device_build default since r5 — VERDICT r4 Next #6) is
    bit-identical to both probe-based builders on a repeat-heavy genome
    with planted ED1 neighbor copies."""
    import numpy as np
    from quickmer2.ops import codec
    from quickmer2.ops.anchored import (
        build_neighbor_bits, build_neighbor_bits_device)
    from quickmer2.ops.hamming_join import hamming_neighbor_bits
    from quickmer2.ops.packed_table import PackedTable

    k = 30
    G = 60_000
    g = rng.integers(0, 4, size=G).astype(np.uint8)
    # low-complexity tracts (bucket overflow) + ED1 neighbor copies
    g[5000:5400] = 0
    g[9000:9200] = np.tile([0, 1], 100)
    for _ in range(60):
        src = int(rng.integers(0, G - k))
        dst = int(rng.integers(0, G - k))
        win = g[src:src + k].copy()
        p = int(rng.integers(0, k))
        win[p] = (win[p] + int(rng.integers(1, 4))) % 4
        g[dst:dst + k] = win
    # separators (chromosome boundaries) exercise validity masking
    g[30_000] = codec.SEP

    canon, valid = codec.sliding_kmers_np(g, k)
    valid = valid & (canon != 0)
    km = canon[valid]
    u, c = np.unique(km, return_counts=True)
    dict_kmers = km[~np.isin(km, u[c > 1])]

    khi, klo = codec.split_u64(dict_kmers)
    table = PackedTable.build(khi, klo,
                              np.arange(len(dict_kmers), dtype=np.uint32))
    ref_host = build_neighbor_bits(g, table.rows, table.n_buckets, k)
    ref_dev = build_neighbor_bits_device(g, table.rows, table.n_buckets, k)
    np.testing.assert_array_equal(ref_host, ref_dev)
    # small cpads force heavy bucket overflow -> the host slow path
    # runs at volume; escalation (240-wide re-join) is disabled on CPU
    # because its B*240-lane layouts are an accelerator-scale allocation
    got = hamming_neighbor_bits(g, dict_kmers, k, cpad=8, cpad_q=4,
                                chunk_q=20_000, escalate=False)
    np.testing.assert_array_equal(got, ref_host)
