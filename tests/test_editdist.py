"""Edit-distance filter tests.

The decisive oracle (SURVEY.md E6): the reference binary's survivor set
is shaped by 32-bit-shift UB; our quirk-compat mode must reproduce it
bit-for-bit, while correct mode must match an independent brute-force
edit-distance model.
"""

import os

import numpy as np
import pytest

from quickmer2.config import SearchConfig
from quickmer2.dictionary import Dictionary
from quickmer2.ops import codec
from quickmer2.pipelines import search as search_pipe
from tests import helpers

K = 30


def brute_force_neighbor_sum(kmers, counts_by_kmer, k, e):
    """Slow, obviously-correct model: sum occurrence counts (saturated at
    255) over all distinct-position substitution variants at distance
    <= e, canonicalized, with d2 pairs pos2 < pos1 each counted once per
    (pos1,v1,pos2,v2) path (matching the reference's enumeration)."""
    out = []
    for km in kmers:
        total = 0
        for p1 in range(k):
            b1 = (km >> (2 * p1)) & 3
            for v1 in (1, 2, 3):
                n1 = km ^ ((b1 ^ ((b1 + v1) & 3)) << (2 * p1))
                c1 = min(codec.revcomp_code(n1, k), n1)
                total += counts_by_kmer.get(c1, 0)
                if e >= 2:
                    for p2 in range(p1):
                        b2 = (n1 >> (2 * p2)) & 3
                        for v2 in (1, 2, 3):
                            n2 = n1 ^ ((b2 ^ ((b2 + v2) & 3)) << (2 * p2))
                            c2 = min(codec.revcomp_code(n2, k), n2)
                            total += counts_by_kmer.get(c2, 0)
        out.append(total)
    return np.array(out)


@pytest.mark.parametrize("e", [1, 2])
def test_correct_mode_device_vs_bruteforce(rng, e):
    # small genome with near-duplicate k-mers so neighbors actually hit
    seq = helpers.random_genome(rng, 3000)
    mutated = list(seq)
    for pos in rng.integers(0, len(seq), size=60):
        mutated[pos] = "ACGT"[rng.integers(0, 4)]
    genome = seq + "".join(mutated)
    codes = codec.encode_bases(genome.encode())
    canon, valid = codec.sliding_kmers_np(codes, K)
    kmers = canon[valid & (canon != 0)]
    uniq, counts = np.unique(kmers, return_counts=True)
    sat = np.minimum(counts, 255)
    cmap = dict(zip(uniq.tolist(), sat.tolist()))

    H = 1 << 14
    from quickmer2.utils import native
    table = np.zeros(H, np.uint64)
    slots = native.insert_keys(table, uniq, return_slots=True)
    occr = np.zeros(H, np.uint8)
    occr[slots] = sat

    target = uniq[sat == 1][:256]
    want = brute_force_neighbor_sum(target.tolist(), cmap, K, e)

    got_dev = search_pipe._device_filter(target, uniq, sat.astype(np.uint8),
                                         K, e, batch=128)
    np.testing.assert_array_equal(got_dev, want)
    got_host = search_pipe._host_filter(target, table, occr, H, K, e)
    np.testing.assert_array_equal(got_host, want)


@pytest.mark.parametrize("e,d", [(1, 2), (2, 10), (1, 100)])
def test_quirk_mode_matches_reference_binary(rng, e, d, ref_binary, tmp_path):
    """E6 differential: survivor sets bit-for-bit vs the binary.

    (Thresholds chosen so the binary keeps >0 survivors: the reference
    segfaults on an empty dictionary — dump_kmer_list writes through
    uninitialized first/last chain indices, QuicKmer.c:1068. Observed
    with -e1 -d1 / -e2 -d5 on this fixture.)"""
    genome = helpers.random_genome(rng, 160 + K - 1)  # ~160 k-mers
    # add near-duplicates so the filter has work
    gl = list(genome)
    for pos in rng.integers(0, len(genome) - 1, size=8):
        gl[pos] = "ACGT"[rng.integers(0, 4)]
    fa = str(tmp_path / "g.fa")
    helpers.write_fasta(fa, {"c1": genome + "".join(gl)})
    helpers.run_ref(ref_binary,
                    ["search", "-k", str(K), "-t", "1", "-s", "1M",
                     "-e", str(e), "-d", str(d), "-w", "50", "g.fa"],
                    cwd=str(tmp_path))
    ref_dict = Dictionary.from_qm(fa + ".qm")

    cfg = SearchConfig(kmer_size=K, hash_size=1 << 20, edit_distance=e,
                       edit_depth_threshold=d, window_size=50,
                       quirk_mod32_editdist=True)
    ours = str(tmp_path / "ours.fa")
    d2 = search_pipe.run_search(fa, cfg, out_prefix=ours, verbose=False)
    np.testing.assert_array_equal(ref_dict.kmers_in_order, d2.kmers_in_order)

    # and the correct-math mode on the same input differs from the
    # binary for aggressive thresholds (documents that Q2 is real)
    if d == 2:
        cfg_ok = SearchConfig(kmer_size=K, hash_size=1 << 20, edit_distance=e,
                              edit_depth_threshold=d, window_size=50)
        ours_ok = str(tmp_path / "ok.fa")
        d3 = search_pipe.run_search(fa, cfg_ok, out_prefix=ours_ok,
                                    use_device_filter=False, verbose=False)
        assert len(d3.kmers_in_order) != len(ref_dict.kmers_in_order) or \
            not np.array_equal(d3.kmers_in_order, ref_dict.kmers_in_order)
