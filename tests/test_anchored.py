"""Anchored range-add counting: differential tests against the exact
per-k-mer path. Any divergence is a correctness bug (anchoring quality
may only affect speed, never results)."""

import os

import numpy as np
import pytest

from quickmer2.config import SearchConfig
from quickmer2.ops import codec
from quickmer2.ops.anchored import (
    AnchoredDepthCounter, AnchoredIndex, rows_from_flat_codes)
from quickmer2.pipelines import search as search_pipe
from quickmer2.pipelines.count import DepthCounter, make_packer
from tests import helpers

K = 30
READ_LEN = 100


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(77)
    d = tmp_path_factory.mktemp("anch")
    # two chromosomes, one with an N gap and a repeated segment (the
    # repeat's k-mers are non-unique → absent from the dictionary)
    rep = helpers.random_genome(rng, 1500)
    chr1 = (helpers.random_genome(rng, 15000) + rep + "N" * 40
            + helpers.random_genome(rng, 8000) + rep)
    chr2 = helpers.random_genome(rng, 6000)
    fa = str(d / "g.fa")
    helpers.write_fasta(fa, {"c1": chr1, "c2": chr2})
    dic = search_pipe.run_search(
        fa, SearchConfig(kmer_size=K, hash_size=1 << 16, edit_distance=0,
                         window_size=100), verbose=False)
    index = AnchoredIndex.from_dictionary_and_fasta(dic, fa)
    return {"dic": dic, "index": index, "chr1": chr1, "chr2": chr2,
            "rng": rng, "fa": fa}


def _depths(world, reads):
    """(anchored depth, direct depth) for a list of read strings."""
    blob = "".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)).encode()
    codes = make_packer("fasta-lines").feed(blob)

    direct = DepthCounter(world["dic"], batch_bases=1 << 16, layout="packed")
    direct.feed_codes(codes)
    d_direct = direct.finish()

    rows = rows_from_flat_codes(codes, READ_LEN)
    anch = AnchoredDepthCounter(world["index"], K, READ_LEN,
                                batch_reads=512)
    anch.feed_reads(rows)
    d_anch = anch.finish()
    return d_anch, d_direct, anch


def test_clean_reads(world):
    rng = np.random.default_rng(1)
    reads = (helpers.simulate_reads(rng, world["chr1"], 1200, READ_LEN)
             + helpers.simulate_reads(rng, world["chr2"], 400, READ_LEN))
    d_anch, d_direct, anch = _depths(world, reads)
    np.testing.assert_array_equal(d_anch, d_direct)
    assert d_direct.sum() > 0
    # clean reads rarely spill; the spills here are reads fully inside
    # the repeated segment (no dictionary k-mers → nothing to anchor on)
    assert anch.n_spilled < anch.n_reads * 0.12


def test_reads_with_errors(world):
    rng = np.random.default_rng(2)
    reads = helpers.simulate_reads(rng, world["chr1"], 800, READ_LEN)
    noisy = []
    for r in reads:
        rl = list(r)
        for _ in range(rng.integers(0, 4)):   # 0-3 substitutions
            p = rng.integers(0, len(rl))
            rl[p] = "ACGT"[rng.integers(0, 4)]
        noisy.append("".join(rl))
    d_anch, d_direct, _ = _depths(world, noisy)
    np.testing.assert_array_equal(d_anch, d_direct)


def test_unmappable_and_garbage_reads(world):
    rng = np.random.default_rng(3)
    reads = [helpers.random_genome(rng, READ_LEN) for _ in range(300)]
    reads += ["N" * READ_LEN] * 5
    reads += [helpers.random_genome(rng, 40)] * 10      # short reads
    reads += helpers.simulate_reads(rng, world["chr1"], 100, READ_LEN)
    d_anch, d_direct, _ = _depths(world, reads)
    np.testing.assert_array_equal(d_anch, d_direct)


def test_reads_over_repeats_and_gaps(world):
    rng = np.random.default_rng(4)
    chr1 = world["chr1"]
    # reads straddling the N gap and the repeated (non-unique) segment
    gap = chr1.find("N")
    reads = []
    for off in range(-80, 20, 7):
        reads.append(chr1[gap + off : gap + off + READ_LEN])
    rep_at = 15000
    for off in range(-60, 1560, 37):
        reads.append(chr1[rep_at + off : rep_at + off + READ_LEN])
    reads = [r for r in reads if len(r) == READ_LEN]
    d_anch, d_direct, _ = _depths(world, reads)
    np.testing.assert_array_equal(d_anch, d_direct)


def test_mixed_strand_reads(world):
    rng = np.random.default_rng(5)
    fwd = helpers.simulate_reads(rng, world["chr1"], 500, READ_LEN)
    # simulate_reads already flips ~half; add guaranteed RC reads
    rc = [helpers.revcomp(r) for r in fwd[:100]]
    d_anch, d_direct, _ = _depths(world, fwd + rc)
    np.testing.assert_array_equal(d_anch, d_direct)


def test_neighbor_bits_brute_force(world):
    """build_neighbor_bits against brute-force enumeration of every
    single-substitution variant of every valid genome window."""
    from quickmer2.ops.anchored import build_neighbor_bits
    from quickmer2.ops.packed_table import PackedTable

    rng = np.random.default_rng(9)
    genome = helpers.random_genome(rng, 400)
    # plant an ED1 pair: copy a 60bp block with one substitution so some
    # variants really do hit the dictionary
    blk = genome[100:160]
    mut = blk[:31] + ("A" if blk[31] != "A" else "C") + blk[32:]
    genome = genome + "N" + mut
    codes = codec.encode_bases(genome.encode())
    canon, valid = codec.sliding_kmers_np(codes, K)
    valid &= canon != 0
    kmers = canon[valid]
    uniq, counts = np.unique(kmers, return_counts=True)
    keep = valid.copy()
    keep[valid] &= ~np.isin(kmers, uniq[counts > 1])
    dict_kmers = canon[keep]
    khi, klo = codec.split_u64(dict_kmers)
    table = PackedTable.build(khi, klo,
                              np.arange(len(dict_kmers), dtype=np.uint32))
    nb = build_neighbor_bits(codes, table.rows, table.n_buckets, K)

    dict_set = set(dict_kmers.tolist())
    G = len(codes)
    expect = np.zeros(G, np.uint8)
    for g0 in range(G - K + 1):
        win = codes[g0 : g0 + K]
        if (win >= 4).any():
            continue
        for i in range(K):
            for b in range(4):
                if b == win[i]:
                    continue
                w2 = win.copy()
                w2[i] = b
                fwd = 0
                rc = 0
                for j, c in enumerate(w2):
                    fwd = (fwd << 2) | int(c)
                    rc |= ((int(c) - 2) & 3) << (2 * j)
                if min(fwd, rc) in dict_set:
                    expect[g0 + i] |= 1 << b
    np.testing.assert_array_equal(nb, expect)
    assert expect.any()   # the planted ED1 pair must produce real hits

    # device builder must agree bit-for-bit (incl. across chunk seams)
    from quickmer2.ops.anchored import build_neighbor_bits_device
    nb_dev = build_neighbor_bits_device(codes, table.rows, table.n_buckets, K)
    np.testing.assert_array_equal(nb_dev, expect)
    nb_chunked = build_neighbor_bits_device(codes, table.rows,
                                            table.n_buckets, K, chunk=128)
    np.testing.assert_array_equal(nb_chunked, expect)


def test_ed1_neighbor_hits_stay_exact(tmp_path):
    """A substituted read whose dirty window k-mer IS in the dictionary
    (planted ED1 pair): the neighbor bitmap must force a spill so the
    hit is counted — the one case the fast discard cannot skip."""
    rng = np.random.default_rng(10)
    blk = helpers.random_genome(rng, 120)
    mid = 60
    sub = "A" if blk[mid] != "A" else "C"
    mut = blk[:mid] + sub + blk[mid + 1:]
    chrom = (helpers.random_genome(rng, 3000) + blk
             + helpers.random_genome(rng, 3000) + mut
             + helpers.random_genome(rng, 3000))
    fa = str(tmp_path / "ed1.fa")
    helpers.write_fasta(fa, {"c1": chrom})
    dic = search_pipe.run_search(
        fa, SearchConfig(kmer_size=K, hash_size=1 << 16, edit_distance=0,
                         window_size=100), verbose=False)
    index = AnchoredIndex.from_dictionary_and_fasta(dic, fa)
    assert index.has_neighbor_bits

    # reads over the ORIGINAL block carrying exactly the substitution
    # that turns it into the planted variant (and rc versions)
    blk_at = 3000
    reads = []
    for off in range(0, 60, 3):
        s = blk_at + mid - READ_LEN + 1 + off
        r = chrom[s : s + READ_LEN]
        p = READ_LEN - 1 - off
        if 0 <= p < READ_LEN:
            r = r[:p] + sub + r[p + 1:]
        reads.append(r)
        reads.append(helpers.revcomp(r))
    world = {"dic": dic, "index": index}
    d_anch, d_direct, anch = _depths(world, reads)
    np.testing.assert_array_equal(d_anch, d_direct)
    assert anch.n_spilled > 0          # bitmap hits must spill
    assert d_direct.sum() > 0


def test_isolated_errors_do_not_spill(world):
    """The point of the bitmap: reads with one isolated substitution in
    a random genome should be fully absorbed by tier 1."""
    rng = np.random.default_rng(11)
    reads = helpers.simulate_reads(rng, world["chr2"], 300, READ_LEN)
    noisy = []
    for r in reads:
        p = int(rng.integers(10, READ_LEN - 10))
        c = "ACGT"[int(rng.integers(0, 4))]
        noisy.append(r[:p] + c + r[p + 1:])
    d_anch, d_direct, anch = _depths(world, noisy)
    np.testing.assert_array_equal(d_anch, d_direct)
    assert anch.n_spilled < anch.n_reads * 0.05


def test_without_neighbor_bits(world):
    """Index built without the bitmap: falls back to spill-on-any-dirty
    and must stay exact."""
    index = AnchoredIndex.from_dictionary_and_fasta(
        world["dic"], world["fa"], neighbor_bits=False)
    assert not index.has_neighbor_bits
    rng = np.random.default_rng(12)
    reads = helpers.simulate_reads(rng, world["chr1"], 200, READ_LEN)
    noisy = [r[:50] + ("A" if r[50] != "A" else "T") + r[51:] for r in reads]
    blob = "".join(f">r{i}\n{r}\n" for i, r in enumerate(noisy)).encode()
    codes = make_packer("fasta-lines").feed(blob)
    direct = DepthCounter(world["dic"], batch_bases=1 << 16, layout="packed")
    direct.feed_codes(codes)
    d_direct = direct.finish()
    rows = rows_from_flat_codes(codes, READ_LEN)
    anch = AnchoredDepthCounter(index, K, READ_LEN, batch_reads=512)
    assert not anch.neighbor_mode
    anch.feed_reads(rows)
    np.testing.assert_array_equal(anch.finish(), d_direct)


def test_chimeric_reads(world):
    """Reads stitched from two distant loci — anchor at one locus, half
    the read mismatches → dirty k-mers / spill; must stay exact."""
    chr1, chr2 = world["chr1"], world["chr2"]
    reads = []
    for i in range(200):
        a = chr1[1000 + 13 * i : 1000 + 13 * i + READ_LEN // 2]
        b = chr2[500 + 11 * i : 500 + 11 * i + READ_LEN - len(a)]
        if len(a) + len(b) == READ_LEN:
            reads.append(a + b)
    d_anch, d_direct, _ = _depths(world, reads)
    np.testing.assert_array_equal(d_anch, d_direct)


def test_variable_length_reads_route_to_flat(tmp_path):
    """Mixed 100/150/2000-bp reads through run_count(mode='anchored')
    must match flat mode bit-for-bit: rows wider than the autodetected
    row width route to the flat per-k-mer path instead of raising
    (VERDICT Weak #5 / Next #6)."""
    from quickmer2.io import formats
    from quickmer2.pipelines.count import run_count

    rng = np.random.default_rng(11)
    d = str(tmp_path)
    chrom = helpers.random_genome(rng, 30000)
    fa = d + "/g.fa"
    helpers.write_fasta(fa, {"c1": chrom})
    search_pipe.run_search(
        fa, SearchConfig(kmer_size=K, hash_size=1 << 16, edit_distance=0,
                         window_size=100), verbose=False)

    reads = (helpers.simulate_reads(rng, chrom, 300, 100)
             + helpers.simulate_reads(rng, chrom, 200, 150)
             + helpers.simulate_reads(rng, chrom, 6, 2000))
    order = rng.permutation(len(reads))
    reads = [reads[i] for i in order]
    fq = d + "/reads.fq"
    helpers.write_fastq(fq, reads)

    run_count(fa + ".qm", fq, d + "/flat", batch_bases=1 << 16,
              verbose=False)
    run_count(fa + ".qm", fq, d + "/anch", batch_bases=1 << 16,
              verbose=False, mode="anchored", ref_fasta=fa)
    flat = formats.read_u16(d + "/flat.bin")
    anch = formats.read_u16(d + "/anch.bin")
    np.testing.assert_array_equal(anch, flat)


def test_qai_companion_persists_index(tmp_path):
    """First anchored count writes <fasta>.qai; a second invocation must
    load it WITHOUT touching the FASTA and produce bit-identical output
    (VERDICT Missing #3 / Next #5). A stale artifact is rebuilt."""
    from quickmer2.io import formats
    from quickmer2.ops.anchored import AnchoredIndex
    from quickmer2.pipelines.count import run_count

    rng = np.random.default_rng(21)
    d = str(tmp_path)
    chrom = helpers.random_genome(rng, 25000)
    fa = d + "/g.fa"
    helpers.write_fasta(fa, {"c1": chrom})
    search_pipe.run_search(
        fa, SearchConfig(kmer_size=K, hash_size=1 << 16, edit_distance=0,
                         window_size=100), verbose=False)
    reads = helpers.simulate_reads(rng, chrom, 800, 100)
    fq = d + "/reads.fq"
    helpers.write_fastq(fq, reads)

    run_count(fa + ".qm", fq, d + "/a", verbose=False, mode="anchored",
              ref_fasta=fa)
    assert os.path.exists(fa + ".qai")
    first = formats.read_u16(d + "/a.bin")

    # corrupt the FASTA: a second run must not read it
    with open(fa, "w") as f:
        f.write(">c1\nGARBAGE\n")
    run_count(fa + ".qm", fq, d + "/b", verbose=False, mode="anchored",
              ref_fasta=fa)
    second = formats.read_u16(d + "/b.bin")
    np.testing.assert_array_equal(first, second)

    # stale artifact (wrong n_kmers) → load must raise for direct load,
    # and from_dictionary_and_fasta must fall back to a rebuild
    from quickmer2.dictionary import Dictionary
    dic = Dictionary.from_qm(fa + ".qm")
    k_, G_, tiles_, pos_, nb_, fp_ = formats.read_qai(fa + ".qai")
    formats.write_qai(fa + ".qai", k_, G_, tiles_, pos_[:-5], nb_, fp_)
    with pytest.raises(ValueError):
        AnchoredIndex.load(fa + ".qai", dic)


def test_rowpack_roundtrip():
    """pack_rows/unpack_rows is exact for every row shape including
    non-multiple-of-4/8 widths, SEP padding, and N bases."""
    from quickmer2.ops import rowpack
    rng = np.random.default_rng(3)
    for L in (7, 32, 100, 150, 161):
        rows = rng.integers(0, 4, size=(37, L)).astype(np.uint8)
        # SEP tails of varying length + scattered invalid codes
        lens = rng.integers(1, L + 1, size=37)
        rows[np.arange(L)[None, :] >= lens[:, None]] = codec.SEP
        rows[rng.random(rows.shape) < 0.01] = codec.SEP
        pk, iv = rowpack.pack_rows(rows)
        assert pk.shape == (37, -(-L // 4)) and iv.shape == (37, -(-L // 8))
        out = np.asarray(rowpack.unpack_rows(pk, iv, read_len=L))
        np.testing.assert_array_equal(out, rows)


def test_packed_h2d_identical(world):
    """pack_h2d=True must produce bit-identical depth to unpacked
    feeding (same batches, same spills)."""
    rng = np.random.default_rng(8)
    chr1 = world["chr1"]
    reads = helpers.simulate_reads(rng, chr1, 600, READ_LEN)
    reads = helpers.mutate_reads(rng, reads, 0.01)
    blob = "".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)).encode()
    rows = rows_from_flat_codes(make_packer("fasta-lines").feed(blob),
                                READ_LEN)
    a = AnchoredDepthCounter(world["index"], K, READ_LEN, batch_reads=256,
                             pack_h2d=True)
    b = AnchoredDepthCounter(world["index"], K, READ_LEN, batch_reads=256,
                             pack_h2d=False)
    a.feed_reads(rows)
    b.feed_reads(rows)
    da, db = a.finish(), b.finish()
    assert a.n_spilled == b.n_spilled
    np.testing.assert_array_equal(da, db)


def test_qai_fingerprint_rejects_rebuilt_dictionary(tmp_path):
    """A dictionary rebuilt over the same FASTA with different filter
    parameters can keep the same k and n_kmers while changing the k-mer
    SET; the stale .qai must be rejected by content fingerprint, not
    load silently (VERDICT r2 Weak #4 / Next #6)."""
    from quickmer2.dictionary import Dictionary
    from quickmer2.io import formats
    from quickmer2.ops.anchored import AnchoredIndex
    from quickmer2.pipelines.count import run_count

    rng = np.random.default_rng(33)
    d = str(tmp_path)
    chrom = helpers.random_genome(rng, 20000)
    fa = d + "/g.fa"
    helpers.write_fasta(fa, {"c1": chrom})
    search_pipe.run_search(
        fa, SearchConfig(kmer_size=K, hash_size=1 << 16, edit_distance=0,
                         window_size=100), verbose=False)
    reads = helpers.simulate_reads(rng, chrom, 400, 100)
    fq = d + "/reads.fq"
    helpers.write_fastq(fq, reads)
    run_count(fa + ".qm", fq, d + "/a", verbose=False, mode="anchored",
              ref_fasta=fa)
    dic = Dictionary.from_qm(fa + ".qm")

    # forge a same-k same-n artifact whose source dictionary differed in
    # ONE k-mer (what a different -d rebuild can produce)
    k_, G_, tiles_, pos_, nb_, fp_ = formats.read_qai(fa + ".qai")
    assert fp_ == dic.fingerprint
    from quickmer2.dictionary import content_fingerprint
    altered = dic.kmers_in_order.copy()
    altered[0] ^= 0b1100  # a different canonical code, same count
    wrong_fp = content_fingerprint(altered, dic.kmer_size)
    assert wrong_fp != fp_
    formats.write_qai(fa + ".qai", k_, G_, tiles_, pos_, nb_, wrong_fp)
    with pytest.raises(ValueError, match="fingerprint"):
        AnchoredIndex.load(fa + ".qai", dic)
    # the pipeline-level entry falls back to rebuild-and-overwrite
    idx = AnchoredIndex.from_dictionary_and_fasta(
        dic, fa, cache_path=fa + ".qai")
    assert idx.n_kmers == dic.n_kmers
    assert formats.read_qai(fa + ".qai")[5] == dic.fingerprint


def test_hbm_budget_fallback(tmp_path):
    """When the anchored structures exceed a forced HBM cap, run_count
    falls back to the flat path bit-identically and reports why
    (VERDICT r2 Missing #4 / Next #8)."""
    from quickmer2.io import formats
    from quickmer2.ops.anchored import AnchoredIndex
    from quickmer2.pipelines.count import run_count

    rng = np.random.default_rng(44)
    d = str(tmp_path)
    chrom = helpers.random_genome(rng, 20000)
    fa = d + "/g.fa"
    helpers.write_fasta(fa, {"c1": chrom})
    search_pipe.run_search(
        fa, SearchConfig(kmer_size=K, hash_size=1 << 16, edit_distance=0,
                         window_size=100), verbose=False)
    reads = helpers.simulate_reads(rng, chrom, 500, 100)
    fq = d + "/r.fq"
    helpers.write_fastq(fq, reads)

    est = AnchoredIndex.estimate_hbm_bytes(20000, 20000)
    assert est["total"] > 0 and est["rows"] > est["dblock"]

    s1 = run_count(fa + ".qm", fq, d + "/anch", verbose=False,
                   mode="anchored", ref_fasta=fa)
    assert "fallback" not in s1
    s2 = run_count(fa + ".qm", fq, d + "/capped", verbose=False,
                   mode="anchored", ref_fasta=fa, hbm_limit_bytes=1024)
    assert s2["fallback"]["reason"] == "anchored-structures-exceed-hbm"
    assert s2["mode"] == "flat"
    np.testing.assert_array_equal(formats.read_u16(d + "/capped.bin"),
                                  formats.read_u16(d + "/anch.bin"))

    # dict-sharding-aware budget (VERDICT r3 Next #6): a budget that the
    # unsharded rows exceed but a 4-way bucket-block shard fits must run
    # ANCHORED (sharded), not fall back to flat
    est1 = AnchoredIndex.estimate_hbm_bytes(20000, 20000, dict_devices=1)
    est4 = AnchoredIndex.estimate_hbm_bytes(20000, 20000, dict_devices=4)
    assert est4["rows"] == est1["rows"] // 4
    budget = (est4["total"] + est1["total"]) // 2
    s3 = run_count(fa + ".qm", fq, d + "/ds4", verbose=False,
                   mode="anchored", ref_fasta=fa, hbm_limit_bytes=budget,
                   dict_devices=4)
    assert "fallback" not in s3 and s3["mode"] == "anchored"
    np.testing.assert_array_equal(formats.read_u16(d + "/ds4.bin"),
                                  formats.read_u16(d + "/anch.bin"))
    s4 = run_count(fa + ".qm", fq, d + "/ds1cap", verbose=False,
                   mode="anchored", ref_fasta=fa, hbm_limit_bytes=budget)
    assert s4["mode"] == "flat"    # same budget, unsharded: falls back
