"""End-to-end differential tests against the compiled reference binary.

These are the decisive oracle (SURVEY.md section 7): synthetic genome →
reference `search`/`count` vs our pipelines, comparing artifacts at the
byte level where the formats are binary and textually where text.
"""

import os

import numpy as np
import pytest

from quickmer2.config import SearchConfig
from quickmer2.dictionary import Dictionary
from quickmer2.io import formats
from quickmer2.pipelines import count as count_pipe
from quickmer2.pipelines import search as search_pipe
from tests import helpers

K = 30


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    """Two-chromosome synthetic genome with a duplicated segment, an N
    run, and a control bed covering most of chr1."""
    rng = np.random.default_rng(42)
    d = tmp_path_factory.mktemp("genome")
    seg = helpers.random_genome(rng, 8000)
    chr1 = helpers.random_genome(rng, 30000) + seg + helpers.random_genome(rng, 5000)
    # duplicate seg on chr2 (makes those k-mers non-unique) + N run
    chr2 = (helpers.random_genome(rng, 12000) + "N" * 50 +
            helpers.random_genome(rng, 6000) + seg)
    fa = str(d / "ref.fa")
    helpers.write_fasta(fa, {"chr1": chr1, "chr2": chr2})
    ctrl = str(d / "ctrl.bed")
    with open(ctrl, "w") as f:
        f.write("chr1\t1000\t28000\n")
    return {"dir": str(d), "fa": fa, "ctrl": ctrl, "chr1": chr1, "chr2": chr2,
            "rng": rng}


@pytest.fixture(scope="module")
def ref_search(genome, ref_binary):
    """Reference `search -e0` artifacts (edit filter off isolates the
    tabulation/dump path; the filter is covered by test_editdist)."""
    helpers.run_ref(ref_binary,
                    ["search", "-k", str(K), "-t", "1", "-s", "1M", "-e", "0",
                     "-w", "100", "-c", genome["ctrl"], "ref.fa"],
                    cwd=genome["dir"])
    return genome


def test_search_artifacts_match(ref_search, tmp_path):
    g = ref_search
    cfg = SearchConfig(kmer_size=K, hash_size=1 << 20, edit_distance=0,
                       window_size=100, control_bed=g["ctrl"])
    ours = str(tmp_path / "ours.fa")
    d = search_pipe.run_search(g["fa"], cfg, out_prefix=ours, verbose=False)

    # .bed windows: byte-identical text
    with open(g["fa"] + ".bed") as f:
        ref_bed = f.read()
    with open(ours + ".bed") as f:
        our_bed = f.read()
    assert our_bed == ref_bed

    # .qgc: byte-identical
    ref_qgc = formats.read_u16(g["fa"] + ".qgc")
    our_qgc = formats.read_u16(ours + ".qgc")
    np.testing.assert_array_equal(our_qgc, ref_qgc)

    # .qm: same header geometry, same k-mer set, same chain order
    ref_dict = Dictionary.from_qm(g["fa"] + ".qm")
    assert ref_dict.header.kmer_size == K
    assert ref_dict.header.hash_size == d.header.hash_size
    np.testing.assert_array_equal(np.sort(ref_dict.kmers_in_order),
                                  np.sort(d.kmers_in_order))
    np.testing.assert_array_equal(ref_dict.kmers_in_order, d.kmers_in_order)


@pytest.fixture(scope="module")
def reads(genome):
    rng = np.random.default_rng(7)
    reads = (helpers.simulate_reads(rng, genome["chr1"], 4000, 100)
             + helpers.simulate_reads(rng, genome["chr2"], 2500, 100))
    rng.shuffle(reads)
    path = os.path.join(genome["dir"], "reads.fa")
    helpers.write_reads_fasta(path, reads)
    fq = os.path.join(genome["dir"], "reads.fq")
    helpers.write_fastq(fq, reads)
    return {"fa": path, "fq": fq}


def test_count_bin_byte_identical(ref_search, reads, ref_binary, tmp_path):
    g = ref_search
    helpers.run_ref(ref_binary, ["count", "-t", "0", "ref.fa", "reads.fa", "refout"],
                    cwd=g["dir"])
    out = str(tmp_path / "ours")
    count_pipe.run_count(g["fa"] + ".qm", reads["fa"], out,
                         batch_bases=1 << 16, verbose=False)
    ref_bin = formats.read_u16(os.path.join(g["dir"], "refout.bin"))
    our_bin = formats.read_u16(out + ".bin")
    np.testing.assert_array_equal(our_bin, ref_bin)
    # .txt GC curve: same numbers (text compare line by line)
    with open(os.path.join(g["dir"], "refout.txt")) as f:
        ref_txt = f.read()
    with open(out + ".txt") as f:
        our_txt = f.read()
    assert our_txt == ref_txt


def test_count_fastq_matches_fasta(ref_search, reads, tmp_path):
    g = ref_search
    out_fa = str(tmp_path / "fa")
    out_fq = str(tmp_path / "fq")
    count_pipe.run_count(g["fa"] + ".qm", reads["fa"], out_fa,
                         batch_bases=1 << 16, verbose=False)
    count_pipe.run_count(g["fa"] + ".qm", reads["fq"], out_fq,
                         batch_bases=1 << 16, verbose=False)
    np.testing.assert_array_equal(formats.read_u16(out_fa + ".bin"),
                                  formats.read_u16(out_fq + ".bin"))


def test_count_against_own_dictionary(ref_search, reads, tmp_path):
    """Counting against our own .qm (different slot placement, same chain
    order) must produce the identical .bin."""
    g = ref_search
    cfg = SearchConfig(kmer_size=K, hash_size=1 << 20, edit_distance=0,
                       window_size=100, control_bed=g["ctrl"])
    ours = str(tmp_path / "own.fa")
    search_pipe.run_search(g["fa"], cfg, out_prefix=ours, verbose=False)
    out1 = str(tmp_path / "ref_dict")
    out2 = str(tmp_path / "own_dict")
    count_pipe.run_count(g["fa"] + ".qm", reads["fa"], out1,
                         batch_bases=1 << 16, verbose=False)
    count_pipe.run_count(ours + ".qm", reads["fa"], out2,
                         batch_bases=1 << 16, verbose=False)
    np.testing.assert_array_equal(formats.read_u16(out1 + ".bin"),
                                  formats.read_u16(out2 + ".bin"))
