"""Differential tests for the sparse and index utilities."""

import os

import numpy as np
import pytest

from quickmer2.dictionary import Dictionary
from quickmer2.io import formats
from quickmer2.pipelines import index as index_pipe
from quickmer2.pipelines import sparse as sparse_pipe
from tests import helpers

K = 30


@pytest.fixture(scope="module")
def searched(tmp_path_factory, ref_binary):
    rng = np.random.default_rng(11)
    d = tmp_path_factory.mktemp("sparse")
    chr1 = helpers.random_genome(rng, 20000) + "N" * 30 + helpers.random_genome(rng, 9000)
    chr2 = helpers.random_genome(rng, 8000)
    fa = str(d / "g.fa")
    helpers.write_fasta(fa, {"c1": chr1, "c2": chr2})
    ctrl = str(d / "ctrl.bed")
    with open(ctrl, "w") as f:
        f.write("c1\t100\t15000\nc2\t0\t8000\n")
    helpers.run_ref(ref_binary,
                    ["search", "-k", str(K), "-t", "1", "-s", "1M", "-e", "0",
                     "-w", "100", "-c", ctrl, "g.fa"], cwd=str(d))
    return {"dir": str(d), "fa": fa, "ctrl": ctrl}


@pytest.mark.parametrize("thin", [1, 50])
def test_sparse_matches_reference(searched, ref_binary, thin, tmp_path):
    g = searched
    import shutil
    d = str(tmp_path)
    for ext in (".qm", ".bed", ".qgc", ""):
        shutil.copy(g["fa"] + ext, os.path.join(d, "g.fa" + ext))
    shutil.copy(g["ctrl"], os.path.join(d, "ctrl.bed"))
    helpers.run_ref(ref_binary,
                    ["sparse", "-w", "40", "-c", "ctrl.bed", str(thin), "g.fa"],
                    cwd=d)
    ref_rqm = Dictionary.from_qm(os.path.join(d, "g.fa.rqm"))
    ref_bed = open(os.path.join(d, "g.fa.bed")).read()
    ref_qgc = formats.read_u16(os.path.join(d, "g.fa.qgc"))

    d2 = str(tmp_path / "ours")
    os.makedirs(d2)
    for ext in (".qm", ""):
        shutil.copy(g["fa"] + ext, os.path.join(d2, "g.fa" + ext))
    ours = sparse_pipe.run_sparse(os.path.join(d2, "g.fa"), thin,
                                  window_size=40,
                                  control_bed=os.path.join(d, "ctrl.bed"),
                                  verbose=False)
    np.testing.assert_array_equal(ours.kmers_in_order, ref_rqm.kmers_in_order)
    assert ours.header.hash_size == ref_rqm.header.hash_size
    assert ours.header.byte7 == ref_rqm.header.byte7
    assert open(os.path.join(d2, "g.fa.bed")).read() == ref_bed
    np.testing.assert_array_equal(
        formats.read_u16(os.path.join(d2, "g.fa.qgc")), ref_qgc)


def test_index_matches_reference(ref_binary, tmp_path, rng):
    # k-mer bed with a duplicate row (exercises the duplicate-slot quirk)
    seqs = [helpers.random_genome(rng, K) for _ in range(200)]
    seqs.append(seqs[5])
    rows = "".join(f"c1\t{i}\t{i+K}\t{s}\n" for i, s in enumerate(seqs))
    bed = str(tmp_path / "kmers.bed")
    with open(bed, "w") as f:
        f.write(rows)
    helpers.run_ref(ref_binary, ["index", "-s", "64K", "kmers.bed", "ref.qm"],
                    cwd=str(tmp_path))
    ours = index_pipe.run_index(bed, str(tmp_path / "ours.qm"),
                                hash_size=1 << 16, verbose=False)
    with open(str(tmp_path / "ref.qm"), "rb") as f1, \
         open(str(tmp_path / "ours.qm"), "rb") as f2:
        ref_bytes = f1.read()
        our_bytes = f2.read()
    # identical insertion algorithm + order → byte-identical .qm
    assert our_bytes == ref_bytes


def test_index_k15_quirk_canonicalization(ref_binary, tmp_path, rng):
    """k<30 exercises the Q1 fixed-<<60 rc register quirk."""
    seqs = [helpers.random_genome(rng, 15) for _ in range(100)]
    bed = str(tmp_path / "kmers.bed")
    with open(bed, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f"c1\t{i}\t{i+15}\t{s}\n")
    helpers.run_ref(ref_binary, ["index", "-s", "16K", "kmers.bed", "ref.qm"],
                    cwd=str(tmp_path))
    index_pipe.run_index(bed, str(tmp_path / "ours.qm"), hash_size=1 << 14,
                         verbose=False)
    assert open(str(tmp_path / "ref.qm"), "rb").read() == \
        open(str(tmp_path / "ours.qm"), "rb").read()
