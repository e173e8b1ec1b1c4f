"""Genome-sharded device membership scan (search pass 2, the SP axis):
artifacts must be byte-identical to the host lookup path on a
multi-chromosome genome with N gaps, repeats, and a control bed."""

import os

import numpy as np
import pytest

from quickmer2.config import SearchConfig
from quickmer2.pipelines import search as search_pipe
from tests import helpers


@pytest.mark.parametrize("emit_devices", [1, 4])
def test_device_emit_byte_identical(tmp_path, rng, emit_devices):
    d = str(tmp_path)
    rep = helpers.random_genome(rng, 900)
    chr1 = (helpers.random_genome(rng, 9000) + rep + "N" * 25
            + helpers.random_genome(rng, 5000) + rep)
    chr2 = helpers.random_genome(rng, 7000)
    fa_h = os.path.join(d, "host.fa")
    fa_d = os.path.join(d, "dev.fa")
    ctrl_rows = "chr1\t100\t8000\nchr2\t0\t6500\nchrZ\t0\t10\n"
    for fa in (fa_h, fa_d):
        helpers.write_fasta(fa, {"chr1": chr1, "chr2": chr2})
        with open(fa + ".ctrl.bed", "w") as f:
            f.write(ctrl_rows)

    cfg = lambda fa: SearchConfig(       # noqa: E731
        kmer_size=30, hash_size=1 << 16, edit_distance=1,
        edit_depth_threshold=50, window_size=100,
        control_bed=fa + ".ctrl.bed")
    search_pipe.run_search(fa_h, cfg(fa_h), verbose=False)
    search_pipe.run_search(fa_d, cfg(fa_d), verbose=False,
                           emit_devices=emit_devices)
    # small device chunk so the chunk loop actually iterates
    from quickmer2.parallel.emit_parallel import DeviceMembershipScanner
    assert DeviceMembershipScanner is not None
    for ext in (".qm", ".bed", ".qgc"):
        with open(fa_h + ext, "rb") as a, open(fa_d + ext, "rb") as b:
            assert a.read() == b.read(), f"{ext} diverged"


def test_scanner_chunking_matches_host(rng):
    """Direct scanner check with a chunk smaller than the genome (the
    chunk/halo seam logic), vs the host probe."""
    from quickmer2.ops import codec
    from quickmer2.ops.packed_table import PackedTable, probe_packed_np
    from quickmer2.parallel.emit_parallel import DeviceMembershipScanner

    chrom = helpers.random_genome(rng, 30000) + "N" * 7 \
        + helpers.random_genome(rng, 3000)
    codes = codec.encode_bases(np.frombuffer(chrom.encode(), np.uint8))
    canon, valid = codec.sliding_kmers_np(codes, 30)
    kmers = canon[valid & (canon != 0)]
    uniq = np.unique(kmers)[: 5000]
    hi, lo = codec.split_u64(uniq)
    tab = PackedTable.build(hi, lo,
                            rank=np.arange(len(uniq), dtype=np.uint32))

    chi, clo = codec.split_u64(canon)
    host = probe_packed_np(tab.rows, chi, clo, tab.n_buckets) \
        & valid & (canon != 0)
    for dp in (1, 2):
        sc = DeviceMembershipScanner(tab, 30, data_devices=dp, chunk=1 << 12)
        np.testing.assert_array_equal(sc.scan(codes), host)
