"""Anchored spill path through the mono single-gather table: results
must be bit-identical to the packed spill path and to the flat exact
count, including the side-table drain (forced small mono buckets)."""

import numpy as np

from quickmer2.config import SearchConfig
from quickmer2.ops import codec
from quickmer2.ops.anchored import AnchoredDepthCounter, rows_from_flat_codes
from quickmer2.pipelines.count import DepthCounter
from tests import helpers

K = 30
READ_LEN = 100


def _world(tmp_path, rng):
    from quickmer2.dictionary import Dictionary
    from quickmer2.ops.anchored import AnchoredIndex
    from quickmer2.pipelines import search as search_pipe
    chrom = helpers.random_genome(rng, 25000)
    fa = str(tmp_path / "g.fa")
    helpers.write_fasta(fa, {"c1": chrom})
    search_pipe.run_search(
        fa, SearchConfig(kmer_size=K, hash_size=1 << 16, edit_distance=0,
                         window_size=100), verbose=False)
    dic = Dictionary.from_qm(fa + ".qm")
    index = AnchoredIndex.from_dictionary_and_fasta(dic, fa)
    return chrom, dic, index


def _reads_rows(rng, chrom, n, err):
    reads = helpers.simulate_reads(rng, chrom, n, READ_LEN)
    reads = helpers.mutate_reads(rng, reads, err)
    stream = ("\n".join(reads) + "\n").encode()
    codes = codec.encode_bases(np.frombuffer(stream, dtype=np.uint8))
    return codes, rows_from_flat_codes(codes, READ_LEN)


def test_mono_spill_matches_packed_and_flat(tmp_path, rng):
    chrom, dic, index = _world(tmp_path, rng)
    # heavy error rate → plenty of spilled reads through the exact path
    codes, rows = _reads_rows(rng, chrom, 1200, 0.02)

    flat = DepthCounter(dic, batch_bases=1 << 15, layout="packed")
    flat.feed_codes(codes)
    truth = flat.finish()

    for mono in (False, True):
        c = AnchoredDepthCounter(index, K, READ_LEN, batch_reads=256,
                                 mono_spill=mono)
        c.feed_reads(rows)
        np.testing.assert_array_equal(c.finish(), truth)
        assert c.n_spilled > 0


def test_mono_spill_checkpoint_roundtrip(tmp_path, rng):
    chrom, dic, index = _world(tmp_path, rng)
    codes, rows = _reads_rows(rng, chrom, 800, 0.02)

    full = AnchoredDepthCounter(index, K, READ_LEN, batch_reads=256)
    full.feed_reads(rows)
    truth = full.finish()

    a = AnchoredDepthCounter(index, K, READ_LEN, batch_reads=256)
    half = len(rows) // 2
    a.feed_reads(rows[:half])
    arrays, meta = a.snapshot()
    b = AnchoredDepthCounter(index, K, READ_LEN, batch_reads=256)
    b.restore(arrays, meta)
    b.feed_reads(rows[half:])
    np.testing.assert_array_equal(b.finish(), truth)
    assert meta["mono_spill"] is True
