"""Long-read (HiFi-class) handling.

The reference splits lines at its 100 KB buffer and silently loses k-1
windows at each split (SURVEY.md section 5, "long-context"); our
streaming parser has no line-length limit and the batch carry preserves
every window. These tests feed 20 kb and 150 kb single-line reads and
check exact window counts."""

import numpy as np

from quickmer2.config import SearchConfig
from quickmer2.pipelines import search as search_pipe
from quickmer2.pipelines.count import DepthCounter, make_packer
from tests import helpers

K = 30


def test_hifi_reads_no_window_loss(tmp_path, rng):
    chr1 = helpers.random_genome(rng, 60000)
    fa = str(tmp_path / "g.fa")
    helpers.write_fasta(fa, {"c1": chr1})
    dic = search_pipe.run_search(
        fa, SearchConfig(kmer_size=K, hash_size=1 << 17, edit_distance=0,
                         window_size=100), verbose=False)

    # one 20kb read — its k-mers must each be counted exactly once
    start = 5000
    read = chr1[start : start + 20000]
    blob = f">hifi\n{read}\n".encode()
    codes = make_packer("fasta-lines").feed(blob)
    # batch smaller than the read: exercises the carry across batches
    c = DepthCounter(dic, batch_bases=1 << 12)
    c.feed_codes(codes)
    depth = c.finish()
    n_expected = 20000 - K + 1
    assert int(depth.sum()) == n_expected
    assert depth.max() == 1

    # 150kb single-line read (beyond the reference's 100KB line buffer)
    read2 = helpers.random_genome(np.random.default_rng(1), 150000)
    blob2 = f">long\n{read2}\n".encode()
    codes2 = make_packer("fasta-lines").feed(blob2)
    assert len(codes2) == 150000 + 1  # all bases + one separator


def test_sparse_dictionary_long_read_flow(tmp_path, rng):
    """HiFi + sparse fractionated dictionary (BASELINE config 5):
    thin the dictionary, count a long read against the .rqm."""
    from quickmer2.pipelines.sparse import run_sparse
    from quickmer2.io import formats
    chr1 = helpers.random_genome(rng, 40000)
    fa = str(tmp_path / "g.fa")
    helpers.write_fasta(fa, {"c1": chr1})
    search_pipe.run_search(
        fa, SearchConfig(kmer_size=K, hash_size=1 << 17, edit_distance=0,
                         window_size=50), verbose=False)
    thinned = run_sparse(fa, 20, window_size=50, verbose=False)
    read = chr1[1000:21000]
    codes = make_packer("fasta-lines").feed(f">r\n{read}\n".encode())
    c = DepthCounter(thinned, batch_bases=1 << 13)
    c.feed_codes(codes)
    depth = c.finish()
    # roughly one kept k-mer per 20bp within the read span
    assert 800 < int(depth.sum()) < 1100
    assert depth.max() == 1


def test_long_reads_ride_anchored_path_via_segments(tmp_path, rng):
    """HiFi reads segment into k-1-overlap rows and ride the anchored
    fast path (VERDICT r4 Missing #2): zero overflow, exact window
    counts, depth bit-identical to the flat path."""
    from quickmer2.ops.anchored import AnchoredIndex
    from quickmer2.pipelines.count import StreamCounter
    chr1 = helpers.random_genome(rng, 60000)
    fa = str(tmp_path / "g.fa")
    helpers.write_fasta(fa, {"c1": chr1})
    dic = search_pipe.run_search(
        fa, SearchConfig(kmer_size=K, hash_size=1 << 17, edit_distance=0,
                         window_size=100), verbose=False)
    index = AnchoredIndex.from_dictionary_and_fasta(dic, fa)

    # clean + noisy long reads, some rc, plus a few short reads
    reads = helpers.simulate_reads(rng, chr1, 6, 17000)
    reads += helpers.simulate_reads(rng, chr1, 40, 120)
    reads = helpers.mutate_reads(np.random.default_rng(2), reads, 0.002)
    blob = "".join(f"@r\n{r}\n+\n{'I' * len(r)}\n" for r in reads).encode()

    codes = make_packer("fastq").feed(blob)
    flat = DepthCounter(dic, batch_bases=1 << 14)
    flat.feed_codes(codes)
    truth = flat.finish()

    sc = StreamCounter(dic, mode="anchored", index=index)
    sc.feed_codes(make_packer("fastq").feed(blob))
    depth = sc.finish()
    np.testing.assert_array_equal(depth, truth)

    st = sc.stats
    assert st.get("overflow_windows", 0) == 0     # nothing fell to flat
    assert st["n_long_reads"] == 6
    assert st["n_segments"] >= 6 * 16             # ~17 segments per read
    # every row the kernel saw is a short read or a segment
    assert st["n_reads"] == 40 + st["n_segments"]


def test_segment_rows_window_exactness(rng):
    """Each k-mer window of an overlong read lands in EXACTLY one
    segment row (the k-1-overlap invariant), for awkward lengths."""
    from quickmer2.ops import codec
    from quickmer2.ops.anchored import rows_from_flat_codes
    read_len, k = 96, 30
    for L in (97, 96 + 67, 500, 1000, 1003):
        codes = rng.integers(0, 4, size=L).astype(np.uint8)
        stream = np.concatenate([codes, np.array([codec.SEP], np.uint8)])
        st = {}
        rows, over = rows_from_flat_codes(stream, read_len,
                                          with_overflow=True,
                                          segment_k=k, stats_out=st)
        assert len(over) == 0
        # multiset of windows across rows == windows of the read
        got = []
        for row in rows:
            canon, valid = codec.sliding_kmers_np(row, k)
            got.extend(canon[valid].tolist())
        want, wv = codec.sliding_kmers_np(codes, k)
        assert sorted(got) == sorted(want[wv].tolist())
        assert st == {"n_long_reads": 1, "n_segments": len(rows)}
