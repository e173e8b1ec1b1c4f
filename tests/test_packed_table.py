"""Packed two-choice table tests: build invariants, probe parity with
the linear-probe host path, and count-pipeline equivalence."""

import numpy as np
import pytest

import jax.numpy as jnp

from quickmer2.ops import codec
from quickmer2.ops.packed_table import (
    ENTRIES_PER_BUCKET, PackedTable, _cuckoo_evict, bucket_hashes,
    bucket_hashes_jnp, probe_packed)


@pytest.mark.parametrize("log2_buckets", [1, 16, 27, 32])
def test_bucket_hashes_reach_every_bucket_range(rng, log2_buckets):
    """h2 spreads over the whole table, also above 2^25 buckets, and the
    host (build) and device (probe) hashes agree."""
    n_buckets = 1 << log2_buckets
    h = rng.integers(0, 1 << 32, size=1 << 16, dtype=np.uint64).astype(np.uint32)
    h1, h2 = bucket_hashes(h, n_buckets)
    assert int(h1.max()) < n_buckets and int(h2.max()) < n_buckets
    # the top eighth of the table is reached by h2
    assert int(h2.max()) >= 7 * n_buckets // 8
    j1, j2 = bucket_hashes_jnp(jnp.asarray(h), n_buckets)
    np.testing.assert_array_equal(np.asarray(j1), h1)
    np.testing.assert_array_equal(np.asarray(j2), h2)


def test_bucket_hashes_reject_non_power_of_two():
    with pytest.raises(ValueError):
        bucket_hashes(np.zeros(4, np.uint32), 3 << 20)


def test_cuckoo_escapes_two_bucket_cycle():
    """Buckets 0 and 1 are full and the pending key hashes to both. The
    only way out is to evict key 2 (to empty bucket 2) or key 3 (to
    empty bucket 3). A victim chosen by kick parity alternates between
    the other two entries of each bucket for ever; the walk must not."""
    C = ENTRIES_PER_BUCKET
    assert C == 2
    h1 = np.array([0, 0, 0, 1, 1], np.uint32)
    h2 = np.array([1, 1, 2, 3, 0], np.uint32)
    slot_of = np.array([-1, 0, 1, 2, 3], np.int64)   # bucket * C + entry
    assert _cuckoo_evict(np.array([0]), slot_of, h1, h2, 4)
    assert (slot_of >= 0).all()
    assert len(np.unique(slot_of)) == len(slot_of)
    bucket = slot_of // C
    assert ((bucket == h1) | (bucket == h2)).all()


def test_build_places_every_key(rng):
    n = 50000
    keys = np.unique(rng.integers(1, 1 << 60, size=n, dtype=np.uint64))
    khi, klo = codec.split_u64(keys)
    rank = np.arange(len(keys), dtype=np.uint32)
    t = PackedTable.build(khi, klo, rank)
    flat = t.rows.reshape(-1, 4)
    stored = (flat[:, 0].astype(np.uint64) << np.uint64(32)) | flat[:, 1]
    nz = stored[flat[:, :2].any(axis=1)]
    assert len(nz) == len(keys)
    np.testing.assert_array_equal(np.sort(nz), np.sort(keys))
    # per-bucket entry count never exceeds capacity (trivially true by
    # construction, but guard the layout math)
    assert t.rows.shape == (t.n_buckets, 4 * ENTRIES_PER_BUCKET)


def test_probe_hits_and_misses(rng):
    keys = np.unique(rng.integers(1, 1 << 60, size=20000, dtype=np.uint64))
    khi, klo = codec.split_u64(keys)
    rank = np.arange(len(keys), dtype=np.uint32)
    pos = rng.integers(0, 2**32, size=len(keys), dtype=np.uint32)
    t = PackedTable.build(khi, klo, rank, pos)
    rows = t.device_rows()

    absent = rng.integers(1, 1 << 60, size=5000, dtype=np.uint64)
    absent = absent[~np.isin(absent, keys)]
    queries = np.concatenate([keys, absent, np.zeros(3, np.uint64)])
    qhi, qlo = codec.split_u64(queries)
    miss = np.uint32(len(keys))
    found, got_rank, got_pos = probe_packed(
        rows, jnp.asarray(qhi), jnp.asarray(qlo), t.n_buckets, jnp.uint32(miss))
    found = np.asarray(found)
    got_rank = np.asarray(got_rank)
    got_pos = np.asarray(got_pos)

    nk = len(keys)
    assert found[:nk].all()
    np.testing.assert_array_equal(got_rank[:nk], rank)
    np.testing.assert_array_equal(got_pos[:nk], pos)
    assert not found[nk:].any()          # absent and zero queries miss
    assert (got_rank[nk:] == miss).all()


def test_count_packed_matches_linear(tmp_path, rng):
    from quickmer2.config import SearchConfig
    from quickmer2.pipelines import search as search_pipe
    from quickmer2.pipelines.count import DepthCounter, make_packer
    from tests import helpers

    chr1 = helpers.random_genome(rng, 20000)
    fa = str(tmp_path / "g.fa")
    helpers.write_fasta(fa, {"c1": chr1})
    dic = search_pipe.run_search(
        fa, SearchConfig(kmer_size=30, hash_size=1 << 16, edit_distance=0,
                         window_size=100), verbose=False)
    reads = helpers.simulate_reads(rng, chr1, 3000, 100)
    blob = "".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)).encode()
    codes = make_packer("fasta-lines").feed(blob)

    outs = {}
    for layout in ("linear", "packed"):
        c = DepthCounter(dic, batch_bases=1 << 16, layout=layout)
        c.feed_codes(codes)
        outs[layout] = c.finish()
    np.testing.assert_array_equal(outs["packed"], outs["linear"])
    assert outs["packed"].sum() > 0


def test_sortjoin_layout_matches_packed(rng):
    """DepthCounter(layout="sortjoin") — the random-access-free
    sort-merge-join engine — must produce bit-identical depth."""
    from quickmer2.config import SearchConfig
    from quickmer2.pipelines import search as search_pipe
    from quickmer2.pipelines.count import DepthCounter, make_packer
    from tests import helpers
    import tempfile

    chrom = helpers.random_genome(rng, 20000)
    d = tempfile.mkdtemp()
    fa = d + "/g.fa"
    helpers.write_fasta(fa, {"c1": chrom})
    dic = search_pipe.run_search(
        fa, SearchConfig(kmer_size=30, hash_size=1 << 16, edit_distance=0,
                         window_size=100), verbose=False)
    reads = helpers.simulate_reads(rng, chrom, 1500, 100)
    reads += ["".join(rng.choice(list("ACGT"), size=100)) for _ in range(40)]
    reads = helpers.mutate_reads(rng, reads, 0.01)
    blob = "".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)).encode()
    codes = make_packer("fasta-lines").feed(blob)

    a = DepthCounter(dic, batch_bases=1 << 15, layout="packed")
    b = DepthCounter(dic, batch_bases=1 << 15, layout="sortjoin")
    a.feed_codes(codes)
    b.feed_codes(codes)
    np.testing.assert_array_equal(b.finish(), a.finish())


@pytest.mark.parametrize("cap,want", [(300, "sortjoin"), (299, "mono")])
def test_auto_layout_picks_engine_by_dictionary_size(rng, monkeypatch, cap,
                                                     want):
    from quickmer2.dictionary import Dictionary
    from quickmer2.pipelines import count
    keys = np.unique(rng.integers(1, 1 << 60, size=300, dtype=np.uint64))
    assert len(keys) == 300
    dic = Dictionary.from_kmers_in_order(keys, 1 << 16, 30)
    monkeypatch.setattr(count, "AUTO_SORTJOIN_MAX_N", cap)
    assert count.DepthCounter(dic, batch_bases=1 << 12,
                              layout="auto").layout == want
