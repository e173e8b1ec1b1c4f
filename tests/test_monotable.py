"""Mono-table (single-gather) exact engine: differential vs the packed
two-choice engine on the same stream — layouts may only change speed,
never counts. The build is forced to tiny bucket counts so the side
table (overflow keys) and the unresolved drain actually run."""

import numpy as np
import pytest

from quickmer2.dictionary import Dictionary
from quickmer2.ops import codec
from quickmer2.ops.monotable import ENTRIES, MonoTable, probe_mono
from quickmer2.pipelines.count import DepthCounter
from tests import helpers

K = 30


def _world(seed, n_bases=30000):
    rng = np.random.default_rng(seed)
    chrom = helpers.random_genome(rng, n_bases)
    codes = codec.encode_bases(
        np.frombuffer(chrom.encode(), dtype=np.uint8))
    canon, valid = codec.sliding_kmers_np(codes, K)
    kmers = canon[valid & (canon != 0)]
    uniq, counts = np.unique(kmers, return_counts=True)
    keep = ~np.isin(kmers, uniq[counts > 1])
    _, first = np.unique(kmers[keep], return_index=True)
    in_order = kmers[keep][np.sort(first)]
    dic = Dictionary.from_kmers_in_order(in_order, 1 << 17, K)
    return rng, chrom, dic


def test_build_covers_all_keys_with_side_table():
    _, _, dic = _world(1)
    khi, klo = codec.split_u64(dic.kmers_in_order)
    # load 4.0 -> tiny bucket count -> heavy overflow into the side table
    mt = MonoTable.build(khi, klo, load=4.0)
    n_in_rows = int((mt.slot_rank < dic.n_kmers).sum())
    n_side = len(mt.side_rank) if mt.side_rank is not None else 0
    assert n_in_rows + n_side == dic.n_kmers
    assert n_side > 0, "load 4.0 must overflow"
    # every key is found: in the rows or via the side lookup
    found, slot, unresolved = (np.asarray(a) for a in probe_mono(
        mt.device_rows(), khi, klo, mt.n_buckets))
    sfound, srank = mt.side_lookup_np(khi[~found], klo[~found])
    assert sfound.all()
    assert unresolved[~found].all()   # overflowed keys sit in full buckets
    # ranks recovered exactly
    ranks = np.full(dic.n_kmers, -1, np.int64)
    ranks[found] = mt.slot_rank[np.asarray(slot)[found]]
    ranks[~found] = srank
    np.testing.assert_array_equal(np.sort(ranks),
                                  np.arange(dic.n_kmers))


@pytest.mark.parametrize("load", [0.5, 2.0])
def test_mono_counts_match_packed(load):
    rng, chrom, dic = _world(2)
    reads = helpers.simulate_reads(rng, chrom, 800, 100)
    reads = helpers.mutate_reads(rng, reads, 0.01)
    stream = ("\n".join(reads) + "\n").encode()
    codes = codec.encode_bases(np.frombuffer(stream, dtype=np.uint8))

    ref = DepthCounter(dic, batch_bases=1 << 14, layout="packed")
    ref.feed_codes(codes)
    truth = ref.finish()

    khi, klo = codec.split_u64(dic.kmers_in_order)
    mt = MonoTable.build(khi, klo, load=load)
    mono = DepthCounter(dic, batch_bases=1 << 14, layout="mono",
                        packed_table=mt)
    mono.feed_codes(codes)
    np.testing.assert_array_equal(mono.finish(), truth)


def test_mono_checkpoint_roundtrip():
    rng, chrom, dic = _world(3)
    reads = helpers.simulate_reads(rng, chrom, 600, 100)
    stream = ("\n".join(reads) + "\n").encode()
    codes = codec.encode_bases(np.frombuffer(stream, dtype=np.uint8))
    khi, klo = codec.split_u64(dic.kmers_in_order)
    mt = MonoTable.build(khi, klo, load=2.0)   # force side-table traffic

    full = DepthCounter(dic, batch_bases=1 << 13, layout="mono",
                        packed_table=mt)
    full.feed_codes(codes)
    truth = full.finish()

    a = DepthCounter(dic, batch_bases=1 << 13, layout="mono",
                     packed_table=mt)
    half = len(codes) // 2
    a.feed_codes(codes[:half])
    snap = a.snapshot()
    b = DepthCounter(dic, batch_bases=1 << 13, layout="mono",
                     packed_table=mt)
    b.restore(snap)
    b.feed_codes(codes[half:])
    np.testing.assert_array_equal(b.finish(), truth)
