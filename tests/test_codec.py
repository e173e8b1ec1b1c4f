"""Codec unit + property tests (host/device agreement, reference parity)."""

import numpy as np
import pytest

from quickmer2.ops import codec
from tests import helpers


def test_base_encoding_matches_reference_formula():
    # (c >> 1) & 3 → A=0, C=1, T=2, G=3 (QuicKmer.c:54)
    for ch, want in [("A", 0), ("C", 1), ("T", 2), ("G", 3),
                     ("a", 0), ("c", 1), ("t", 2), ("g", 3)]:
        assert codec.encode_bases(ch.encode())[0] == want
    assert codec.encode_bases(b"N")[0] == codec.SEP
    assert codec.encode_bases(b"\n>x")[0] == codec.SEP


def test_kmer_string_roundtrip():
    s = "ACGTACGTACGTACGTACGTACGTACGTAC"  # 30-mer
    code = codec.encode_kmer_string(s)
    rc = helpers.revcomp(s)
    assert codec.encode_kmer_string(rc) == code  # canonical invariance
    k = len(s)
    fwd = 0
    for c in s:
        fwd = (fwd << 2) | int(codec.encode_bases(c.encode())[0])
    assert code == min(fwd, codec.revcomp_code(fwd, k))
    assert codec.decode_kmer(fwd, k) == s


@pytest.mark.parametrize("k", [3, 15, 16, 17, 30, 31, 32])
def test_sliding_np_matches_slow_oracle(rng, k):
    seq = helpers.random_genome(rng, 300)
    seq = seq[:100] + "N" + seq[100:]  # inject an invalid base
    codes = codec.encode_bases(seq.encode())
    canon, valid = codec.sliding_kmers_np(codes, k)
    oracle = helpers.canonical_kmers_of(seq, k)
    assert len(canon) == len(oracle)
    for i, want in enumerate(oracle):
        if want is None:
            assert not valid[i]
        else:
            assert valid[i]
            assert int(canon[i]) == want


@pytest.mark.parametrize("k", [3, 15, 30, 32])
def test_window_kmers_np_matches_sliding(rng, k):
    codes = codec.encode_bases(helpers.random_genome(rng, 2000).encode())
    canon, _ = codec.sliding_kmers_np(codes, k)
    starts = rng.choice(len(canon), size=300, replace=False)
    np.testing.assert_array_equal(codec.window_kmers_np(codes, starts, k),
                                  canon[starts])


@pytest.mark.parametrize("k", [15, 16, 17, 30, 32])
def test_device_matches_host(rng, k):
    seq = helpers.random_genome(rng, 4096)
    codes = codec.encode_bases(seq.encode())
    codes[50:60] = codec.SEP
    canon, valid = codec.sliding_kmers_np(codes, k)
    chi, clo, dvalid = codec.sliding_kmers(codes, k)
    np.testing.assert_array_equal(np.asarray(dvalid), valid)
    got = codec.join_u64(np.asarray(chi), np.asarray(clo))
    np.testing.assert_array_equal(got[valid], canon[valid])


def test_canonical_invariance_property(rng):
    # canonical(s) == canonical(revcomp(s)) for random sequences
    for _ in range(20):
        s = helpers.random_genome(rng, 30)
        assert codec.encode_kmer_string(s) == codec.encode_kmer_string(helpers.revcomp(s))
