"""Hash/probe unit tests: DJB parity, host/device/native agreement."""

import numpy as np

from quickmer2.ops import codec, hash as qhash
from quickmer2.utils import native


def djb_slow(kmer: int) -> int:
    # independent model of QuicKmer.c:66-76
    h = 5381
    for _ in range(8):
        h = (h * 33 + (kmer & 0xFF)) & 0xFFFFFFFFFFFFFFFF
        kmer >>= 8
    return h


def test_djb_low32_parity(rng):
    keys = rng.integers(0, 1 << 60, size=256, dtype=np.uint64)
    got = qhash.djb_u64_np(keys)
    for k, g in zip(keys, got):
        assert int(g) == (djb_slow(int(k)) & 0xFFFFFFFF)
    hi, lo = codec.split_u64(keys)
    np.testing.assert_array_equal(qhash.djb_pair_np(hi, lo), got)
    import jax.numpy as jnp
    np.testing.assert_array_equal(
        np.asarray(qhash.djb_pair(jnp.asarray(hi), jnp.asarray(lo))), got)


def test_insert_lookup_roundtrip(rng):
    H = 1 << 12
    keys = rng.integers(1, 1 << 60, size=1500, dtype=np.uint64)
    keys = np.unique(keys)
    table = qhash.build_table_np(keys, H)
    assert (table != 0).sum() == len(keys)
    slots, found = qhash.probe_lookup_np(table, keys, H)
    assert found.all()
    np.testing.assert_array_equal(table[slots], keys)
    # absent keys must not be found
    absent = rng.integers(1, 1 << 60, size=500, dtype=np.uint64)
    absent = absent[~np.isin(absent, keys)]
    _, found2 = qhash.probe_lookup_np(table, absent, H)
    assert not found2.any()


def test_native_matches_python(rng):
    assert native.available(), "native lib failed to build"
    H = 1 << 12
    keys = np.unique(rng.integers(1, 1 << 60, size=2000, dtype=np.uint64))
    t_py = np.zeros(H, np.uint64)
    slots_py = qhash.probe_insert_np(t_py, keys, H)
    t_c = np.zeros(H, np.uint64)
    slots_c = native.insert_keys(t_c, keys, return_slots=True)
    np.testing.assert_array_equal(t_py, t_c)
    np.testing.assert_array_equal(slots_py, slots_c)
    queries = np.concatenate([keys[:100], rng.integers(1, 1 << 60, size=100, dtype=np.uint64)])
    s1, f1 = qhash.probe_lookup_np(t_py, queries, H)
    s2, f2 = native.lookup_keys(t_c, queries)
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(f1, f2)


def test_device_probe_matches_host(rng):
    import jax.numpy as jnp
    H = 1 << 12
    keys = np.unique(rng.integers(1, 1 << 60, size=1800, dtype=np.uint64))
    table = qhash.build_table_np(keys, H)
    queries = np.concatenate([keys, rng.integers(1, 1 << 60, size=1000, dtype=np.uint64)])
    s_host, f_host = qhash.probe_lookup_np(table, queries, H)
    thi, tlo = codec.split_u64(table)
    qhi, qlo = codec.split_u64(queries)
    s_dev, f_dev = qhash.probe_lookup(jnp.asarray(thi), jnp.asarray(tlo),
                                      jnp.asarray(qhi), jnp.asarray(qlo), H)
    np.testing.assert_array_equal(np.asarray(f_dev), f_host)
    np.testing.assert_array_equal(np.asarray(s_dev), s_host)


def test_kmer_zero_finds_empty_slot(rng):
    # Quirk Q3: key 0 "matches" the first empty slot
    H = 1 << 8
    keys = np.unique(rng.integers(1, 1 << 60, size=50, dtype=np.uint64))
    table = qhash.build_table_np(keys, H)
    _, found = qhash.probe_lookup_np(table, np.zeros(1, np.uint64), H)
    assert found[0]  # found, but at an empty slot — caller masks via rank map
