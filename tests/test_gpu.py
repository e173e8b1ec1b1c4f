"""Checks that need the GPU (marker `gpu`). They skip on other devices;
`python chip_smoke.py` runs them on the card, in its own process."""

import numpy as np
import pytest

import chip_smoke
from tests import helpers
from tests.test_hamming_join import _world, brute_sums

pytestmark = pytest.mark.gpu


def test_device_is_a_gpu_with_memory_stats(gpu):
    import jax
    import jax.numpy as jnp
    stats = gpu.memory_stats()
    assert stats["bytes_limit"] > 0
    x = jnp.arange(1 << 20, dtype=jnp.uint32)
    assert x.devices() == {gpu}
    assert int(jax.jit(lambda v: (v & 7).sum())(x)) == 7 * (1 << 20) // 2


@pytest.mark.parametrize("engine", ["mono", "sortjoin", "packed", "linear",
                                    "anchored", "sharded"])
def test_counter_matches_host_reference_on_gpu(gpu, engine):
    g, kmers, pos, reads = helpers.smoke_world(n_bases=200_000,
                                               n_reads=20_000)
    want = chip_smoke.host_depth_reference(reads, kmers)
    got = helpers.count_reads(engine, g, kmers, pos, reads,
                              device_build=True)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,e", [(15, 2), (30, 2)])
def test_hamming_join_matches_bruteforce_on_gpu(gpu, rng, k, e):
    from quickmer2.ops.hamming_join import hamming_neighbor_sums
    uniq, occ, cmap = _world(rng, k, 2500)
    targets = uniq[occ == 1][:300]
    got = hamming_neighbor_sums(targets, uniq, occ, k, e, cpad=8)
    np.testing.assert_array_equal(got, brute_sums(targets.tolist(), cmap,
                                                  k, e))
