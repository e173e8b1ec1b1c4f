"""chip_smoke.py on the CPU: its host references agree with the
counters and the brute force of the tests, the whole CLI path passes
its checks at test size, and the script itself refuses to run without a
GPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from tests import helpers
from tests.test_hamming_join import _world, brute_sums

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("engine",
                         ["mono", "sortjoin", "packed", "linear", "anchored"])
def test_host_reference_matches_counter(engine):
    g, kmers, pos, reads = helpers.smoke_world()
    want = chip_smoke.host_depth_reference(reads, kmers, chunk_reads=700)
    assert want.sum() > 0
    got = helpers.count_reads(engine, g, kmers, pos, reads)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,e", [(15, 1), (15, 2), (30, 2)])
def test_brute_neighbor_sums_matches_test_bruteforce(rng, k, e):
    uniq, occ, cmap = _world(rng, k, 2500)
    targets = uniq[occ == 1][:200]
    np.testing.assert_array_equal(
        chip_smoke.brute_neighbor_sums(targets, uniq, occ, k, e),
        brute_sums(targets.tolist(), cmap, k, e))


def test_phase_a_cli_path_at_test_size(tmp_path):
    """search -e 2 -> count flat -> count anchored -> est through the
    CLI, every .bin against the host reference (the copy-number bounds
    are checked only at full size, where windows average enough)."""
    sizes = chip_smoke.Sizes(a_bases=150_000, a_coverage=8.0,
                             n_neighbor_targets=300)
    report = {}
    chip_smoke.phase_a(str(tmp_path), sizes, report)
    r = report["phase_a"]
    assert r["n_kmers"] > 100_000
    assert r["qai_build_s"] > 0


def test_phase_b_at_test_size(tmp_path):
    """The flat count through the CLI equals the host reference, and the
    traced counter is left built for the trace."""
    sizes = chip_smoke.Sizes(b_bases=300_000, b_reads=5000)
    report = {}
    b = chip_smoke.phase_b(str(tmp_path), sizes, report)
    assert report["phase_b"]["n_kmers"] == b["n_kmers"] > 250_000
    assert b["ref"].sum() > 0
    assert b["counter"].layout == "mono"


def test_host_depth_references_match_one_at_a_time():
    g, kmers, _, reads = helpers.smoke_world()
    dicts = [kmers, kmers[::3], kmers[:50]]
    for got, d in zip(chip_smoke.host_depth_references(reads, dicts,
                                                       chunk_reads=700),
                      dicts):
        np.testing.assert_array_equal(
            got, chip_smoke.host_depth_reference(reads, d, chunk_reads=5000))


def test_engine_crossover_at_test_size():
    """Both engines equal the host reference on reads that mostly miss
    the dictionary, and the report carries the hit rate and both rates."""
    sizes = chip_smoke.Sizes(crossover_ns=(1 << 10,), crossover_bases=1 << 17,
                             crossover_genome=1 << 18, crossover_reps=2)
    report = {}
    chip_smoke.engine_crossover(sizes, report)
    (row,) = report["crossover"]
    assert row["n"] == 1 << 10
    assert 0 < row["hit_rate"] < 0.05
    assert row["mono_kmers_per_s"] > 0 and row["sortjoin_kmers_per_s"] > 0


def test_device_footprint_covers_every_device():
    import jax
    import jax.numpy as jnp
    with chip_smoke.DeviceFootprint(period=0.001) as fp:
        jnp.ones(1 << 16).block_until_ready()
    assert len(fp.bytes) == len(jax.local_devices())
    assert all(b >= 0 for b in fp.bytes)


def _run_smoke(cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_smoke_refuses_cpu():
    r = _run_smoke(ROOT)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_smoke_alone_fails(tmp_path):
    """Copied away from the repository, the script cannot import the
    program and must fail whatever the device."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run_smoke(str(tmp_path))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.parametrize("env_set", [True, False], ids=["env-set", "env-unset"])
def test_compile_cache_placement(tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR wins and nothing else is set; without
    it the cache lands at one fixed path inside the checkout."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cc")
    r = subprocess.run(
        [sys.executable, "-c",
         "import quickmer2, jax; print(jax.config.jax_compilation_cache_dir)"],
        cwd=str(tmp_path), env=dict(env, PYTHONPATH=ROOT),
        capture_output=True, text=True, check=True, timeout=120)
    want = (str(tmp_path / "cc") if env_set
            else os.path.join(ROOT, ".jax_cache"))
    assert r.stdout.strip().splitlines()[-1] == want
