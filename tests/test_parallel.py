"""Multi-device sharded count tests on the 8-device virtual CPU mesh."""

import numpy as np
import pytest

import jax

from quickmer2.config import SearchConfig
from quickmer2.parallel.count_parallel import ShardedDepthCounter
from quickmer2.parallel.mesh import make_mesh
from quickmer2.pipelines import search as search_pipe
from quickmer2.pipelines.count import DepthCounter, make_packer
from tests import helpers

K = 30


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    rng = np.random.default_rng(3)
    d = tmp_path_factory.mktemp("par")
    chr1 = helpers.random_genome(rng, 40000)
    fa = str(d / "g.fa")
    helpers.write_fasta(fa, {"c1": chr1})
    cfg = SearchConfig(kmer_size=K, hash_size=1 << 16, edit_distance=0,
                       window_size=100)
    dic = search_pipe.run_search(fa, cfg, verbose=False)
    reads = helpers.simulate_reads(rng, chr1, 6000, 100)
    packer = make_packer("fasta-lines")
    blob = "".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)).encode()
    codes = packer.feed(blob)
    return {"dict": dic, "codes": codes}


@pytest.fixture(scope="module")
def single_device_depth(setup):
    c = DepthCounter(setup["dict"], batch_bases=1 << 16)
    c.feed_codes(setup["codes"])
    return c.finish()


def test_eight_devices_available():
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"


@pytest.mark.parametrize("dp,ds", [(8, 1), (1, 8), (4, 2), (2, 4)])
def test_sharded_count_matches_single_device(setup, single_device_depth, dp, ds):
    mesh = make_mesh(dp, ds)
    c = ShardedDepthCounter(setup["dict"], mesh, batch_bases=1 << 16)
    c.feed_codes(setup["codes"])
    depth = c.finish()
    np.testing.assert_array_equal(depth, single_device_depth)


def test_sharded_determinism(setup):
    mesh = make_mesh(2, 4)
    outs = []
    for _ in range(2):
        c = ShardedDepthCounter(setup["dict"], mesh, batch_bases=1 << 15)
        c.feed_codes(setup["codes"])
        outs.append(c.finish())
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.fixture(scope="module")
def anchored_setup(tmp_path_factory):
    """Genome + index + mixed clean/error/garbage reads that exercise
    all three tiers of the anchored counter."""
    from quickmer2.ops.anchored import AnchoredIndex, rows_from_flat_codes

    rng = np.random.default_rng(9)
    d = tmp_path_factory.mktemp("apar")
    chr1 = helpers.random_genome(rng, 30000)
    fa = str(d / "g.fa")
    helpers.write_fasta(fa, {"c1": chr1})
    cfg = SearchConfig(kmer_size=K, hash_size=1 << 16, edit_distance=0,
                       window_size=100)
    dic = search_pipe.run_search(fa, cfg, verbose=False)
    index = AnchoredIndex.from_dictionary_and_fasta(dic, fa)

    reads = helpers.simulate_reads(rng, chr1, 2000, 100)
    # inject errors into a third of the reads; add garbage reads
    for i in range(0, len(reads), 3):
        r = list(reads[i])
        for p in rng.integers(0, 100, size=rng.integers(1, 4)):
            r[p] = "ACGT"[rng.integers(0, 4)]
        reads[i] = "".join(r)
    reads += ["".join(rng.choice(list("ACGT"), size=100)) for _ in range(50)]
    blob = "".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)).encode()
    codes = make_packer("fasta-lines").feed(blob)
    rows = rows_from_flat_codes(codes, 100)
    return {"dict": dic, "index": index, "rows": rows, "codes": codes}


@pytest.mark.parametrize("dp,ds", [(1, 1), (2, 1), (4, 1), (8, 1),
                                   (1, 8), (2, 4), (4, 2)])
def test_anchored_sharded_matches(anchored_setup, single_anchored_depth,
                                  dp, ds):
    """All mesh shapes — including dict-sharded rows (ds > 1, the >HBM
    escape: bucket blocks per device, anchor psum, local dirty/exact
    scatters) — must be bit-identical to the single-device counter."""
    from quickmer2.parallel.anchored_parallel import ShardedAnchoredCounter
    mesh = make_mesh(dp, ds)
    c = ShardedAnchoredCounter(anchored_setup["index"], K, 100, mesh,
                               batch_reads=512)
    c.feed_reads(anchored_setup["rows"])
    np.testing.assert_array_equal(c.finish(), single_anchored_depth)


@pytest.fixture(scope="module")
def single_anchored_depth(anchored_setup):
    from quickmer2.ops.anchored import AnchoredDepthCounter
    c = AnchoredDepthCounter(anchored_setup["index"], K, 100,
                             batch_reads=512)
    c.feed_reads(anchored_setup["rows"])
    depth = c.finish()
    # cross-check against the flat path: anchored must be exact
    flat = DepthCounter(anchored_setup["dict"], batch_bases=1 << 16)
    flat.feed_codes(anchored_setup["codes"])
    np.testing.assert_array_equal(depth, flat.finish())
    return depth


@pytest.mark.parametrize("mode", ["flat", "anchored"])
def test_run_count_data_devices(tmp_path, anchored_setup, mode):
    """run_count(data_devices=4) must be bit-identical to single-device
    for both modes (end-to-end through the file pipeline)."""
    from quickmer2.io import formats
    from quickmer2.pipelines.count import run_count

    rng = np.random.default_rng(13)
    d = str(tmp_path)
    chrom = helpers.random_genome(rng, 20000)
    fa = d + "/g.fa"
    helpers.write_fasta(fa, {"c1": chrom})
    search_pipe.run_search(
        fa, SearchConfig(kmer_size=K, hash_size=1 << 16, edit_distance=0,
                         window_size=100), verbose=False)
    reads = helpers.simulate_reads(rng, chrom, 1500, 100)
    fq = d + "/reads.fq"
    helpers.write_fastq(fq, reads)

    kw = dict(verbose=False, mode=mode,
              ref_fasta=fa if mode == "anchored" else None)
    run_count(fa + ".qm", fq, d + "/one", **kw)
    run_count(fa + ".qm", fq, d + "/four", data_devices=4, **kw)
    np.testing.assert_array_equal(formats.read_u16(d + "/four.bin"),
                                  formats.read_u16(d + "/one.bin"))


@pytest.mark.parametrize("mode", ["flat", "anchored"])
def test_run_count_dict_devices(tmp_path, mode):
    """run_count(dict_devices=4): dictionary bucket-block sharding
    through the file pipeline, bit-identical to single-device."""
    from quickmer2.io import formats
    from quickmer2.pipelines.count import run_count

    rng = np.random.default_rng(17)
    d = str(tmp_path)
    chrom = helpers.random_genome(rng, 20000)
    fa = d + "/g.fa"
    helpers.write_fasta(fa, {"c1": chrom})
    search_pipe.run_search(
        fa, SearchConfig(kmer_size=K, hash_size=1 << 16, edit_distance=0,
                         window_size=100), verbose=False)
    reads = helpers.mutate_reads(
        rng, helpers.simulate_reads(rng, chrom, 1200, 100), 0.005)
    fq = d + "/reads.fq"
    helpers.write_fastq(fq, reads)

    kw = dict(verbose=False, mode=mode,
              ref_fasta=fa if mode == "anchored" else None)
    run_count(fa + ".qm", fq, d + "/one", **kw)
    run_count(fa + ".qm", fq, d + "/dict4", dict_devices=4, **kw)
    run_count(fa + ".qm", fq, d + "/both", data_devices=2, dict_devices=2,
              **kw)
    np.testing.assert_array_equal(formats.read_u16(d + "/dict4.bin"),
                                  formats.read_u16(d + "/one.bin"))
    np.testing.assert_array_equal(formats.read_u16(d + "/both.bin"),
                                  formats.read_u16(d + "/one.bin"))
