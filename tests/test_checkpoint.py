"""Count checkpoint/resume: a run interrupted mid-stream and resumed
from its checkpoint must produce a byte-identical .bin — for flat,
anchored, device-sharded, and stdin-streamed counts (VERDICT r2 #7)."""

import builtins
import io
import os
import sys

import numpy as np
import pytest

from quickmer2.config import SearchConfig
from quickmer2.io import formats
from quickmer2.pipelines import search as search_pipe
from quickmer2.pipelines.count import run_count
from tests import helpers


class Bomb(Exception):
    pass


class LimitedFile:
    """Raises Bomb after n_reads read() calls — simulates a crash."""

    def __init__(self, f, n_reads):
        self._f = f
        self._left = n_reads

    def read(self, n):
        if self._left <= 0:
            raise Bomb()
        self._left -= 1
        return self._f.read(n)

    def seek(self, n):
        return self._f.seek(n)

    def close(self):
        return self._f.close()


def _interrupted_then_resumed(sample, out_part, out_resumed, n_reads,
                              **run_kw):
    """Run count with a read-limited stream until it bombs, assert a
    checkpoint exists, then resume to completion."""
    ckpt = run_kw["checkpoint_path"]
    real = builtins.open

    def patched(path, *a, **k):
        f = real(path, *a, **k)
        if path == sample:
            return LimitedFile(f, n_reads)
        return f

    builtins.open = patched
    try:
        with pytest.raises(Bomb):
            run_count(sample_path=sample, out_prefix=out_part, **run_kw)
    finally:
        builtins.open = real
    assert os.path.exists(ckpt), "no checkpoint written before interrupt"
    run_count(sample_path=sample, out_prefix=out_resumed, **run_kw)
    assert not os.path.exists(ckpt)  # cleaned up on success


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(5)
    d = str(tmp_path_factory.mktemp("ckpt"))
    chr1 = helpers.random_genome(rng, 20000)
    fa = os.path.join(d, "g.fa")
    helpers.write_fasta(fa, {"c1": chr1})
    search_pipe.run_search(fa, SearchConfig(kmer_size=30, hash_size=1 << 16,
                                            edit_distance=0, window_size=100),
                           verbose=False)
    # mixed lengths: 100 bp (anchored rows) + a few 2000 bp (overflow →
    # flat side-counter), plus 0.5% errors so the anchored path spills
    reads = helpers.simulate_reads(np.random.default_rng(9), chr1, 3000, 100)
    reads += helpers.simulate_reads(np.random.default_rng(10), chr1, 20, 2000)
    reads = helpers.mutate_reads(np.random.default_rng(11), reads, 0.005)
    sample = os.path.join(d, "reads.fq")
    helpers.write_fastq(sample, reads)
    return {"dir": d, "fa": fa, "sample": sample}


def _truth(world, tmp_path, **kw):
    out = os.path.join(str(tmp_path), "truth")
    run_count(world["fa"] + ".qm", world["sample"], out,
              batch_bases=1 << 15, verbose=False, **kw)
    return formats.read_u16(out + ".bin")


@pytest.mark.parametrize("mode,data_devices", [
    ("flat", None),
    ("anchored", None),
    ("flat", 4),
    ("anchored", 2),
])
def test_resume_matches_uninterrupted(world, tmp_path, mode, data_devices):
    d = str(tmp_path)
    truth = _truth(world, tmp_path)
    ckpt = os.path.join(d, "count.ckpt")
    kw = dict(qm_path=world["fa"] + ".qm", batch_bases=1 << 13,
              chunk_bytes=50_000, verbose=False, mode=mode,
              ref_fasta=world["fa"], data_devices=data_devices,
              checkpoint_path=ckpt, checkpoint_every_bytes=100_000)
    _interrupted_then_resumed(world["sample"], os.path.join(d, "part"),
                              os.path.join(d, "resumed"), n_reads=5, **kw)
    resumed = formats.read_u16(os.path.join(d, "resumed.bin"))
    np.testing.assert_array_equal(resumed, truth)


class LimitedStdin:
    def __init__(self, data, n_reads):
        self.buffer = LimitedFile(io.BytesIO(data), n_reads)


def test_resume_from_stdin(world, tmp_path, monkeypatch):
    """stdin streams checkpoint on consumed-byte count; resume replays
    the pipe and fast-forwards past the consumed prefix."""
    d = str(tmp_path)
    truth = _truth(world, tmp_path)
    data = open(world["sample"], "rb").read()
    ckpt = os.path.join(d, "count.ckpt")
    kw = dict(batch_bases=1 << 15, chunk_bytes=50_000, verbose=False,
              checkpoint_path=ckpt, checkpoint_every_bytes=100_000)

    monkeypatch.setattr(sys, "stdin", LimitedStdin(data, 5))
    with pytest.raises(Bomb):
        run_count(world["fa"] + ".qm", "-", os.path.join(d, "part"), **kw)
    assert os.path.exists(ckpt)

    monkeypatch.setattr(sys, "stdin", LimitedStdin(data, 10 ** 9))
    run_count(world["fa"] + ".qm", "-", os.path.join(d, "resumed"), **kw)
    resumed = formats.read_u16(os.path.join(d, "resumed.bin"))
    np.testing.assert_array_equal(resumed, truth)
