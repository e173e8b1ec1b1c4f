"""Multi-process distributed count: real jax.distributed with CPU
processes, result must be bit-identical to single-process."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from quickmer2.io import formats
from tests import helpers

WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, {repo!r})
from quickmer2.parallel import distributed as dist
dist.initialize({coord!r}, {n}, int(sys.argv[1]))
stats = dist.run_count_distributed({qm!r}, {sample!r},
                                   {out!r} + "." + sys.argv[1],
                                   batch_bases=1 << 16, verbose=False,
                                   mode={mode!r}, ref_fasta={ref!r})
# every process writes its shard info; process 0 wrote the artifacts
print("SHARD", jax.process_index(), stats["shard"])
"""


WORKER_CKPT = r"""
import os, sys, time
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, {repo!r})
from quickmer2.parallel import distributed as dist
from quickmer2.utils import checkpoint as ckpt

if {die!r}:
    # die right after the FIRST checkpoint lands on disk — simulates a
    # process killed mid-stream (SURVEY.md section 5.4's 75G-of-81G
    # scenario); the bytes consumed after that save are lost and must
    # be re-counted on resume. Every process checkpoints before any dies,
    # and process 0, which hosts the coordination service, dies last: a
    # peer that loses the service first aborts with its own exit code.
    real_save = ckpt.save
    def dying_save(path, *a, **kw):
        real_save(path, *a, **kw)
        base = path.rsplit(".p", 1)[0]
        t0 = time.time()
        while (not all(os.path.exists(f"{{base}}.p{{i}}") for i in range({n}))
               and time.time() - t0 < 60):
            time.sleep(0.05)
        if sys.argv[1] == "0":
            time.sleep(2.0)
        os._exit(17)
    ckpt.save = dying_save

dist.initialize({coord!r}, {n}, int(sys.argv[1]))
stats = dist.run_count_distributed({qm!r}, {sample!r},
                                   {out!r} + "." + sys.argv[1],
                                   batch_bases=1 << 16, verbose=False,
                                   mode="flat",
                                   checkpoint_path={ckpt_path!r},
                                   checkpoint_every_bytes=30000,
                                   chunk_bytes=20000)
print("DONE", jax.process_index(), stats["shard"], stats["total_windows"])
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("fmt", ["fasta", "fastq"])
def test_two_process_count_matches_single(tmp_path, rng, fmt):
    d = str(tmp_path)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    chr1 = helpers.random_genome(rng, 20000)
    fa = os.path.join(d, "g.fa")
    helpers.write_fasta(fa, {"c1": chr1})
    from quickmer2.config import SearchConfig
    from quickmer2.pipelines import search as search_pipe
    search_pipe.run_search(fa, SearchConfig(kmer_size=30, hash_size=1 << 16,
                                            edit_distance=0, window_size=100),
                           verbose=False)
    reads = helpers.simulate_reads(np.random.default_rng(4), chr1, 2500, 100)
    sample = os.path.join(d, "reads." + fmt)
    if fmt == "fastq":
        helpers.write_fastq(sample, reads)
    else:
        helpers.write_reads_fasta(sample, reads)

    # single-process truth
    from quickmer2.pipelines.count import run_count
    run_count(fa + ".qm", sample, os.path.join(d, "single"),
              batch_bases=1 << 16, verbose=False)
    truth = formats.read_u16(os.path.join(d, "single.bin"))

    coord = f"127.0.0.1:{_free_port()}"
    script = WORKER.format(repo=repo, coord=coord, n=2, qm=fa + ".qm",
                           sample=sample, out=os.path.join(d, "multi"),
                           mode="flat", ref=None)
    procs = [subprocess.Popen([sys.executable, "-c", script, str(i)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for i in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()[-2000:]
    multi = formats.read_u16(os.path.join(d, "multi.0.bin"))
    np.testing.assert_array_equal(multi, truth)


def test_two_process_anchored_matches_single(tmp_path, rng):
    """Multi-host ANCHORED count (VERDICT r2 Missing #5 / Next #4):
    each process loads the shared .qai, runs the fast path on its
    record-aligned shard — mixed-length reads included, so the
    per-host overflow routing runs too — and the all-reduced result is
    bit-identical to a single-process flat count."""
    d = str(tmp_path)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    chr1 = helpers.random_genome(rng, 20000)
    fa = os.path.join(d, "g.fa")
    helpers.write_fasta(fa, {"c1": chr1})
    from quickmer2.config import SearchConfig
    from quickmer2.pipelines import search as search_pipe
    search_pipe.run_search(fa, SearchConfig(kmer_size=30, hash_size=1 << 16,
                                            edit_distance=0, window_size=100),
                           verbose=False)
    srng = np.random.default_rng(6)
    reads = helpers.simulate_reads(srng, chr1, 2000, 100)
    reads += helpers.simulate_reads(srng, chr1, 8, 2000)   # overflow rows
    reads = helpers.mutate_reads(srng, reads, 0.004)       # spill paths
    sample = os.path.join(d, "reads.fq")
    helpers.write_fastq(sample, reads)

    from quickmer2.pipelines.count import run_count
    run_count(fa + ".qm", sample, os.path.join(d, "single"),
              batch_bases=1 << 16, verbose=False)
    truth = formats.read_u16(os.path.join(d, "single.bin"))

    coord = f"127.0.0.1:{_free_port()}"
    script = WORKER.format(repo=repo, coord=coord, n=2, qm=fa + ".qm",
                           sample=sample, out=os.path.join(d, "multi"),
                           mode="anchored", ref=fa)
    procs = [subprocess.Popen([sys.executable, "-c", script, str(i)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for i in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()[-2000:]
    assert os.path.exists(fa + ".qai")
    multi = formats.read_u16(os.path.join(d, "multi.0.bin"))
    np.testing.assert_array_equal(multi, truth)


def test_distributed_checkpoint_resume(tmp_path, rng):
    """Kill both processes right after their first checkpoint lands,
    rerun with the same flags: each process resumes from its own
    per-process checkpoint file and the merged .bin is bit-identical to
    an uninterrupted single-process run (VERDICT r3 Next #5)."""
    d = str(tmp_path)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    chr1 = helpers.random_genome(rng, 20000)
    fa = os.path.join(d, "g.fa")
    helpers.write_fasta(fa, {"c1": chr1})
    from quickmer2.config import SearchConfig
    from quickmer2.pipelines import search as search_pipe
    search_pipe.run_search(fa, SearchConfig(kmer_size=30, hash_size=1 << 16,
                                            edit_distance=0, window_size=100),
                           verbose=False)
    reads = helpers.simulate_reads(np.random.default_rng(9), chr1, 3000, 100)
    sample = os.path.join(d, "reads.fq")
    helpers.write_fastq(sample, reads)

    from quickmer2.pipelines.count import run_count
    run_count(fa + ".qm", sample, os.path.join(d, "single"),
              batch_bases=1 << 16, verbose=False)
    truth = formats.read_u16(os.path.join(d, "single.bin"))

    ckpt_path = os.path.join(d, "dist.ckpt")
    # phase 1: both processes die after their first checkpoint save
    coord = f"127.0.0.1:{_free_port()}"
    script = WORKER_CKPT.format(repo=repo, coord=coord, n=2, qm=fa + ".qm",
                                sample=sample, out=os.path.join(d, "multi"),
                                ckpt_path=ckpt_path, die=True)
    procs = [subprocess.Popen([sys.executable, "-c", script, str(i)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for i in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 17, (p.returncode, err.decode()[-2000:])
    assert os.path.exists(ckpt_path + ".p0")
    assert os.path.exists(ckpt_path + ".p1")
    assert not os.path.exists(os.path.join(d, "multi.0.bin"))

    # phase 2: rerun — each process resumes from its own checkpoint
    coord = f"127.0.0.1:{_free_port()}"
    script = WORKER_CKPT.format(repo=repo, coord=coord, n=2, qm=fa + ".qm",
                                sample=sample, out=os.path.join(d, "multi"),
                                ckpt_path=ckpt_path, die=False)
    procs = [subprocess.Popen([sys.executable, "-c", script, str(i)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for i in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()[-2000:]
        assert b"resumed at shard byte" not in out  # verbose=False
    multi = formats.read_u16(os.path.join(d, "multi.0.bin"))
    np.testing.assert_array_equal(multi, truth)
    # checkpoints are consumed on success
    assert not os.path.exists(ckpt_path + ".p0")
    assert not os.path.exists(ckpt_path + ".p1")
