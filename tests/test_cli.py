"""CLI smoke tests: full search→count→est→colortrack through the
command-line interface, both count modes."""

import os
import subprocess
import sys

import numpy as np
import pytest

from quickmer2.io import formats
from tests import helpers


def run_cli(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return subprocess.run([sys.executable, "-m", "quickmer2"] + args,
                          cwd=cwd, env=env, check=True, capture_output=True,
                          text=True)


@pytest.mark.parametrize("mode", ["flat", "anchored"])
def test_cli_end_to_end(tmp_path, rng, mode):
    d = str(tmp_path)
    chr1 = helpers.random_genome(rng, 30000)
    helpers.write_fasta(os.path.join(d, "g.fa"), {"c1": chr1})
    with open(os.path.join(d, "ctrl.bed"), "w") as f:
        f.write("c1\t0\t30000\n")
    reads = helpers.simulate_reads(np.random.default_rng(1), chr1, 4000, 100)
    helpers.write_fastq(os.path.join(d, "reads.fq"), reads)

    run_cli(["search", "-k", "30", "-s", "64K", "-e", "0", "-w", "100",
             "-c", "ctrl.bed", "g.fa"], d)
    assert os.path.exists(os.path.join(d, "g.fa.qm"))
    run_cli(["count", "--mode", mode, "--batch-bases", "65536",
             "g.fa", "reads.fq", "smp"], d)
    depth = formats.read_u16(os.path.join(d, "smp.bin"))
    assert depth.sum() > 0
    run_cli(["est", "g.fa", "smp", "cn.bed"], d)
    chroms, vals = formats.read_cn_bed(os.path.join(d, "cn.bed"))
    assert len(vals) > 100
    assert abs(np.mean(vals[:, 2]) - 2.0) < 0.3
    run_cli(["colortrack", "--cn", "cn.bed", "--name", "smp"], d)
    assert os.path.exists(os.path.join(d, "cn.bed.bedColor"))
    run_cli(["colorkey"], d)
    assert os.path.exists(os.path.join(d, "color-track.bed"))


def test_cli_modes_agree(tmp_path, rng):
    d = str(tmp_path)
    chr1 = helpers.random_genome(rng, 20000)
    helpers.write_fasta(os.path.join(d, "g.fa"), {"c1": chr1})
    reads = helpers.simulate_reads(np.random.default_rng(2), chr1, 2000, 100)
    helpers.write_fastq(os.path.join(d, "reads.fq"), reads)
    run_cli(["search", "-k", "30", "-s", "64K", "-e", "0", "-w", "100", "g.fa"], d)
    run_cli(["count", "--mode", "flat", "g.fa", "reads.fq", "a"], d)
    run_cli(["count", "--mode", "anchored", "g.fa", "reads.fq", "b"], d)
    np.testing.assert_array_equal(
        formats.read_u16(os.path.join(d, "a.bin")),
        formats.read_u16(os.path.join(d, "b.bin")))


def test_cli_stdin_pipe(tmp_path, rng):
    """count from a pipe, like the samtools|awk recipe (README.md:86-91)."""
    d = str(tmp_path)
    chr1 = helpers.random_genome(rng, 15000)
    helpers.write_fasta(os.path.join(d, "g.fa"), {"c1": chr1})
    reads = helpers.simulate_reads(np.random.default_rng(3), chr1, 1000, 100)
    helpers.write_reads_fasta(os.path.join(d, "reads.fa"), reads)
    run_cli(["search", "-k", "30", "-s", "64K", "-e", "0", "-w", "100", "g.fa"], d)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    with open(os.path.join(d, "reads.fa"), "rb") as f:
        subprocess.run([sys.executable, "-m", "quickmer2", "count",
                        "g.fa", "-", "piped"],
                       cwd=d, env=env, check=True, stdin=f, capture_output=True)
    run_cli(["count", "g.fa", "reads.fa", "direct"], d)
    np.testing.assert_array_equal(
        formats.read_u16(os.path.join(d, "piped.bin")),
        formats.read_u16(os.path.join(d, "direct.bin")))


def test_cli_cohort_and_json(tmp_path, rng):
    """cohort subcommand + count --json structured stats (VERDICT r2
    Weak #7 / Next #9)."""
    import json
    d = str(tmp_path)
    chr1 = helpers.random_genome(rng, 20000)
    helpers.write_fasta(os.path.join(d, "g.fa"), {"c1": chr1})
    for i in range(2):
        reads = helpers.simulate_reads(np.random.default_rng(10 + i),
                                       chr1, 1200, 100)
        helpers.write_fastq(os.path.join(d, f"s{i}.fq"), reads)
    run_cli(["search", "-k", "30", "-s", "64K", "-e", "0", "-w", "100",
             "g.fa"], d)

    out = run_cli(["count", "--json", "--mode", "anchored",
                   "--data-devices", "2", "g.fa", "s0.fq", "one"], d)
    stats = json.loads(out.stdout.strip().splitlines()[-1])
    assert stats["mode"] == "anchored"
    assert {"setup_s", "stream_s", "finish_s"} <= set(stats["phases"])
    assert stats["bytes_consumed"] > 0 and stats["n_reads"] == 1200

    out = run_cli(["cohort", "--json", "g.fa",
                   "s0.fq:c0", "s1.fq:c1"], d)
    rows = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(rows) == 2
    np.testing.assert_array_equal(
        formats.read_u16(os.path.join(d, "one.bin")),
        formats.read_u16(os.path.join(d, "c0.bin")))
