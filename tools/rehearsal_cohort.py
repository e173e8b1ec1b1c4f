"""Cohort rehearsal (VERDICT r4 Next #8 — second half of BASELINE
config 5): N samples through run_cohort against ONE shared dictionary +
anchored index, vs the same samples through per-sample run_count (which
rebuilds/loads everything per invocation like the reference binary
does). Records per-sample wall times so the index-build amortization is
visible, and asserts the cohort outputs match the individual runs.

Usage: python tools/rehearsal_cohort.py [n_mbases] [n_samples] [coverage]
Prints one JSON object.
"""

import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools.realistic_genome import make_genome, to_fasta  # noqa: E402
from tools.rehearsal import simulate_reads_codes, write_fastq_codes  # noqa: E402


def main():
    from quickmer2.config import SearchConfig
    from quickmer2.io import formats
    from quickmer2.pipelines import search as search_pipe
    from quickmer2.pipelines.cohort import run_cohort
    from quickmer2.pipelines.count import run_count

    args = sys.argv[1:]
    mb = float(args[0]) if args else 4.0
    n_samples = int(args[1]) if len(args) > 1 else 4
    coverage = float(args[2]) if len(args) > 2 else 15.0
    n_bases = int(mb * 1e6)
    read_len = 150
    out = {"config": "cohort", "n_samples": n_samples,
           "genome_bases": n_bases, "coverage": coverage}
    rng = np.random.default_rng(3)
    d = tempfile.mkdtemp(prefix="rehearsal-cohort-")

    g, dup_start, dup_len = make_genome(rng, n_bases, n_bases // 40, 2)
    fa = os.path.join(d, "g.fa")
    to_fasta(fa, g)

    t0 = time.time()
    search_pipe.run_search(
        fa, SearchConfig(kmer_size=30, hash_size=1 << 20, edit_distance=0,
                         window_size=1000), verbose=False)
    out["search_s"] = round(time.time() - t0, 1)

    samples = []
    n_reads = int(coverage * len(g) / read_len)
    for i in range(n_samples):
        srng = np.random.default_rng(50 + i)
        reads = simulate_reads_codes(srng, g, n_reads, read_len, 0.003)
        p = os.path.join(d, f"s{i}.fq")
        write_fastq_codes(p, reads)
        samples.append(p)
    out["n_reads_per_sample"] = n_reads

    # individual counts: each run_count pays its own setup (dictionary
    # load, .qai build on the first, .qai load on the rest)
    for f in (fa + ".qai",):
        if os.path.exists(f):
            os.remove(f)
    t0 = time.time()
    indiv_walls = []
    for i, p in enumerate(samples):
        t1 = time.time()
        run_count(fa + ".qm", p, os.path.join(d, f"i{i}"), verbose=False,
                  mode="anchored", ref_fasta=fa)
        indiv_walls.append(round(time.time() - t1, 2))
    out["individual_walls_s"] = indiv_walls
    out["individual_total_s"] = round(time.time() - t0, 1)

    # cohort: one shared dictionary + index across all samples
    t0 = time.time()
    pairs = [(p, os.path.join(d, f"c{i}")) for i, p in enumerate(samples)]
    stats = run_cohort(fa + ".qm", pairs, mode="anchored", ref_fasta=fa,
                       verbose=False)
    out["cohort_total_s"] = round(time.time() - t0, 1)
    out["cohort_sample_walls_s"] = [s["elapsed_s"] for s in stats]
    out["cohort_setup_s"] = round(
        out["cohort_total_s"] - sum(s["elapsed_s"] for s in stats), 2)

    for i in range(n_samples):
        a = formats.read_u16(os.path.join(d, f"i{i}.bin"))
        b = formats.read_u16(os.path.join(d, f"c{i}.bin"))
        np.testing.assert_array_equal(a, b)
    out["outputs_match_individual"] = True
    # amortization criterion (VERDICT r4 Next #8): per-sample cohort
    # throughput >= individual throughput once the shared build is paid
    out["amortized_speedup"] = round(
        (sum(indiv_walls) / n_samples)
        / (sum(out["cohort_sample_walls_s"]) / n_samples), 3)
    out["dir"] = d
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
