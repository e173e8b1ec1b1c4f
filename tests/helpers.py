"""Shared test utilities: synthetic genomes/reads, reference-binary runs,
and a tiny independent (slow, obviously-correct) model of the reference
algorithms for oracle checks."""

from __future__ import annotations

import os
import subprocess

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)

COMP = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}


def random_genome(rng, length: int) -> str:
    return bytes(BASES[rng.integers(0, 4, size=length)]).decode()


def write_fasta(path: str, chroms: dict[str, str], width: int = 70) -> None:
    with open(path, "w") as f:
        for name, seq in chroms.items():
            f.write(f">{name}\n")
            for i in range(0, len(seq), width):
                f.write(seq[i : i + width] + "\n")


def simulate_reads(rng, seq: str, n_reads: int, read_len: int) -> list[str]:
    starts = rng.integers(0, len(seq) - read_len + 1, size=n_reads)
    reads = []
    for s in starts:
        r = seq[s : s + read_len]
        if rng.random() < 0.5:
            r = revcomp(r)
        reads.append(r)
    return reads


def revcomp(s: str) -> str:
    return "".join(COMP[c] for c in reversed(s))


def mutate_reads(rng, reads: list[str], err_rate: float) -> list[str]:
    """Substitution errors at err_rate per base (sequencing-error model
    for spill-path tests)."""
    out = []
    for r in reads:
        chars = list(r)
        for pos in np.flatnonzero(rng.random(len(chars)) < err_rate):
            chars[pos] = "ACGT"[(("ACGT".index(chars[pos])
                                  + rng.integers(1, 4)) % 4)]
        out.append("".join(chars))
    return out


def write_fastq(path: str, reads: list[str]) -> None:
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@read{i}\n{r}\n+\n{'I' * len(r)}\n")


def write_reads_fasta(path: str, reads: list[str]) -> None:
    """One line per read, like the samtools|awk recipe (README.md:86-91)."""
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r}\n")


def run_ref(ref_bin: str, args: list[str], cwd: str) -> subprocess.CompletedProcess:
    return subprocess.run([ref_bin] + args, cwd=cwd, check=True,
                          capture_output=True, text=True)


def canonical_kmers_of(seq: str, k: int) -> list[int]:
    """Slow oracle: canonical k-mer codes of every full-ACGT window."""
    from quickmer2.ops.codec import encode_kmer_string
    out = []
    for i in range(len(seq) - k + 1):
        w = seq[i : i + k]
        if set(w) <= set("ACGT"):
            out.append(encode_kmer_string(w))
        else:
            out.append(None)
    return out


def smoke_world(seed: int = 0, n_bases: int = 60_000, n_reads: int = 3000,
                err: float = 0.003):
    """Small realistic genome (repeats, GC isochores), its unique-k-mer
    dictionary (k=30, genome order, end positions) and 150 bp reads with
    substitution errors — the data chip_smoke.py builds, at test size."""
    import chip_smoke
    realistic_genome, rehearsal = chip_smoke._tools()
    rng = np.random.default_rng(seed)
    g, _, _ = realistic_genome.make_genome(rng, n_bases)
    kmers, pos = chip_smoke.unique_kmer_dictionary(g)
    reads = rehearsal.simulate_reads_codes(rng, g, n_reads, 150, err)
    return g, kmers, pos, reads


def count_reads(engine: str, genome, kmers, pos, reads,
                device_build: bool = False) -> np.ndarray:
    """u16 depth of `reads` through one counting engine: a DepthCounter
    layout, "anchored" (StreamCounter over an AnchoredIndex), or
    "sharded" (StreamCounter over a 1 x 1 data/dict mesh)."""
    import chip_smoke
    from quickmer2.dictionary import Dictionary
    from quickmer2.pipelines.count import DepthCounter, StreamCounter
    dic = Dictionary.from_kmers_in_order(
        kmers, chip_smoke.reference_hash_size(len(kmers)), 30)
    codes = chip_smoke.code_stream(reads)
    if engine == "anchored":
        from quickmer2.ops.anchored import AnchoredIndex
        index = AnchoredIndex.build(genome, pos, kmers, 30,
                                    neighbor_bits=True,
                                    device_build=device_build)
        counter = StreamCounter(dic, mode="anchored", index=index)
    elif engine == "sharded":
        from quickmer2.parallel.count_parallel import ShardedDepthCounter
        from quickmer2.parallel.mesh import make_mesh
        counter = ShardedDepthCounter(dic, make_mesh(1, 1),
                                      batch_bases=1 << 16)
    else:
        counter = DepthCounter(dic, batch_bases=1 << 16, layout=engine)
    counter.feed_codes(codes)
    return (counter.finish() & 0xFFFF).astype(np.uint16)
