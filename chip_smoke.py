#!/usr/bin/env python3
"""End-to-end smoke test of quickmer2 on one NVIDIA GPU.

Drives the main path through the CLI entry point (quickmer2.cli.main,
called in this process) on seeded synthetic data, and checks every
result against a plain host reference:

  B  count (flat mode, mono engine) against a dictionary of >= 1e8
     k-mers built from a 150 Mb genome: the table a chromosome-scale
     deployment keeps on the card;
  A  search -e 2 -> count -> count --mode anchored -> est on a 4 Mb
     genome with a planted duplication and a planted CNV segment;
  a  sort-join against mono engine timing at three dictionary sizes;
  a  profiler trace of steady Phase-B batches, reduced to the top
     device ops and the device's idle share;
  the tests marked `gpu` (tests/test_gpu.py).

Exactness. The count path is integer-only: u32 (hi, lo) k-mer pairs,
gathers, compares and u32 scatter-adds. No float matrix product is on
it, so TF32 does not apply, and every depth vector must equal the host
reference bit for bit. The host reference is independent of every
device table: canonical k-mers of the reads (codec.sliding_kmers_np),
np.searchsorted into the sorted dictionary keys, counts in genome rank
order, wrapped to u16 as in the .bin format. `est` runs in host numpy
(pipelines/est.py); its copy numbers are checked against the planted
ones within stated tolerances.

One JAX process does all of it; the only child process is nvidia-smi.
The script exits non-zero, and never prints `"ok": true`, when JAX finds
no GPU, when the native parser cannot be built, or when any check fails.
No phase catches its own failure.

Usage:
  python chip_smoke.py               # one card
  python chip_smoke.py --four-cards  # sharded counts on four cards only
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import glob
import io
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
K = 30
READ_LEN = 150
ERR = 0.003          # substitution errors per base (typical Illumina)


@dataclasses.dataclass(frozen=True)
class Sizes:
    # Half of tools/rehearsal.py's 8 Mb. At 8 Mb the e=2 filter's host
    # slow path alone took 370-450 s on H100 machines, and the whole
    # smoke 1089 s of its 1200 s limit on the faster of two hosts whose
    # host-bound phases differ by 10-20 %. At 4 Mb the search takes ~25 s.
    a_bases: int = 4_000_000
    a_coverage: float = 25.0
    n_neighbor_targets: int = 2000
    b_bases: int = 150_000_000        # chromosome class (GRCh38 chr1 ~ 2.5e8)
    b_reads: int = 2_000_000
    crossover_ns: tuple = (1 << 14, 1 << 18, 1 << 20)
    crossover_bases: int = 1 << 26    # read bases per timed run
    crossover_genome: int = 1 << 25   # genome the reads come from
    crossover_reps: int = 3           # the first run compiles
    trace_batches: int = 4


FULL = Sizes()
# The sharded paths are checked at reduced state, far below a dictionary
# that needs more than one card: each sharded count rebuilds its tables
# on the host, which at Phase B's full size takes minutes per mesh.
FOUR_CARDS = Sizes(a_bases=2_000_000, b_bases=30_000_000, b_reads=500_000)


class SmokeFailure(AssertionError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)
    print(f"check ok: {msg}", flush=True)


def log(msg: str) -> None:
    print(msg, flush=True)


def cli(*args) -> dict | None:
    """Run one CLI command in this process; returns its --json stats."""
    from quickmer2.cli import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main([str(a) for a in args])
    if rc != 0:
        raise SmokeFailure(f"cli {args[0]} exited {rc}")
    lines = buf.getvalue().strip().splitlines()
    return json.loads(lines[-1]) if "--json" in args else None


# -- data ----------------------------------------------------------------

def _tools():
    sys.path.insert(0, ROOT)
    from tools import realistic_genome, rehearsal
    return realistic_genome, rehearsal


def unique_kmer_dictionary(genome: np.ndarray, k: int = K):
    """Canonical k-mers that occur once in the genome, in genome order,
    with their end positions (bench-style numpy unique filtering, no
    edit-distance filter). Returns (kmers u64[n], end_pos u32[n])."""
    from quickmer2.utils import native
    canon, valid, _ = native.sliding_canon(genome, k)
    valid &= canon != 0
    pos = np.flatnonzero(valid)
    km = canon[pos]
    del canon, valid
    order = np.argsort(km)
    s = km[order]
    eq = s[1:] == s[:-1]
    dup = np.zeros(len(s), bool)
    dup[1:] |= eq
    dup[:-1] |= eq
    keep = np.empty(len(s), bool)
    keep[order] = ~dup
    return km[keep], (pos[keep] + k - 1).astype(np.uint32)


def reference_hash_size(n: int) -> int:
    """Smallest power of two with n <= 0.8 * H (the reference's growth
    rule, QuicKmer.c:891-895)."""
    h = 1 << 16
    while n > 0.8 * h:
        h <<= 1
    return h


def code_stream(reads: np.ndarray) -> np.ndarray:
    """Read rows -> SEP-delimited code stream (what the parser emits)."""
    from quickmer2.ops.codec import SEP
    rows = np.full((len(reads), reads.shape[1] + 1), SEP, np.uint8)
    rows[:, :-1] = reads
    return rows.reshape(-1)


def host_depth_references(reads: np.ndarray, dicts: list,
                          k: int = K, chunk_reads: int = 1 << 16,
                          workers: int | None = None) -> list:
    """u16 depth of every k-mer of each dictionary in `dicts` (rank =
    its genome order) from the read rows alone: no table, no device. The
    reads are encoded once for all dictionaries. Chunked over reads so
    host memory stays bounded; numpy releases the GIL in these loops, so
    the chunks run on several cores."""
    from quickmer2.ops import codec
    orders = [np.argsort(d) for d in dicts]
    skeys = [d[o] for d, o in zip(dicts, orders)]
    totals = [np.zeros(len(d), np.uint64) for d in dicts]

    def count_chunk(lo: int):
        canon, valid = codec.sliding_kmers_np(
            code_stream(reads[lo:lo + chunk_reads]), k)
        q = np.sort(canon[valid])
        out = []
        for sk in skeys:
            idx = np.searchsorted(sk, q)
            hit = idx < len(sk)
            hit[hit] = sk[idx[hit]] == q[hit]
            out.append(np.unique(idx[hit], return_counts=True))
        return out

    workers = workers or min(16, os.cpu_count() or 1)
    with concurrent.futures.ThreadPoolExecutor(workers) as ex:
        for per_dict in ex.map(count_chunk,
                               range(0, len(reads), chunk_reads)):
            for total, (u, c) in zip(totals, per_dict):
                total[u] += c.astype(np.uint64)
    refs = []
    for total, order in zip(totals, orders):
        depth = np.empty(len(total), np.uint64)
        depth[order] = total
        refs.append((depth & np.uint64(0xFFFF)).astype(np.uint16))
    return refs


def host_depth_reference(reads: np.ndarray, dict_kmers: np.ndarray,
                         **kw) -> np.ndarray:
    """host_depth_references for one dictionary."""
    return host_depth_references(reads, [dict_kmers], **kw)[0]


def _revcomp(codes: np.ndarray, k: int) -> np.ndarray:
    rc = np.zeros_like(codes)
    t = codes.copy()
    for _ in range(k):
        rc = (rc << np.uint64(2)) | ((t - np.uint64(2)) & np.uint64(3))
        t >>= np.uint64(2)
    return rc & np.uint64((1 << (2 * k)) - 1)


def brute_neighbor_sums(targets: np.ndarray, uniq: np.ndarray,
                        occ: np.ndarray, k: int, e: int) -> np.ndarray:
    """Vectorized port of the brute-force enumeration in
    tests/test_hamming_join.py (brute_sums): every substitution at
    Hamming distance 1..e, canonicalized, looked up in the sorted
    distinct k-mers `uniq` with saturated counts `occ`."""
    km = np.asarray(targets, np.uint64)[:, None]
    occ64 = np.asarray(occ, np.uint64)
    total = np.zeros(len(km), np.uint64)
    three = np.uint64(3)

    def occ_of(codes):
        c = np.minimum(codes, _revcomp(codes, k))
        idx = np.minimum(np.searchsorted(uniq, c), len(uniq) - 1)
        return np.where(uniq[idx] == c, occ64[idx], np.uint64(0)).sum(axis=1)

    for p1 in range(k):
        s1 = np.uint64(2 * p1)
        b1 = (km >> s1) & three
        for v1 in (1, 2, 3):
            n1 = km ^ ((b1 ^ ((b1 + np.uint64(v1)) & three)) << s1)
            total += occ_of(n1)
            if e >= 2 and p1:
                s2 = np.repeat(np.arange(p1, dtype=np.uint64) * 2, 3)[None, :]
                v2 = np.tile(np.array([1, 2, 3], np.uint64), p1)[None, :]
                b2 = (n1 >> s2) & three
                total += occ_of(n1 ^ ((b2 ^ ((b2 + v2) & three)) << s2))
    return np.minimum(total, np.uint64(0xFFFFFFFF)).astype(np.uint32)


# -- device facts --------------------------------------------------------

def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, check=True, timeout=60)
    return r.stdout.strip()


def device_memory():
    """(bytes_limit, peak_bytes_in_use) per local device; zeros where
    the backend keeps no memory statistics (the CPU of a rehearsal)."""
    import jax
    out = []
    for d in jax.local_devices():
        st = d.memory_stats() or {}
        out.append((st.get("bytes_limit", 0), st.get("peak_bytes_in_use", 0)))
    return out


class DeviceFootprint:
    """Per local device, the most bytes in use while the block runs, less
    what the device held when it began: the block's own footprint, not
    the process's running peak. Sampled from a thread every `period`
    seconds; zeros where the backend keeps no memory statistics."""

    def __init__(self, period: float = 0.02):
        import jax
        self._devs = jax.local_devices()
        self._period = period
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)

    def _read(self) -> list[int]:
        return [(d.memory_stats() or {}).get("bytes_in_use", 0)
                for d in self._devs]

    def _poll(self) -> None:
        while not self._stop.wait(self._period):
            self.high = list(map(max, self.high, self._read()))

    def __enter__(self) -> "DeviceFootprint":
        self.base = self._read()
        self.high = list(self.base)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()
        self.high = list(map(max, self.high, self._read()))

    @property
    def bytes(self) -> list[int]:
        return [h - b for h, b in zip(self.high, self.base)]


# -- Phase B: deployment-size dictionary, flat count ----------------------

def prepare_phase_b(work: str, sizes: Sizes) -> dict:
    from quickmer2.dictionary import Dictionary
    realistic_genome, rehearsal = _tools()
    t0 = time.time()
    g, _, _ = realistic_genome.make_genome(np.random.default_rng(21),
                                           sizes.b_bases)
    dict_kmers, _ = unique_kmer_dictionary(g)
    n = len(dict_kmers)
    qm = os.path.join(work, "b.qm")
    dic = Dictionary.from_kmers_in_order(dict_kmers, reference_hash_size(n),
                                         K)
    dic.to_qm(qm)
    reads = rehearsal.simulate_reads_codes(np.random.default_rng(22), g,
                                           sizes.b_reads, READ_LEN, ERR)
    del g
    fq = os.path.join(work, "b.fq")
    rehearsal.write_fastq_codes(fq, reads)
    log(f"phase B data: genome {sizes.b_bases} bases, n_kmers {n}, "
        f"{len(reads)} reads x {READ_LEN} bp at {ERR} /bp, "
        f"prepared in {time.time() - t0:.1f} s")
    return {"qm": qm, "fq": fq, "reads": reads, "dic": dic,
            "kmers": dict_kmers, "n_kmers": n}


def phase_b_reference(b: dict) -> None:
    t0 = time.time()
    b["ref"] = host_depth_reference(b["reads"], b["kmers"])
    log(f"phase B host reference in {time.time() - t0:.1f} s")


def compare_count(b: dict, out: str, flags=()) -> None:
    from quickmer2.io import formats
    got = formats.read_u16(out + ".bin")
    check(len(got) == b["n_kmers"] and np.array_equal(got, b["ref"]),
          f"count {' '.join(flags) or '(one card)'}: .bin of "
          f"{b['n_kmers']} k-mers bit-identical to the host reference")


def phase_b(work: str, sizes: Sizes, report: dict) -> dict:
    from quickmer2.pipelines.count import DepthCounter
    b = prepare_phase_b(work, sizes)
    check(b["n_kmers"] >= 100_000_000 or sizes != FULL,
          f"Phase B dictionary holds >= 1e8 k-mers ({b['n_kmers']})")
    out = os.path.join(work, "b_flat")
    stats = cli("count", "--json", b["qm"], b["fq"], out)
    limit, peak = device_memory()[0]
    # Neither the host reference nor the traced counter's table is
    # timed, so they are built side by side.
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        ref = ex.submit(phase_b_reference, b)
        b["counter"] = DepthCounter(b["dic"], layout="mono")
        ref.result()
    compare_count(b, out)
    n = b["n_kmers"]
    windows = len(b["reads"]) * (READ_LEN - K + 1)
    ph = stats["phases"]
    compile_s = stats.get("phase_compile_s", 0.0)
    stream = ph["stream_s"] + ph["finish_s"]
    r = {"n_kmers": n, "n_reads": len(b["reads"]), "kmer_windows": windows,
         "bytes_limit": limit,
         "peak_bytes_in_use": peak, "peak_share": peak / max(limit, 1),
         "setup_s": ph["setup_s"], "compile_s": compile_s,
         "stream_s": ph["stream_s"], "finish_s": ph["finish_s"],
         "kmers_per_s": windows / stream,
         "kmers_per_s_after_compile": windows / (stream - compile_s)}
    report["phase_b"] = r
    log(f"phase B: n_kmers {n}; "
        f"peak {peak / 1e9:.3f} GB of {limit / 1e9:.3f} GB "
        f"({peak / max(limit, 1):.1%}); setup {ph['setup_s']:.2f} s; compile "
        f"{compile_s:.2f} s; stream {ph['stream_s']:.2f} s + finish "
        f"{ph['finish_s']:.2f} s -> {r['kmers_per_s'] / 1e6:.1f} M k-mers/s "
        f"({r['kmers_per_s_after_compile'] / 1e6:.1f} M after compile)")
    return b


# -- Phase A: search -> count (flat, anchored) -> est ----------------------

def prepare_phase_a(work: str, sizes: Sizes) -> dict:
    """Genome with a planted duplication, control bed and reads with a
    planted CNV, exactly as tools/rehearsal.py builds them."""
    realistic_genome, rehearsal = _tools()
    rng = np.random.default_rng(12)
    n_bases = sizes.a_bases
    g, dup_start, dup_len = realistic_genome.make_genome(
        rng, n_bases, min(200_000, n_bases // 20), 2)   # true CN 2*(1+2)
    fa = os.path.join(work, "a.fa")
    realistic_genome.to_fasta(fa, g)
    seg_start = 4 * len(g) // 5
    seg_len = min(100_000, len(g) // 40)
    ctrl = os.path.join(work, "ctrl.bed")
    excl = sorted([(dup_start - 500, dup_start + dup_len + 500),
                   (seg_start - 500, seg_start + seg_len + 500)])
    with open(ctrl, "w") as f:
        prev = 0
        for a, b in excl:
            f.write(f"chr1\t{prev}\t{a}\n")
            prev = b
        f.write(f"chr1\t{prev}\t{len(g)}\n")
        f.write("chrZ\t0\t100\n")      # off-chromosome terminator row
    cov = sizes.a_coverage
    reads = rehearsal.simulate_reads_codes(
        rng, g, int(cov * len(g) / READ_LEN), READ_LEN, ERR)
    seg = g[seg_start:seg_start + seg_len]
    extra = rehearsal.simulate_reads_codes(
        rng, seg, int(2 * cov * len(seg) / READ_LEN), READ_LEN, ERR)
    reads = np.concatenate([reads, extra])
    fq = os.path.join(work, "a.fq")
    rehearsal.write_fastq_codes(fq, reads)
    return {"genome": g, "fa": fa, "ctrl": ctrl, "fq": fq, "reads": reads,
            "dup": (dup_start, dup_len), "seg": (seg_start, seg_len)}


def neighbor_sums_check(genome: np.ndarray, n_targets: int) -> None:
    from quickmer2.ops import codec
    from quickmer2.ops.hamming_join import hamming_neighbor_sums
    canon, valid = codec.sliding_kmers_np(genome, K)
    uniq, counts = np.unique(canon[valid & (canon != 0)], return_counts=True)
    occ = np.minimum(counts, 255).astype(np.uint8)
    cand = uniq[occ == 1]
    targets = np.random.default_rng(5).choice(
        cand, size=min(n_targets, len(cand)), replace=False)
    got = hamming_neighbor_sums(targets, uniq, occ, K, 2)
    want = brute_neighbor_sums(targets, uniq, occ, K, 2)
    check(np.array_equal(got, want),
          f"hamming_neighbor_sums of {len(targets)} sampled candidates "
          f"against {len(uniq)} distinct k-mers equals brute force")


def cn_check(cn_bed: str, a: dict, strict: bool) -> tuple[float, float]:
    from quickmer2.io import formats
    _, cn = formats.read_cn_bed(cn_bed)
    seg_start, seg_len = a["seg"]
    dup_start, dup_len = a["dup"]
    in_seg = (cn[:, 0] >= seg_start) & (cn[:, 1] <= seg_start + seg_len)
    base = ((cn[:, 1] < dup_start - 1000)
            | (cn[:, 0] > dup_start + dup_len + 1000)) & ~in_seg
    baseline = float(np.mean(cn[base, 2]))
    planted = float(np.mean(cn[in_seg, 2])) if in_seg.any() else float("nan")
    if strict:
        check(abs(baseline - 2.0) <= 0.1, f"baseline CN {baseline:.3f} "
                                          f"within 2.0 +- 0.1")
        check(abs(planted - 6.0) <= 0.5, f"planted segment CN {planted:.3f} "
                                         f"within 6.0 +- 0.5")
    return baseline, planted


def phase_a(work: str, sizes: Sizes, report: dict) -> None:
    from quickmer2.dictionary import Dictionary
    from quickmer2.io import formats
    a = prepare_phase_a(work, sizes)
    fa = a["fa"]
    t0 = time.time()
    s_stats = cli("search", "-k", K, "-e", 2, "-d", 100, "-w", 1000,
                  "-c", a["ctrl"], "--json", fa)
    search_s = time.time() - t0
    dict_kmers = Dictionary.from_qm(fa + ".qm").kmers_in_order
    ref = host_depth_reference(a["reads"], dict_kmers)
    flat = os.path.join(work, "a_flat")
    anch = os.path.join(work, "a_anch")
    f_stats = cli("count", "--json", fa, a["fq"], flat)
    a_stats = cli("count", "--mode", "anchored", "--json", fa, a["fq"], anch)
    got_flat = formats.read_u16(flat + ".bin")
    got_anch = formats.read_u16(anch + ".bin")
    check(np.array_equal(got_flat, got_anch),
          "flat and anchored .bin byte-identical")
    check(np.array_equal(got_flat, ref),
          f"flat and anchored .bin of {len(ref)} k-mers equal the host "
          f"reference")
    neighbor_sums_check(a["genome"], sizes.n_neighbor_targets)
    cli("est", "--json", fa, flat, flat + ".CN.bed")
    baseline, planted = cn_check(flat + ".CN.bed", a, strict=sizes == FULL)
    r = {"genome_bases": len(a["genome"]), "n_reads": len(a["reads"]),
         "n_kmers": len(ref), "search_s": search_s,
         "search_phases": s_stats["phases"],
         "filter_s": s_stats["phases"]["filter_s"],
         "flat_phases": f_stats["phases"],
         "anchored_phases": a_stats["phases"],
         "qai_build_s": a_stats["phases"]["index_s"],
         "anchored_spilled": a_stats.get("n_spilled"),
         "baseline_cn": baseline, "planted_cn": planted}
    report["phase_a"] = r
    log(f"phase A: search {search_s:.2f} s (edit filter "
        f"{r['filter_s']:.2f} s); .qai build {r['qai_build_s']:.2f} s; "
        f"flat stream {f_stats['phases']['stream_s']:.2f} s; anchored "
        f"stream {a_stats['phases']['stream_s']:.2f} s; CN baseline "
        f"{baseline:.3f}, planted {planted:.3f}")


# -- sort-join against mono ----------------------------------------------

def engine_crossover(sizes: Sizes, report: dict) -> None:
    """Time DepthCounter(layout="sortjoin") against layout="mono" on the
    same stream at each dictionary size. The reads cover a genome much
    larger than the dictionary's region, so most windows miss, as a
    small dictionary's do under whole-genome reads; the hit rate is
    reported. Each timed run is feed + finish; finish() returns the host
    depth vector, so the device work is done when the clock stops.
    Table construction is outside the clock."""
    from quickmer2.dictionary import Dictionary
    from quickmer2.pipelines.count import DepthCounter
    _, rehearsal = _tools()
    rng = np.random.default_rng(31)
    g = rng.integers(0, 4, size=sizes.crossover_genome).astype(np.uint8)
    reads = rehearsal.simulate_reads_codes(
        rng, g, sizes.crossover_bases // (READ_LEN + 1), READ_LEN, ERR)
    codes = code_stream(reads)
    windows = len(reads) * (READ_LEN - K + 1)
    # each dictionary: the first n unique k-mers of the genome
    dicts = [unique_kmer_dictionary(g[:int(n * 1.1) + K])[0][:n]
             for n in sizes.crossover_ns]
    refs = host_depth_references(reads, dicts)
    rows = []
    for n, kmers, ref in zip(sizes.crossover_ns, dicts, refs):
        dic = Dictionary.from_kmers_in_order(kmers, reference_hash_size(n), K)
        hit_rate = float(ref.astype(np.uint64).sum()) / windows
        rate = {}
        for layout in ("mono", "sortjoin"):
            walls = []
            for _ in range(sizes.crossover_reps):
                dc = DepthCounter(dic, layout=layout)
                t0 = time.perf_counter()
                dc.feed_codes(codes)
                depth = dc.finish()
                walls.append(time.perf_counter() - t0)
            check(np.array_equal((depth & 0xFFFF).astype(np.uint16), ref),
                  f"{layout} at n={n} equals the host reference")
            rate[layout] = windows / float(np.median(walls[1:]))
            log(f"crossover n={n} (hit rate {hit_rate:.5f}) {layout}: walls "
                f"{', '.join(f'{w:.4f}' for w in walls)} s -> "
                f"{rate[layout] / 1e6:.1f} M k-mers/s")
        rows.append({"n": n, "kmer_windows": windows, "hit_rate": hit_rate,
                     "mono_kmers_per_s": rate["mono"],
                     "sortjoin_kmers_per_s": rate["sortjoin"]})
    report["crossover"] = rows


# -- trace of steady Phase-B batches --------------------------------------

def reduce_trace(xplane_path: str, window_name: str, top: int = 10) -> dict:
    """Top device ops by summed duration, and the device's idle share:
    1 - (union of op intervals on the device) / window. The window is
    the host annotation `window_name` when the device events fall in
    it, else the span of the device events."""
    import jax
    pd = jax.profiler.ProfileData.from_file(xplane_path)
    dev = [p for p in pd.planes if p.name.startswith("/device:GPU:")]
    if not dev:
        raise SmokeFailure(f"no GPU plane in {xplane_path}: "
                           f"{[p.name for p in pd.planes]}")
    plane = sorted(dev, key=lambda p: p.name)[0]
    lines = {ln.name: list(ln.events) for ln in plane.lines}
    busy_ev = [e for n in lines if n.startswith("Stream") for e in lines[n]]
    by_name: dict = {}
    for e in busy_ev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.duration_ns
    iv = sorted((e.start_ns, e.start_ns + e.duration_ns) for e in busy_ev)
    busy = 0.0
    cur_s = cur_e = None
    for s, t in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    if cur_e is not None:
        busy += cur_e - cur_s
    lo = iv[0][0] if iv else 0.0
    hi = max((t for _, t in iv), default=0.0)
    window = (lo, hi)
    for p in pd.planes:
        if p.name.startswith("/host:"):
            for ln in p.lines:
                for e in ln.events:
                    if e.name == window_name:
                        ws, we = e.start_ns, e.start_ns + e.duration_ns
                        if ws <= lo and hi <= we:
                            window = (ws, we)
    span = max(window[1] - window[0], 1.0)
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"plane": plane.name, "lines": sorted(lines), "window_ns": span,
            "busy_ns": busy, "idle_share": 1.0 - busy / span,
            "top_ops_ns": top_ops}


def trace_phase_b(work: str, b: dict, sizes: Sizes, report: dict) -> None:
    import jax
    dc = b["counter"]
    # rows (16 B per k-mer at load 0.5) plus the slot-order accumulator
    table_bytes = dc.rows.nbytes + dc.depth.nbytes
    report["phase_b"]["mono_table_bytes"] = table_bytes
    log(f"phase B mono table: {table_bytes / 1e9:.3f} GB on the device")
    bb = dc.batch_bases
    n_reads = -(-bb * (sizes.trace_batches + 1) // (READ_LEN + 1))
    codes = code_stream(b["reads"][:n_reads])
    dc.feed_codes(codes[:bb])                      # warm: compiled already
    jax.block_until_ready(dc.depth)
    tdir = os.path.join(work, "trace")
    t0 = time.perf_counter()
    with jax.profiler.trace(tdir):
        with jax.profiler.TraceAnnotation("smoke.steady_batches"):
            dc.feed_codes(codes[bb:bb * (sizes.trace_batches + 1)])
            jax.block_until_ready(dc.depth)
    wall = time.perf_counter() - t0
    path = sorted(glob.glob(os.path.join(tdir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    red = reduce_trace(path, "smoke.steady_batches")
    red["batches"] = sizes.trace_batches
    red["traced_wall_s"] = wall
    report["trace"] = red
    log(f"trace of {sizes.trace_batches} steady Phase-B batches "
        f"({red['plane']}; lines {red['lines']}):"
        f" device busy {red['busy_ns'] / 1e6:.3f} ms of "
        f"{red['window_ns'] / 1e6:.3f} ms, idle share "
        f"{red['idle_share']:.4f}")
    for name, ns in red["top_ops_ns"]:
        log(f"  top op {ns / 1e6:10.3f} ms  {name[:120]}")


# -- tests marked gpu -------------------------------------------------------

class _Outcomes:
    def __init__(self):
        self.counts = {"passed": 0, "failed": 0, "skipped": 0}

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.counts[report.outcome] = self.counts.get(report.outcome,
                                                          0) + 1


def gpu_tests(report: dict) -> None:
    import pytest
    seen = _Outcomes()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_gpu.py")],
                     plugins=[seen])
    report["gpu_tests"] = seen.counts
    check(rc == 0 and seen.counts["passed"] > 0
          and seen.counts["failed"] == 0 and seen.counts["skipped"] == 0,
          f"tests marked gpu: {seen.counts}")


# -- four cards --------------------------------------------------------------

def four_cards(work: str, sizes: Sizes, report: dict) -> None:
    """Sharded counts only: Phase B's flat count over a dict-sharded, a
    data-sharded and a 2x2 mesh, and Phase A's anchored count over
    data- and dict-sharded meshes, each against the host reference.
    Phase A's dictionary comes from the same unique filtering as Phase
    B's (no edit filter): the sharded count, not search, is under test."""
    from quickmer2.dictionary import Dictionary
    from quickmer2.io import formats
    b = prepare_phase_b(work, sizes)
    phase_b_reference(b)
    runs = []
    for flags in (("--dict-devices", 4), ("--data-devices", 4),
                  ("--data-devices", 2, "--dict-devices", 2)):
        tag = "_".join(str(f).strip("-") for f in flags)
        out = os.path.join(work, "b_" + tag)
        with DeviceFootprint() as fp:
            stats = cli("count", "--json", *map(str, flags), b["qm"],
                        b["fq"], out)
        compare_count(b, out, tuple(map(str, flags)))
        runs.append({"flags": list(map(str, flags)),
                     "phases": stats["phases"], "footprint_bytes": fp.bytes})
        log(f"phase B {tag}: per-device footprint "
            f"{[round(x / 1e9, 3) for x in fp.bytes]} GB")
    del b
    a = prepare_phase_a(work, sizes)
    kmers, _ = unique_kmer_dictionary(a["genome"])
    Dictionary.from_kmers_in_order(
        kmers, reference_hash_size(len(kmers)), K).to_qm(a["fa"] + ".qm")
    ref = host_depth_reference(a["reads"], kmers)
    for flags in (("--data-devices", 4), ("--dict-devices", 4)):
        tag = "_".join(str(f).strip("-") for f in flags)
        out = os.path.join(work, "a_" + tag)
        with DeviceFootprint() as fp:
            stats = cli("count", "--mode", "anchored", "--json",
                        *map(str, flags), a["fa"], a["fq"], out)
        got = formats.read_u16(out + ".bin")
        check(np.array_equal(got, ref),
              f"anchored count {' '.join(map(str, flags))}: .bin of "
              f"{len(ref)} k-mers equals the host reference")
        runs.append({"flags": ["--mode", "anchored", *map(str, flags)],
                     "phases": stats["phases"], "footprint_bytes": fp.bytes})
        log(f"phase A anchored {tag}: per-device footprint "
            f"{[round(x / 1e9, 3) for x in fp.bytes]} GB")
    report["four_cards"] = runs


# -- main ---------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded counts on four cards")
    args = ap.parse_args(argv)

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's first device is "
              f"{devs[0].platform}", file=sys.stderr)
        return 2
    n_cards = 4 if args.four_cards else 1
    if len(devs) < n_cards:
        print(f"chip_smoke: needs {n_cards} GPUs, JAX sees {len(devs)}",
              file=sys.stderr)
        return 2
    from quickmer2.utils import native
    if not native.available():
        print(f"chip_smoke: native parser unavailable: "
              f"{native.load_error()}", file=sys.stderr)
        return 2

    smi = nvidia_smi_line()
    print(smi)
    limit, _ = device_memory()[0]
    log(f"device: {devs[0].device_kind}, count {len(devs)}, jax "
        f"{jax.__version__}, bytes_limit {limit}")
    report = {"nvidia_smi": smi, "device_kind": devs[0].device_kind,
              "device_count": len(devs), "jax": jax.__version__}
    work = os.path.join(ROOT, ".smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        t0 = time.time()
        if args.four_cards:
            four_cards(work, FOUR_CARDS, report)
        else:
            b = phase_b(work, FULL, report)
            log(f"[{time.time() - t0:.0f} s] phase B done")
            trace_phase_b(work, b, FULL, report)
            del b
            log(f"[{time.time() - t0:.0f} s] trace done")
            phase_a(work, FULL, report)
            log(f"[{time.time() - t0:.0f} s] phase A done")
            engine_crossover(FULL, report)
            log(f"[{time.time() - t0:.0f} s] crossover done")
            gpu_tests(report)
        report["wall_s"] = time.time() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print("SMOKE_REPORT " + json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
