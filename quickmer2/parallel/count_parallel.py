"""Multi-device count: data-parallel read shards x dictionary-sharded
packed probe table, composed with shard_map over a ("data", "dict")
Mesh.

Architecture (no reference counterpart — the reference is single-host
pthreads; this is the communication backend SURVEY.md section 5 calls
for):

  * the host splits each code batch into `dp` chunks overlapping by
    k-1 codes (no window lost at shard boundaries, mirroring the
    single-device carry);
  * the packed two-choice bucket table (ops.packed_table) is split
    into `ds` contiguous bucket blocks — buckets are self-contained
    (unlike linear-probe slots), so NO halo is needed: a device probes
    the lanes whose h1 or h2 bucket falls in its block, and a key's
    row lives on exactly one device, so each hit is counted once;
  * partials live as depth[dp, ds, n+1] sharded P("data", "dict");
    the final merge is one reduction over the device axes — XLA lowers
    it to an all-reduce (NCCL on GPUs; the psum analog of the
    reference's atomic u16 adds, QuicKmer.c:290-291).

Determinism: the counts are integer sums, so the order in which
scatter-adds and the final reduction combine them does not change the
result — identical .bin across runs and mesh shapes (verified in
tests/test_parallel.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from quickmer2.dictionary import Dictionary
from quickmer2.ops import codec
from quickmer2.ops.codec import SEP
from quickmer2.ops.hash import djb_pair
from quickmer2.ops.packed_table import (
    ENTRIES_PER_BUCKET, PackedTable, bucket_hashes_jnp)


def split_codes_overlap(batch: np.ndarray, dp: int, k: int) -> np.ndarray:
    """Split a code batch into dp chunks with k-1 overlap → [dp, chunk]."""
    n = len(batch)
    chunk = -(-n // dp)
    padded = np.full(dp * chunk + (k - 1), SEP, np.uint8)
    padded[:n] = batch
    out = np.empty((dp, chunk + k - 1), np.uint8)
    for i in range(dp):
        out[i] = padded[i * chunk : (i + 1) * chunk + (k - 1)]
    return out


def make_sharded_count_step(mesh: Mesh, k: int, n_buckets: int,
                            block_buckets: int, n_kmers: int,
                            packed_h2d_len: int | None = None):
    """Jitted sharded count step over packed bucket blocks.

    step(codes[dp, C], rows[ds, Bb, 16], depth[dp, ds, n+1]) -> depth
    With packed_h2d_len, `codes` arrives 2-bit packed (+ SEP bitmask)
    and is unpacked per device inside the jit (ops.rowpack)."""

    def local_step(codes, bits, rows, depth):
        if packed_h2d_len is not None:
            from quickmer2.ops import rowpack
            codes = rowpack.unpack_rows(codes, bits,
                                        read_len=packed_h2d_len)
        codes = codes[0]
        rows = rows[0]            # (Bb, 16)
        my = jax.lax.axis_index("dict")
        blk_lo = (my * block_buckets).astype(jnp.uint32)

        chi, clo, valid = codec.sliding_kmers(codes, k)
        nonzero_q = (chi | clo) != 0
        h = djb_pair(chi, clo)
        i1, i2 = bucket_hashes_jnp(h, n_buckets)

        trash = depth.shape[-1] - 1
        found = jnp.zeros(chi.shape, bool)
        rank = jnp.full(chi.shape, jnp.uint32(trash), jnp.uint32)
        for cand in (i1, i2):
            off = cand - blk_lo           # u32 wrap for foreign lanes
            local = off < jnp.uint32(block_buckets)
            idx = jnp.where(local, off, 0).astype(jnp.int32)
            r = rows[idx]
            for e in range(ENTRIES_PER_BUCKET):
                m = local & nonzero_q & (r[:, 4 * e] == chi) \
                    & (r[:, 4 * e + 1] == clo)
                found = found | m
                rank = jnp.where(m, r[:, 4 * e + 2], rank)
        point = jnp.where(found & valid, rank, jnp.uint32(trash)).astype(jnp.int32)
        new_depth = depth[0, 0].at[point].add(1, mode="promise_in_bounds")
        return new_depth[None, None]

    smapped = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(P("data", None), P("data", None), P("dict", None, None),
                  P("data", "dict", None)),
        out_specs=P("data", "dict", None))
    return jax.jit(smapped, donate_argnums=(3,))


class ShardedDepthCounter:
    """Multi-device DepthCounter over the packed table; same
    feed/finish interface as the single-device version."""

    def __init__(self, dictionary: Dictionary, mesh: Mesh,
                 batch_bases: int = 1 << 24, pack_h2d: bool = True):
        self.dict = dictionary
        self.mesh = mesh
        self.k = dictionary.kmer_size
        self.batch_bases = batch_bases
        self.pack_h2d = pack_h2d
        self.dp = mesh.shape["data"]
        self.ds = mesh.shape["dict"]
        packed = PackedTable.from_dictionary(dictionary)
        assert packed.n_buckets % self.ds == 0
        bb = packed.n_buckets // self.ds
        rows = packed.rows.reshape(self.ds, bb, 4 * ENTRIES_PER_BUCKET)
        self.rows = jax.device_put(rows, NamedSharding(mesh, P("dict", None, None)))
        self.block_buckets = bb
        n = dictionary.n_kmers
        self.depth = jax.device_put(
            np.zeros((self.dp, self.ds, n + 1), np.uint32),
            NamedSharding(mesh, P("data", "dict", None)))
        self._chunk_len = -(-batch_bases // self.dp) + (self.k - 1)
        self._step = make_sharded_count_step(
            mesh, self.k, packed.n_buckets, bb, n,
            packed_h2d_len=self._chunk_len if pack_h2d else None)
        self._sh_data = NamedSharding(mesh, P("data", None))
        self._carry = np.zeros(0, np.uint8)
        self._pending: list[np.ndarray] = []
        self._pending_len = 0
        self.total_kmer_windows = 0

    def feed_codes(self, chunk: np.ndarray) -> None:
        self._pending.append(chunk)
        self._pending_len += len(chunk)
        while self._pending_len + len(self._carry) >= self.batch_bases:
            buf = np.concatenate([self._carry] + self._pending)
            self._pending = [buf[self.batch_bases :]]
            self._pending_len = len(self._pending[0])
            self._run(buf[: self.batch_bases])

    def _run(self, batch: np.ndarray) -> None:
        shards = split_codes_overlap(batch, self.dp, self.k)
        if self.pack_h2d:
            from quickmer2.ops import rowpack
            pk, bits = rowpack.pack_rows(shards)
            codes = jax.device_put(pk, self._sh_data)
            aux = jax.device_put(bits, self._sh_data)
        else:
            codes = jax.device_put(shards, self._sh_data)
            aux = jax.device_put(
                np.zeros((self.dp, 1), np.uint8), self._sh_data)
        self.depth = self._step(codes, aux, self.rows, self.depth)
        self.total_kmer_windows += len(batch) - self.k + 1
        self._carry = batch[-(self.k - 1):].copy()

    def finish(self) -> np.ndarray:
        if self._pending_len:
            buf = np.concatenate([self._carry] + self._pending)
            pad = np.full(self.batch_bases - len(buf) % self.batch_bases, SEP, np.uint8)
            buf = np.concatenate([buf, pad])
            for off in range(0, len(buf), self.batch_bases):
                self._run(buf[off : off + self.batch_bases])
            self._pending, self._pending_len = [], 0
        total = jnp.sum(self.depth, axis=(0, 1), dtype=jnp.uint32)
        return np.asarray(jax.device_get(total))[:-1]

    # -- checkpoint/resume (same contract as DepthCounter) -------------

    def snapshot(self) -> dict:
        residual = np.concatenate([self._carry] + self._pending) \
            if (self._pending_len or len(self._carry)) else np.zeros(0, np.uint8)
        return {"depth": np.asarray(jax.device_get(self.depth)),
                "residual": residual, "windows": self.total_kmer_windows}

    def restore(self, snap: dict) -> None:
        depth = np.asarray(snap["depth"], np.uint32)
        want = (self.dp, self.ds, self.dict.n_kmers + 1)
        if depth.shape != want:
            raise ValueError(
                f"checkpoint depth shape {depth.shape} != {want}; resume "
                f"with the same data_devices/dict_devices mesh")
        self.depth = jax.device_put(
            depth, NamedSharding(self.mesh, P("data", "dict", None)))
        residual = np.asarray(snap["residual"], np.uint8)
        self._carry = np.zeros(0, np.uint8)
        self._pending = [residual] if len(residual) else []
        self._pending_len = len(residual)
        self.total_kmer_windows = int(snap.get("windows", 0))
