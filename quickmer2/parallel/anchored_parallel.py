"""Multi-device anchored count: the flagship fast path (ops.anchored)
data-parallel over a ("data",) mesh axis.

Sharding plan (SURVEY.md section 2.3 axis (a); replaces the reference's
count worker pool, QuicKmer.c:256-296, across devices):

  * reads       — P("data", None, None): each device anchors/verifies a
                  disjoint slice of every read batch;
  * rows/tiles/dblock — replicated (P()): the genome tiles (~3.1 GB at
                  GRCh38) and dblock (~0.8 GB) fit one card; the packed
                  rows are the large one (~69 GB at load 0.5) — bucket-
                  block sharding of rows over a "dict" axis exists on
                  the flat path (parallel.count_parallel) and is the
                  escape hatch when rows exceed HBM;
  * diff/exact accumulators — P("data", None) per-device partials,
                  merged by ONE device reduction at finish (the psum
                  analog of the reference's atomic u16 adds).

Spill routing is unchanged from the single-device counter: shard_map
returns the per-read spill masks (device order == host order because
read slices are contiguous), the host compacts spilled reads into dense
batches and re-feeds them through tier 2 / the exact path — so every
tier runs sharded, not just tier 1.

Determinism: static shard boundaries + deterministic scatter-adds + a
fixed-order final reduction give bit-identical .bin for every mesh
shape (tests/test_parallel.py::test_anchored_sharded_matches).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from quickmer2.ops import rowpack
from quickmer2.ops.anchored import (
    AnchoredDepthCounter, AnchoredIndex, anchored_count_kernel,
    exact_count_rows)


class ShardedAnchoredCounter(AnchoredDepthCounter):
    """AnchoredDepthCounter whose device steps run under shard_map over
    the mesh's "data" axis — and, when the mesh's "dict" axis is wider
    than 1, with the packed rows bucket-block-sharded over it (the >HBM
    escape for GRCh38-scale tables: ~69 GB of rows split across
    devices, tiles/dblock replicated). Same feed_reads/finish interface
    and bit-identical output for every mesh shape."""

    def __init__(self, index: AnchoredIndex, k: int, read_len: int,
                 mesh: Mesh, batch_reads: int | None = None, **kw):
        self.mesh = mesh
        self.dp = mesh.shape["data"]
        self.ds = mesh.shape.get("dict", 1)
        if batch_reads is None:     # lanes-based default (see base class)
            batch_reads = max(1 << 12, (1 << 22) // read_len)
        batch_reads = -(-batch_reads // self.dp) * self.dp
        # the sharded exact step runs the packed probe under shard_map
        # (it reuses the possibly-dict-sharded index rows); the mono
        # spill table is a single-device base-class feature
        kw.setdefault("mono_spill", False)
        if kw["mono_spill"]:
            raise ValueError("mono_spill is not supported on the sharded "
                             "anchored counter")
        super().__init__(index, k, read_len, batch_reads=batch_reads, **kw)
        rep = NamedSharding(mesh, P())
        if self.ds > 1:
            assert index.n_buckets % self.ds == 0
            self.block_buckets = index.n_buckets // self.ds
            rows = np.asarray(index.rows).reshape(
                self.ds, self.block_buckets, -1)
            self._rows = jax.device_put(
                rows, NamedSharding(mesh, P("dict", None, None)))
        else:
            self.block_buckets = 0
            self._rows = jax.device_put(index.rows, rep)
        self._tiles = jax.device_put(index.genome_tiles, rep)
        self._dblock = jax.device_put(index.dblock, rep)
        self._sh_reads = NamedSharding(mesh, P("data", None, None))
        self._sh_lens = NamedSharding(mesh, P("data", None))
        self._sh_acc = NamedSharding(mesh, P("data", "dict", None))
        n = index.n_kmers
        self.diff = jax.device_put(
            np.zeros((self.dp, self.ds, n + 2), np.uint32), self._sh_acc)
        self.exact_acc = jax.device_put(
            np.zeros((self.dp, self.ds, n + 2), np.uint32), self._sh_acc)
        self._steps: dict = {}

    def _put_accumulators(self, diff: np.ndarray, acc: np.ndarray) -> None:
        """Checkpoint restore: per-device partials go back sharded.
        Snapshots are mesh-shape-portable only when dp/ds match; a mesh
        change would need a host-side re-partition of the partials
        (sum then re-zero), so it is rejected instead."""
        if diff.shape != (self.dp, self.ds, self.index.n_kmers + 2):
            raise ValueError(
                f"checkpoint accumulator shape {diff.shape} does not match "
                f"dp={self.dp}, ds={self.ds}; resume with the same mesh")
        self.diff = jax.device_put(diff, self._sh_acc)
        self.exact_acc = jax.device_put(acc, self._sh_acc)

    # -- shard_map-wrapped device steps --------------------------------

    def _kernel_dict_kw(self) -> dict:
        if self.ds > 1:
            return {"dict_axis": "dict", "block_buckets": self.block_buckets}
        return {}

    def _make_step(self, tier: int, fmt: str):
        kw = {**self._tier_kw(tier), **self._kernel_dict_kw()}
        L = self.read_len
        sharded_dict = self.ds > 1

        def local(packed, aux, rows, tiles, dblock, diff):
            reads = rowpack.unpack_batch(fmt, packed[0], aux[0], read_len=L)
            d, sp = anchored_count_kernel(
                reads, rows[0] if sharded_dict else rows, tiles, dblock,
                diff[0, 0], None, **kw)
            if sharded_dict:
                # identical on every dict device (inputs replicated,
                # anchor results psum-combined); pmax marks it so
                sp = jax.lax.pmax(sp.astype(jnp.uint8), "dict") != 0
            return d[None, None], sp[None]

        rows_spec = P("dict", None, None) if sharded_dict else P()
        aux_spec = P("data", None) if fmt == "lens" else P("data", None, None)
        smapped = jax.shard_map(
            local, mesh=self.mesh,
            in_specs=(P("data", None, None), aux_spec,
                      rows_spec, P(), P(), P("data", "dict", None)),
            out_specs=(P("data", "dict", None), P("data", None)))
        return jax.jit(smapped, donate_argnums=(5,))

    def _make_exact_step(self, fmt: str):
        k, nb, L = self.k, self.index.n_buckets, self.read_len
        sharded_dict = self.ds > 1
        dkw = self._kernel_dict_kw()

        def local(packed, aux, rows, depth):
            reads = rowpack.unpack_batch(fmt, packed[0], aux[0], read_len=L)
            mask = jnp.ones(reads.shape[0], bool)
            return exact_count_rows(reads, mask,
                                    rows[0] if sharded_dict else rows,
                                    depth[0, 0], k=k, n_buckets=nb,
                                    **dkw)[None, None]

        rows_spec = P("dict", None, None) if sharded_dict else P()
        aux_spec = P("data", None) if fmt == "lens" else P("data", None, None)
        smapped = jax.shard_map(
            local, mesh=self.mesh,
            in_specs=(P("data", None, None), aux_spec,
                      rows_spec, P("data", "dict", None)),
            out_specs=P("data", "dict", None))
        return jax.jit(smapped, donate_argnums=(3,))

    def _pack_put(self, batch: np.ndarray):
        """Pack + shard-put: aux rides the same ("data",) layout as the
        packed codes ("lens" u16 lengths or "mask" bitmask rows)."""
        fmt, pk, aux = rowpack.pack_batch(batch)
        pk = jax.device_put(pk.reshape(self.dp, -1, pk.shape[1]),
                            self._sh_reads)
        if aux.ndim == 1:       # "lens"
            aux = jax.device_put(aux.reshape(self.dp, -1), self._sh_lens)
        else:                   # "mask"
            aux = jax.device_put(aux.reshape(self.dp, -1, aux.shape[1]),
                                 self._sh_reads)
        return fmt, pk, aux

    def _kernel_step(self, batch: np.ndarray, tier: int, put=None):
        if put is None:
            put = self._pack_put(batch)   # pack_h2d=False still shards
        fmt, pk, aux = put
        key = (tier, fmt)
        if key not in self._steps:
            self._steps[key] = self._make_step(tier, fmt)
        self.diff, spilled = self._steps[key](
            pk, aux, self._rows, self._tiles, self._dblock, self.diff)
        return spilled  # (dp, batch/dp) device mask; drained lazily

    def _exact_step(self, batch: np.ndarray, put=None) -> None:
        if put is None:
            put = self._pack_put(batch)
        fmt, pk, aux = put
        key = ("exact", fmt)
        if key not in self._steps:
            self._steps[key] = self._make_exact_step(fmt)
        self.exact_acc = self._steps[key](pk, aux, self._rows,
                                          self.exact_acc)

    def _merged_accumulators(self):
        merged = jax.jit(
            lambda d, a: (jnp.sum(d, axis=(0, 1), dtype=jnp.uint32),
                          jnp.sum(a, axis=(0, 1), dtype=jnp.uint32)))(
            self.diff, self.exact_acc)
        diff, acc = (np.asarray(jax.device_get(x)) for x in merged)
        return diff.astype(np.uint32), acc.astype(np.uint32)
