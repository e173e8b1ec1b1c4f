"""Genome-sharded device membership scan for search pass 2 / sparse
regeneration — the sequence-parallel (SP) axis of SURVEY.md section 2.3
applied to the genome itself.

Reference hot loop #3 (dump_kmer_list, QuicKmer.c:981-1021) walks the
chromosome byte-by-byte probing the dictionary — at GRCh38 scale that
is ~3.1 G probes of a 49 GB table on one core. Here the chromosome
streams through fixed-shape device chunks; each chunk is split over the
("data",) mesh axis with a k-1 code halo (no window lost at shard
boundaries, same invariant as the count path), and every position
probes the packed survivor table with two row gathers. Only the 1-bit
hit mask returns to the host (packed), so D2H is G/8 bytes total.

The emitter's remaining work (GC cumsum, window rows, control flags)
is vectorized host numpy over hit positions only.

Output is BIT-IDENTICAL to the host scan (tests/test_emit_parallel.py
compares .bed/.qgc/.qm byte-for-byte on a multi-chromosome genome).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from quickmer2.ops import codec
from quickmer2.ops.codec import SEP
from quickmer2.ops.packed_table import probe_packed
from quickmer2.parallel.count_parallel import split_codes_overlap


class DeviceMembershipScanner:
    """Membership of each genome position's canonical k-mer in a packed
    survivor table, computed on device in genome-sharded chunks."""

    def __init__(self, packed_table, k: int, data_devices: int = 1,
                 chunk: int = 1 << 22):
        from quickmer2.parallel.mesh import make_mesh
        self.k = k
        self.n_buckets = packed_table.n_buckets
        self.dp = max(int(data_devices or 1), 1)
        self.chunk = -(-chunk // self.dp) * self.dp   # divisible by dp
        if self.dp > 1:
            self.mesh = make_mesh(self.dp, 1)
            rows = packed_table.rows
            self.rows = jax.device_put(
                rows, NamedSharding(self.mesh, P(None, None)))
            self._step = self._make_sharded_step()
            self._sh_data = NamedSharding(self.mesh, P("data", None))
        else:
            self.rows = jnp.asarray(packed_table.rows)
            self._step = functools.partial(
                _member_chunk, k=k, n_buckets=self.n_buckets)

    def _make_sharded_step(self):
        k, n_buckets = self.k, self.n_buckets

        def local(codes, rows):
            hit = _member_chunk(codes[0], rows, k=k, n_buckets=n_buckets)
            return hit[None]

        smapped = jax.shard_map(
            local, mesh=self.mesh,
            in_specs=(P("data", None), P(None, None)),
            out_specs=P("data", None))
        return jax.jit(smapped)

    def scan(self, codes: np.ndarray) -> np.ndarray:
        """bool[len(codes)-k+1] — canonical k-mer at each window start
        is a (nonzero, valid) member of the survivor table."""
        G = len(codes)
        W = G - self.k + 1
        if W <= 0:
            return np.zeros(max(W, 0), bool)
        out = np.empty(W, bool)
        step = self.chunk
        for off in range(0, W, step):
            seg = codes[off: off + step + self.k - 1]
            pad = step + self.k - 1 - len(seg)
            if pad > 0:
                seg = np.pad(seg, (0, pad), constant_values=SEP)
            if self.dp > 1:
                shards = split_codes_overlap(seg, self.dp, self.k)
                hit = np.asarray(
                    self._step(jax.device_put(shards, self._sh_data),
                               self.rows)).reshape(-1)
            else:
                hit = np.asarray(self._step(jnp.asarray(seg), self.rows))
            take = min(step, W - off)
            out[off: off + take] = hit[:take]
        return out


@functools.partial(jax.jit, static_argnames=("k", "n_buckets"))
def _member_chunk(codes, rows, *, k: int, n_buckets: int):
    chi, clo, valid = codec.sliding_kmers(codes, k)
    found, _, _ = probe_packed(rows, chi, clo, n_buckets, jnp.uint32(0))
    return found & valid & ((chi | clo) != 0)
