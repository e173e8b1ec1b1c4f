"""Sort-merge-join exact count engine — random-access-free counting.

The packed-table probe pays ~3 random memory ops per k-mer (two
bucket-row gathers + one scatter-add). This engine removes random
access entirely, at the cost of device SORTS:

  1. concat the (static, pre-sorted) dictionary keys — payload rank+1 —
     with the batch's query k-mers (payload 0);
  2. one 2-key sort groups equal keys into runs;
  3. associative scans give, per run, the dictionary rank present in
     the run (if any) and the number of query lanes in it;
  4. run heads emit (rank, count); a final 1-key sort compacts them to
     the front IN RANK ORDER, so the accumulator add is a DENSE slice
     add — no scatter.

Cost per batch ≈ 2 sorts + 4 scans over (n_dict + n_queries) lanes; the
dictionary lanes amortize with larger batches. Whether it beats the
mono probe depends on the measured sort rate (chip_smoke.py times
both); DepthCounter(layout="sortjoin") selects it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from quickmer2.ops import codec

SENT = 0xFFFFFFFF


@functools.partial(jax.jit, static_argnames=("n_dict",), donate_argnums=(4,))
def sortjoin_count_batch(dhi, dlo, qhi, qlo, depth, *, n_dict: int):
    """dhi/dlo: SORTED dictionary keys u32[n] (genome-order rank is the
    sort payload position: rank r = index into the key-sorted order!).
    qhi/qlo: query k-mers u32[Q] (invalid lanes must carry key 0 —
    never in the dictionary). depth: u32[n+1] accumulator in KEY-SORTED
    order (+1 pad lane); callers permute to genome order at finalize
    (Depth vectors are only read at finish, so the permutation is paid
    once, not per batch)."""
    n = n_dict
    hi = jnp.concatenate([dhi, qhi])
    lo = jnp.concatenate([dlo, qlo])
    pay = jnp.concatenate([
        jnp.arange(1, n + 1, dtype=jnp.uint32),
        jnp.zeros(qhi.shape[0], jnp.uint32)])
    hi, lo, pay = jax.lax.sort((hi, lo, pay), num_keys=2)

    same_prev = jnp.concatenate([
        jnp.zeros(1, bool), (hi[1:] == hi[:-1]) & (lo[1:] == lo[:-1])])
    head = ~same_prev
    # a run's LAST lane; reversed, tails are the reversed runs' heads —
    # the correct segment boundaries for the backward (suffix) scans
    tail = jnp.concatenate([head[1:], jnp.ones(1, bool)])

    def comb_max(a, b):
        ah, av = a
        bh, bv = b
        return ah | bh, jnp.where(bh, bv, jnp.maximum(av, bv))

    # rank+1 of the (unique) dict lane in each run: forward + backward
    # segmented max (the dict lane may sit anywhere in the run)
    _, fwd = jax.lax.associative_scan(comb_max, (head, pay))
    _, bwd = jax.lax.associative_scan(comb_max, (tail[::-1], pay[::-1]))
    run_rank = jnp.maximum(fwd, bwd[::-1])

    def comb_sum(a, b):
        ah, av = a
        bh, bv = b
        return ah | bh, jnp.where(bh, bv, av + bv)

    isq = (pay == 0).astype(jnp.uint32)
    _, qf = jax.lax.associative_scan(comb_sum, (head, isq))
    _, qb = jax.lax.associative_scan(comb_sum, (tail[::-1], isq[::-1]))
    qcount = qf + qb[::-1] - isq

    # heads emit (sorted-order rank | SENT, count); 1-key sort compacts
    # rank-ascending to the front → dense add
    key2 = jnp.where(head & (run_rank > 0), run_rank - 1, jnp.uint32(SENT))
    val2 = jnp.where(head, qcount, jnp.uint32(0))
    key2, val2 = jax.lax.sort((key2, val2), num_keys=1)
    return depth.at[: n + 1].add(
        jnp.pad(val2[:n], (0, 1)), mode="promise_in_bounds")


class SortJoinEngine:
    """Key-sorted-order exact counter over code batches.

    The dictionary keys are sorted once at build; depth accumulates in
    that order and is permuted back to genome (rank) order at finish.

    Queries are processed in FIXED-SHAPE tiles of q_tile lanes (key-0
    padded), so the expensive multi-operand sort compiles EXACTLY ONCE
    regardless of batch size — XLA's sort compile time has grown
    super-linearly with the lane count on some backends, which stalled
    an unbounded per-batch sort at production shapes.
    The per-tile sort carries the n dictionary lanes as overhead, so
    the engine's rate scales with q_tile/(n + q_tile) — it wins over
    the mono scatter engine only for dictionaries well below the tile
    size (DepthCounter layout="auto" applies the measured crossover).
    """

    def __init__(self, kmers_in_order: np.ndarray, q_tile: int = 1 << 20):
        kmers = np.asarray(kmers_in_order, np.uint64)
        self.order = np.argsort(kmers, kind="stable")
        skeys = kmers[self.order]
        hi, lo = codec.split_u64(skeys)
        self.dhi = jnp.asarray(hi)
        self.dlo = jnp.asarray(lo)
        self.n = len(kmers)
        self.q_tile = int(q_tile)
        self.depth_sorted = jnp.zeros(self.n + 1, jnp.uint32)

    def count_codes(self, chi, clo, valid) -> None:
        """Device u32[Q] canonical pairs + validity (invalid lanes are
        forced to key 0, which is reserved — quirk Q3). Any Q: tiled
        internally to q_tile-lane sorts (last tile key-0 padded)."""
        qhi = jnp.where(valid, chi, jnp.uint32(0))
        qlo = jnp.where(valid, clo, jnp.uint32(0))
        Q = qhi.shape[0]
        T = self.q_tile
        pad = (-Q) % T
        if pad:
            qhi = jnp.pad(qhi, (0, pad))
            qlo = jnp.pad(qlo, (0, pad))
        for off in range(0, Q + pad, T):
            self.depth_sorted = sortjoin_count_batch(
                self.dhi, self.dlo, qhi[off:off + T], qlo[off:off + T],
                self.depth_sorted, n_dict=self.n)

    def finish(self) -> np.ndarray:
        """Depth in genome (rank) order."""
        sorted_depth = np.asarray(jax.device_get(self.depth_sorted))[: self.n]
        out = np.zeros(self.n, np.uint32)
        out[self.order] = sorted_depth
        return out

    # -- checkpoint/resume (pipelines.count.DepthCounter) ---------------

    def snapshot_depth(self) -> np.ndarray:
        return np.asarray(jax.device_get(self.depth_sorted))

    def restore_depth(self, depth: np.ndarray) -> None:
        if len(depth) != self.n + 1:
            raise ValueError(
                f"sortjoin checkpoint depth length {len(depth)} != "
                f"{self.n + 1}")
        self.depth_sorted = jnp.asarray(np.asarray(depth, np.uint32))
