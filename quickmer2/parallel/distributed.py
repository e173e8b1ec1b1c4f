"""Multi-host (multi-process) distributed count.

The reference is single-host pthreads (SURVEY.md section 2.3); this has
no reference counterpart: every jax process streams a disjoint shard of
the read stream against its local replica/shard of the dictionary, and
the per-process partial depth vectors are merged by one global
all-reduce at the end (psum over the cards' interconnect within a host,
the network across hosts) — the "communication backend" SURVEY.md
section 5 calls for.

Usage (one process per host, standard jax.distributed bootstrap):

    from quickmer2.parallel import distributed as dist
    dist.initialize()                       # or initialize(coordinator, n, i)
    shard = dist.byte_shard("reads.fq", record_aligned=True)
    ... count the shard locally (DepthCounter / AnchoredDepthCounter) ...
    depth = dist.allreduce_depth(local_depth)

Determinism: each record is counted by exactly one process (shard
boundaries snap to record starts), and the final merge is an integer
sum — the result is bit-identical to a single-process run regardless of
process count (verified by tests/test_distributed.py with real
multi-process CPU jax).
"""

from __future__ import annotations

import os

import numpy as np

import jax
import jax.numpy as jnp


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids: int | list[int] | None = None) -> None:
    """jax.distributed bootstrap. With no args, relies on the
    environment's cluster detection (JAX_COORDINATOR_ADDRESS etc.);
    a plain GPU host has none, so pass coordinator ("localhost:<port>"),
    num_processes and process_id.

    local_device_ids: the cards this process may use. Several processes
    on one multi-card host must each take their own card (e.g. process
    i passes local_device_ids=[i]): a JAX process reserves most of a
    card's memory when it first touches it, so two processes on one
    card fail for want of memory."""
    if coordinator is None and num_processes is None:
        jax.distributed.initialize(local_device_ids=local_device_ids)
    else:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id,
                                   local_device_ids=local_device_ids)


def _snap_to_record(f, pos: int, is_fastq: bool) -> int:
    """Advance pos to the next record start at or after pos.

    FASTA: next line starting with '>'. FASTQ: next '@' header line that
    is genuinely a record start — disambiguated from '@' in quality
    lines by requiring the line 2 ahead to start with '+'."""
    if pos == 0:
        return 0
    f.seek(max(pos - 1, 0))
    f.readline()  # finish any partial line
    while True:
        line_start = f.tell()
        line = f.readline()
        if not line:
            return line_start
        if not is_fastq:
            if line.startswith(b">"):
                return line_start
        else:
            if line.startswith(b"@"):
                mark = f.tell()
                f.readline()                  # sequence
                plus = f.readline()
                f.seek(mark)
                if plus.startswith(b"+"):
                    return line_start


def byte_shard(path: str, process_id: int | None = None,
               num_processes: int | None = None):
    """This process's (offset, length) byte range of the sample file,
    snapped to record boundaries so each read belongs to exactly one
    process."""
    pid = jax.process_index() if process_id is None else process_id
    n = jax.process_count() if num_processes is None else num_processes
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        is_fastq = f.read(1) == b"@"
        raw_lo = size * pid // n
        raw_hi = size * (pid + 1) // n
        lo = _snap_to_record(f, raw_lo, is_fastq)
        hi = _snap_to_record(f, raw_hi, is_fastq) if raw_hi < size else size
    return lo, max(hi - lo, 0)


def read_shard(path: str, offset: int, length: int,
               chunk_bytes: int = 1 << 24):
    """Yield chunks of the byte range."""
    with open(path, "rb") as f:
        f.seek(offset)
        remaining = length
        while remaining > 0:
            data = f.read(min(chunk_bytes, remaining))
            if not data:
                break
            remaining -= len(data)
            yield data


def allreduce_depth(local_depth: np.ndarray,
                    chunk: int = 1 << 24) -> np.ndarray:
    """Sum partial depth vectors across all processes as a DEVICE
    reduction (XLA all-reduce, NCCL on GPUs), chunked so peak device
    memory stays bounded. Each host ships O(n) bytes total — unlike an
    allgather, which ships O(n * P) (8.6 GB x P at GRCh38 scale).
    Single-process: identity. u32 wrap-around sum (Q8 parity)."""
    if jax.process_count() == 1:
        return np.asarray(local_depth)
    import functools
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    devs = np.asarray(jax.devices())          # global, process-major
    mesh = Mesh(devs, ("p",))
    sh_in = NamedSharding(mesh, P("p", None))
    sh_out = NamedSharding(mesh, P())

    @functools.partial(jax.jit, out_shardings=sh_out)
    def _sum(x):
        return jnp.sum(x, axis=0, dtype=jnp.uint32)

    local = jax.local_devices()
    n = len(local_depth)
    out = np.empty(n, np.uint32)
    for off in range(0, n, chunk):
        seg = np.ascontiguousarray(local_depth[off: off + chunk], np.uint32)
        # this process contributes its partial on its first local device;
        # any extra local devices hold zeros (they're extra mesh rows)
        shards = [jax.device_put(
            seg[None] if d == local[0] else np.zeros((1, len(seg)), np.uint32),
            d) for d in local]
        garr = jax.make_array_from_single_device_arrays(
            (len(devs), len(seg)), sh_in, shards)
        res = _sum(garr)                       # fully replicated
        out[off: off + len(seg)] = np.asarray(res.addressable_data(0))
    return out


def run_count_distributed(qm_path: str, sample_path: str, out_prefix: str,
                          batch_bases: int = 1 << 24, fmt: str | None = None,
                          verbose: bool = True, mode: str = "flat",
                          ref_fasta: str | None = None,
                          read_len: int | None = None,
                          data_devices: int | None = None,
                          dict_devices: int | None = None,
                          checkpoint_path: str | None = None,
                          checkpoint_every_bytes: int = 1 << 30,
                          chunk_bytes: int = 1 << 24) -> dict:
    """Data-parallel count across jax processes: each process counts its
    record-aligned byte shard through the standard StreamCounter (so
    mode="anchored" runs the fast path per host — each process loads or
    builds the shared .qai companion — with oversize reads routed to
    the flat path exactly like single-process runs), the per-host
    partials merge with one chunked all-reduce, and process 0 writes
    the artifacts. data_devices additionally shards each host's stream
    over its local devices; dict_devices shards the dictionary rows
    over a "dict" mesh axis (the >HBM escape, same as run_count).

    checkpoint_path enables PER-PROCESS intra-phase checkpointing (the
    SURVEY.md section 5.4 75G-of-81G scenario): each process writes
    <checkpoint_path>.p<process_id> covering its own shard offset +
    StreamCounter snapshot, so a killed process resumes from its last
    checkpoint while the others' work is never repeated. Resume is
    bit-identical to an uninterrupted run (tests/test_distributed.py)."""
    from quickmer2.dictionary import Dictionary
    from quickmer2.io import formats
    from quickmer2.pipelines.count import (
        StreamCounter, _companion, gc_curve_from_depth, make_packer)

    dictionary = Dictionary.from_qm(qm_path)
    index = None
    if mode == "anchored":
        from quickmer2.ops.anchored import AnchoredIndex
        if ref_fasta is None:
            ref_fasta = _companion(qm_path, "")
        index = AnchoredIndex.from_dictionary_and_fasta(
            dictionary, ref_fasta, cache_path=ref_fasta + ".qai")
    sc = StreamCounter(dictionary, mode=mode, index=index,
                       batch_bases=batch_bases, read_len=read_len,
                       data_devices=data_devices, dict_devices=dict_devices)
    lo, length = byte_shard(sample_path)
    with open(sample_path, "rb") as f:
        is_fastq = f.read(1) == b"@"
    fmt = fmt or ("fastq" if is_fastq else "fasta-lines")
    packer = make_packer(fmt)

    my_ckpt = (f"{checkpoint_path}.p{jax.process_index()}"
               if checkpoint_path else None)
    consumed = 0          # bytes of THIS shard already counted
    next_ckpt = checkpoint_every_bytes
    if my_ckpt:
        from quickmer2.utils import checkpoint as ckpt
        resumed = ckpt.load(my_ckpt)
        if resumed is not None:
            consumed, arrays, meta = resumed
            if meta.get("shard") != [lo, length]:
                raise ValueError(
                    f"{my_ckpt}: checkpoint shard {meta.get('shard')} != "
                    f"current shard {[lo, length]}; resume with the same "
                    f"process count and sample file")
            packer.set_state(meta["packer"])
            sc.restore(arrays, meta["state"])
            next_ckpt = consumed + checkpoint_every_bytes
            if verbose:
                print(f"count[p{jax.process_index()}]: resumed at shard "
                      f"byte {consumed}")
    for chunk in read_shard(sample_path, lo + consumed,
                            max(length - consumed, 0), chunk_bytes):
        sc.feed_codes(packer.feed(chunk))
        consumed += len(chunk)
        if my_ckpt and consumed >= next_ckpt:
            from quickmer2.utils import checkpoint as ckpt
            arrays, state_meta = sc.snapshot()
            ckpt.save(my_ckpt, consumed, arrays,
                      meta={"fmt": fmt, "packer": packer.get_state(),
                            "state": state_meta, "shard": [lo, length]})
            next_ckpt += checkpoint_every_bytes
    local = sc.finish()
    depth = allreduce_depth(local)
    if my_ckpt and os.path.exists(my_ckpt):
        os.remove(my_ckpt)

    stats = {"n_kmers": dictionary.n_kmers, "process": jax.process_index(),
             "shard": (lo, length), **sc.stats}
    if jax.process_index() == 0:
        depth_u16 = (depth & 0xFFFF).astype(np.uint16)
        formats.write_u16(out_prefix + ".bin", depth_u16)
        qgc_path = _companion(qm_path, ".qgc")
        if os.path.exists(qgc_path):
            qgc = formats.read_u16(qgc_path)[: dictionary.n_kmers]
            mean, count, var, mean_depth = gc_curve_from_depth(depth_u16, qgc)
            formats.write_gc_curve(out_prefix + ".txt", mean, count, var)
            stats["mean_depth"] = mean_depth
            if verbose:
                print("Mean sequencing depth: %.2f" % mean_depth)
    return stats
