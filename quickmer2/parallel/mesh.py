"""Device mesh construction for the count/search pipelines.

Two sharding axes (SURVEY.md section 2.3 — the reference's pthread
parallelism mapped to devices):

  "data" — read-stream data parallelism: each device (and, multi-host,
           each host's devices) consumes a disjoint shard of the read
           stream; per-device partial depth vectors merge by summation
           at epoch end (the psum analog of the reference's
           shared-memory atomic adds, QuicKmer.c:290-291).
  "dict" — dictionary sharding for tables larger than one card's HBM
           (a 2^32-slot GRCh38 table is ~48 GB in reference layout):
           contiguous slot blocks with a probe halo; every device sees
           the full k-mer batch but probes only the lanes whose home
           slot falls in its block.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def make_mesh(data: int | None = None, dict_: int = 1,
              devices=None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    if data is None:
        data = len(devices) // dict_
    n = data * dict_
    if n > len(devices):
        raise ValueError(f"need {n} devices, have {len(devices)}")
    arr = np.asarray(devices[:n]).reshape(data, dict_)
    return Mesh(arr, ("data", "dict"))
