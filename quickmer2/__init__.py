"""quickmer2 — a JAX k-mer copy-number engine.

A from-scratch JAX/XLA reimplementation of the capabilities of
KiddLab/QuicK-mer2 (reference: QuicKmer.c): alignment-free
paralog-specific copy-number estimation from whole-genome sequencing reads.

Pipeline phases (mirroring the reference's three-phase design,
QuicKmer.c:1485-1494, with the hot loops as batched device steps):

  search  — build a unique-k-mer dictionary from a reference genome
            (sort-based tabulation + batched edit-distance neighbor filter)
  count   — stream sample reads, probe the dictionary with vectorized
            gathers, accumulate per-k-mer depth with scatter-add
  est     — GC-corrected (LOWESS) windowed copy-number estimation
  sparse  — thin a dictionary / regenerate window+GC companions
  index   — build a dictionary from a precomputed k-mer BED list

On-disk formats (.qm/.qgc/.bed/.bin/.txt/CN-bed) interoperate byte-level
with the reference (SURVEY.md section 4).
"""

import os

__version__ = "0.1.0"

# Fixed in-checkout location of the persistent XLA compilation cache. A
# fixed path matters: the directory is part of the cache key, so a path
# that moves between runs never hits.
DEFAULT_COMPILE_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def _enable_persistent_compile_cache() -> None:
    """Persistent XLA compilation cache, on by default.

    The heavy kernels (multi-operand sorts, the Hamming-join slabs, the
    anchored tiers) take seconds to tens of seconds to compile, and a
    fresh process would pay that again. When JAX_COMPILATION_CACHE_DIR
    is set, JAX reads it itself and nothing is set here; otherwise the
    cache goes to DEFAULT_COMPILE_CACHE_DIR."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_COMPILE_CACHE_DIR)


_enable_persistent_compile_cache()

from quickmer2.config import (  # noqa: E402,F401
    CountConfig,
    EstConfig,
    SearchConfig,
)
