"""imsame_tpu -- all-vs-all metagenome read comparison engine on JAX.

A from-scratch JAX/XLA rebuild of the capabilities of the reference C tool
IMSAME (Bitlab-UMA/IMSAME): k-mer dictionary seeding, ungapped extension +
Karlin-Altschul e-value filtering, a quirky semi-global gapped aligner,
and per-read identity/coverage reporting with sample-level Jaccard
similarity.  On a GPU the accept gate's aligner is a CUDA kernel
(ops/cuda/nw_stats.cu); everything else is plain jax.numpy/lax.

Layout:
  io/        FASTA ingest, revcomp, report rendering (host, numpy)
  index/     sorted k-mer arrays + vectorized binary search
  oracle/    faithful scalar engine (parity anchor for tests)
  ops/       batched compute: extension, wavefront NW, traceback
  parallel/  mesh/sharding: data-parallel reads, sharded dictionary
  native/    host runtime in C (ingest, index build, candidate streams)
  pipeline   single-host batched engine
"""

import os as _os

import jax as _jax

# jax_enable_x64 stays OFF: every device array is int32/uint32/uint8 by
# design, and the 64-bit arithmetic that parity depends on (e-value
# thresholds, accept gates, cell tallies) runs on the host in numpy
# float64/int64.

# Persistent compilation cache: where JAX_COMPILATION_CACHE_DIR points if
# it is set (JAX reads it itself), else a fixed directory inside the
# checkout (listed in .gitignore) -- a fixed path, because the path is
# part of the cache key.
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache",
)
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", CACHE_DIR)

__version__ = "0.1.0"
