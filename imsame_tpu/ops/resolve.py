"""Fused gapped-alignment resolve step: row gather -> NW -> traceback.

One jit per pair chunk: the host ships only the pair index vectors
(qread, dbread); the step gathers the 2-bit-packed read rows already
resident on device, unpacks them to code matrices, runs the wavefront
aligner and, for rendering, the batched traceback.  This keeps
host->device traffic per alignment at 8 bytes instead of 2*L.

The accept gate's stats aligner is chosen by the backend alone: on a GPU
the CUDA kernel (ops/nw_cuda.py, which raises if it cannot be built or
loaded), elsewhere the plain wavefront nw_stats_batch (ops/nw.py).  The
render path is plain XLA on every backend.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from .extend_packed import BASES_PER_WORD
from .nw import nw_forward_batch, nw_stats_batch
from .traceback import traceback_batch


def unpack_rows(packed: jax.Array, idx: jax.Array, L: int) -> jax.Array:
    """Gather packed rows by index and unpack to [B, L] uint8 codes."""
    wp = L // BASES_PER_WORD
    rows = packed[idx][:, :wp]  # [B, wp] uint32
    shifts = (2 * jnp.arange(BASES_PER_WORD, dtype=jnp.uint32))[None, None, :]
    codes = (rows[:, :, None] >> shifts) & jnp.uint32(3)
    return codes.reshape(idx.shape[0], L).astype(jnp.uint8)


def select_stats_kernel(backend: str) -> Callable:
    """The accept-gate stats aligner for ``backend``: the CUDA kernel on
    "gpu" (built and registered here, so a failure raises instead of
    falling back), nw_stats_batch otherwise."""
    if backend == "gpu":
        from . import nw_cuda

        nw_cuda.load()
        return nw_cuda.nw_stats_batch_cuda
    return nw_stats_batch


class ResolveNWResult(NamedTuple):
    length: jax.Array  # [B] int32
    identities: jax.Array  # [B] int32
    ylen: jax.Array  # [B] int32
    n_steps: jax.Array  # [B] int32
    chain: jax.Array  # [B, 2L] int32 (device; fetched lazily per accept)


@functools.partial(jax.jit, static_argnames=("max_len",))
def nw_traceback_rows(
    qp: jax.Array,  # [n_q, WPq] uint32 packed query rows
    dp: jax.Array,  # [n_db, WPd] uint32 packed db rows
    r: jax.Array,  # [B] int32 query read ids (padded entries repeat 0)
    s: jax.Array,  # [B] int32 db read ids
    qlen: jax.Array,  # [n_q] int32
    dlen: jax.Array,  # [n_db] int32
    igap,
    egap,
    *,
    max_len: int,
) -> ResolveNWResult:
    X = unpack_rows(dp, s, max_len)
    Y = unpack_rows(qp, r, max_len)
    yl = qlen[r]
    res = nw_forward_batch(X, Y, dlen[s], yl, igap, egap, max_len=max_len)
    tb = traceback_batch(res.bp, res.best_i, res.best_j, X, Y, max_len=max_len)
    return ResolveNWResult(
        length=tb.length,
        identities=tb.identities,
        ylen=yl.astype(jnp.int32),
        n_steps=tb.n_steps,
        chain=tb.chain,
    )


@functools.partial(jax.jit, static_argnames=("max_len",))
def nw_stats_rows(
    qp: jax.Array,  # [n_q, WPq] uint32 packed query rows
    dp: jax.Array,  # [n_db, WPd] uint32 packed db rows
    rs: jax.Array,  # [2, B] int32: row 0 query read ids, row 1 db read ids
    qlen: jax.Array,  # [n_q] int32
    dlen: jax.Array,  # [n_db] int32
    igap,
    egap,
    *,
    max_len: int,
) -> jax.Array:
    """Accept-gate resolve: gather packed rows, run the stats-only aligner
    (no backpointer tensor), return exactly what the accept gate needs
    (reference accept: src/alignmentFunctions.c:163) as one stacked
    [3, B] int32 array (length, identities, ylen), so each chunk is one
    transfer to the host.  The traceback chain for *accepted* pairs is
    produced later by nw_traceback_rows at render time."""
    r = rs[0]
    s = rs[1]
    X = unpack_rows(dp, s, max_len)
    Y = unpack_rows(qp, r, max_len)
    yl = qlen[r]
    nw_fn = select_stats_kernel(jax.default_backend())
    res = nw_fn(X, Y, dlen[s], yl, igap, egap, max_len=max_len)
    return jnp.stack([res.length, res.identities, yl.astype(jnp.int32)])
