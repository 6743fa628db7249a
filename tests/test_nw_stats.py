"""Bit-equality of the stats-only aligner (ops/nw.py nw_stats_batch, the
reference of the GPU kernel ops/cuda/nw_stats.cu) against the backpointer
path nw_forward_batch + traceback_batch.

The accept gate (reference src/alignmentFunctions.c:163) consumes only
(length, identities, ylen); the stats aligner propagates those through the
DP instead of materializing the [B, 2L-1, L] move tensor, so both the best
cell and the path stats must match the traceback exactly."""

import numpy as np
import jax.numpy as jnp
import pytest

from imsame_tpu.ops.nw import nw_forward_batch, nw_stats_batch
from imsame_tpu.ops.traceback import traceback_batch


def _mixed_pairs(rng, B, L):
    """Half mutated copies (with indels), half random; ragged lengths."""
    xlen = rng.integers(16, L + 1, B).astype(np.int32)
    ylen = rng.integers(16, L + 1, B).astype(np.int32)
    X = rng.integers(0, 4, (B, L)).astype(np.uint8)
    Y = rng.integers(0, 4, (B, L)).astype(np.uint8)
    for b in range(B // 2):
        ylen[b] = xlen[b]
        Y[b] = X[b].copy()
        mut = rng.random(L) < 0.08
        Y[b][mut] = (Y[b][mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        if b % 3 == 0:  # indel: shift a suffix to force gap moves
            cut = int(rng.integers(4, max(5, xlen[b] - 4)))
            Y[b][cut:] = np.roll(Y[b][cut:], int(rng.integers(1, 4)))
    return X, Y, xlen, ylen


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stats_matches_traceback(seed):
    rng = np.random.default_rng(seed)
    L, B = 128, 64
    X, Y, xlen, ylen = _mixed_pairs(rng, B, L)
    res = nw_forward_batch(
        jnp.asarray(X), jnp.asarray(Y), jnp.asarray(xlen), jnp.asarray(ylen),
        -5, -2, max_len=L,
    )
    tb = traceback_batch(
        res.bp, res.best_i, res.best_j, jnp.asarray(X), jnp.asarray(Y),
        max_len=L,
    )
    st = nw_stats_batch(
        jnp.asarray(X), jnp.asarray(Y), jnp.asarray(xlen), jnp.asarray(ylen),
        -5, -2, max_len=L,
    )
    np.testing.assert_array_equal(np.asarray(st.best_score), np.asarray(res.best_score))
    np.testing.assert_array_equal(np.asarray(st.best_i), np.asarray(res.best_i))
    np.testing.assert_array_equal(np.asarray(st.best_j), np.asarray(res.best_j))
    np.testing.assert_array_equal(np.asarray(st.length), np.asarray(tb.length))
    np.testing.assert_array_equal(np.asarray(st.identities), np.asarray(tb.identities))
