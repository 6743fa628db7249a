"""Batched traceback over the wavefront backpointers.

Follows the reference backtracker's control flow
(src/alignmentFunctions.c:493-560) vectorized across pairs with a masked
while-loop: from the best cell, repeatedly read the stored (xfrom, yfrom),
classify the move (diagonal / gap-in-X / gap-in-Y by the reference's
``(dx > dy)`` rule), and accumulate:

  length      diag: +1, gap run: +run length
  identities  diag moves whose characters match -- provably equal to the
              reference's render-time '*' count (gap-run positions always
              pair a base with '-', head padding pairs '-' with spaces)
  igaps/egaps gap-open / gap-extend counts as the reference tallies them

The chain of visited cells is also recorded so the host can reconstruct the
two right-aligned report buffers for accepted pairs without re-running the
DP (io/reconstruct.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .nw import BP_MASK, PACK

# Chain entries for diagonal-run jumps carry this flag bit (coords use
# 24 bits; bit 26 is free); io/reconstruct.py expands them char-by-char.
RUN_FLAG = 1 << 26


class TracebackResult(NamedTuple):
    length: jax.Array  # [B] int32
    identities: jax.Array  # [B] int32
    igaps: jax.Array  # [B] int32
    egaps: jax.Array  # [B] int32
    chain: jax.Array  # [B, 2L] int32 packed px*4096+py, chain[0]=best cell
    n_steps: jax.Array  # [B] int32 number of valid entries in chain


@functools.partial(jax.jit, static_argnames=("max_len",))
def traceback_batch(
    bp: jax.Array,  # [B, 2L-1, L] int32 from nw_forward_batch
    best_i: jax.Array,  # [B] int32
    best_j: jax.Array,  # [B] int32
    X: jax.Array,  # [B, L] uint8
    Y: jax.Array,  # [B, L] uint8
    *,
    max_len: int,
) -> TracebackResult:
    B, ND, L = bp.shape
    assert L == max_len
    CH = 2 * L
    bp_flat = bp.reshape(B, ND * L)

    chain0 = jnp.full((B, CH), -1, jnp.int32)
    chain0 = chain0.at[:, 0].set(best_i * PACK + best_j)

    def cond(state):
        px, py, t, *_ = state
        return jnp.any((px > 0) & (py > 0)) & (t < CH - 1)

    def body(state):
        px, py, t, length, ident, igaps, egaps, chain = state
        active = (px > 0) & (py > 0)

        flat_idx = jnp.clip((px + py) * L + px, 0, ND * L - 1)
        word = jnp.take_along_axis(bp_flat, flat_idx[:, None], axis=1)[:, 0]
        # decode the packed bp word (ops/nw.py layout): low 24 bits are
        # the from-cell, bits 24-27 the diagonal-run length ending here,
        # bits 28-31 the matches within that run.
        frm = word & BP_MASK
        run = (word >> 24) & 15
        mrun = (word >> 28) & 15
        gx = frm // PACK
        gy = frm - gx * PACK
        is_run = run > 0  # every chosen diagonal move carries run >= 1
        fx = jnp.where(is_run, px - run, gx)
        fy = jnp.where(is_run, py - run, gy)

        dx = px - fx
        dy = py - fy
        is_gapx = (~is_run) & (dx > dy)

        add_len = jnp.where(is_run, run, jnp.where(is_gapx, dx, dy))
        add_id = jnp.where(is_run, mrun, 0)
        add_ig = jnp.where(is_run, 0, 1)
        add_eg = jnp.where(is_run, 0, jnp.where(is_gapx, dx - 1, dy - 1))

        length = jnp.where(active, length + add_len, length)
        ident = jnp.where(active, ident + add_id, ident)
        igaps = jnp.where(active, igaps + add_ig, igaps)
        egaps = jnp.where(active, egaps + add_eg, egaps)

        entry = jnp.where(
            is_run, (fx * PACK + fy) | jnp.int32(RUN_FLAG), fx * PACK + fy
        )
        chain = chain.at[:, t + 1].set(
            jnp.where(active, entry, chain[:, t + 1])
        )
        px = jnp.where(active, fx, px)
        py = jnp.where(active, fy, py)
        return (px, py, t + 1, length, ident, igaps, egaps, chain)

    z = jnp.zeros((B,), jnp.int32)
    state = (
        best_i.astype(jnp.int32),
        best_j.astype(jnp.int32),
        jnp.int32(0),
        z,
        z,
        z,
        z,
        chain0,
    )
    px, py, t, length, ident, igaps, egaps, chain = jax.lax.while_loop(
        cond, body, state
    )
    # n_steps = number of moves actually recorded per pair: first t' where
    # the pair went inactive.  Count chain entries != -1 minus 1.
    n_steps = jnp.sum(chain != -1, axis=1) - 1
    return TracebackResult(length, ident, igaps, egaps, chain, n_steps)
