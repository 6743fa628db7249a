"""Packed-row ungapped extension: the gather-light formulation.

Same semantics as ops/extend.py's ``extend_batch`` (which is validated
against the scalar oracle of the reference extension at
src/alignmentFunctions.c:276-387), but reformulated so the device never
does per-base random gathers from the concatenated sequence arrays
(4 x window single-byte gathers per candidate, which dominated the gate's
time on the accelerator the engine was first built for).

Key facts making this possible:

  * The extension walk never leaves the query read / db read that owns
    the hit: the reference's bound checks (array end, read end with the
    last-read asymmetry) all reduce in row coordinates to
    ``o <= read_len - 1 - offset`` (forward) and ``o <= offset - 13``
    (backward) -- see the derivation in the pipeline module docstring.
  * Both walks compare bases at a *fixed relative shift* (the hit
    diagonal), so one contiguous match-bit window per candidate covers
    forward and backward passes.

Layout: reads are packed 2 bits/base into uint32 words (base b of a row
at bits 2*(b%16) of word b//16).  Per candidate the kernel gathers
EW+1 consecutive words per side (one flat gather each), funnel-shifts to
base alignment, XORs to match bits, and runs the same prefix-scan
stop/watermark logic as extend_batch on the unpacked [N, W] window.
Per-candidate traffic: ~2*(2W/16) words instead of 4*W bytes of random
single-byte gathers.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import FIXED_K, POINT

SEED_SCORE = FIXED_K * POINT  # 48
BASES_PER_WORD = 16


def pack_read_rows(
    codes: np.ndarray, start: np.ndarray, lens: np.ndarray, row_len: int
) -> np.ndarray:
    """Pack reads into [n, row_len//16] uint32 rows (2 bits/base,
    little-endian within each word).  Bases past a read's length are 0
    (matching garbage is masked by the kernel's bounds)."""
    assert row_len % BASES_PER_WORD == 0
    n = len(start)
    wp = row_len // BASES_PER_WORD
    if n == 0:
        return np.zeros((0, wp), np.uint32)
    total = len(codes)
    idx = start.astype(np.int64)[:, None] + np.arange(row_len, dtype=np.int64)
    valid = np.arange(row_len)[None, :] < lens[:, None]
    mat = np.where(valid, codes[np.minimum(idx, max(total - 1, 0))], 0).astype(
        np.uint32
    )
    shifts = (2 * np.arange(BASES_PER_WORD, dtype=np.uint32))[None, None, :]
    return np.bitwise_or.reduce(
        mat.reshape(n, wp, BASES_PER_WORD) << shifts, axis=2
    )


class ExtendPackedResult(NamedTuple):
    raw: jax.Array  # [N] int32 raw scores
    passes: jax.Array  # [N] bool e-value gate
    t_len: jax.Array  # [N] int32 (diagnostics)
    idents: jax.Array  # [N] int32 (diagnostics)
    exact: jax.Array  # [N] bool: both walks terminated inside the window
    # (score died or read bound hit), so the result equals any larger-W
    # run.  Enables a cheap small-window first tier that escalates only
    # the rare candidates whose walks outrun it (pipeline._gate).


def _first_true(mask: jax.Array, size: int) -> jax.Array:
    o = jnp.arange(size, dtype=jnp.int32)
    return jnp.min(jnp.where(mask, o, size), axis=1)


def _last_true(mask: jax.Array, size: int) -> jax.Array:
    o = jnp.arange(size, dtype=jnp.int32)
    return jnp.max(jnp.where(mask, o, -1), axis=1)


# Rows up to this many packed words are fetched whole (one row gather)
# instead of as per-word element gathers: row gathers ran ~2x faster than
# scattered element gathers of the same window on the accelerator the
# engine was first built for.  Above the threshold the full row would
# dwarf the window.  The threshold is inherited and not yet measured on
# the GPU.
ROW_GATHER_MAX_WORDS = 32


def _window_words(packed, row, wp, ws, EW):
    """Gather EW funnel-shifted words: word j covers bases ws+16j..ws+16j+15
    of ``row`` (garbage outside [0, 16*wp); callers mask by bounds).
    ``packed`` is the [n_rows, wp] table."""
    if wp <= ROW_GATHER_MAX_WORDS:
        rows = packed[row]  # [N, wp] one contiguous gather per candidate
        lane = jnp.arange(wp, dtype=jnp.int32)[None, :]
        wi0 = (ws >> 4)[:, None]  # arithmetic shift = floor division
        cols = []
        for j in range(EW + 1):
            sel = lane == jnp.clip(wi0 + j, 0, wp - 1)
            cols.append(jnp.sum(jnp.where(sel, rows, jnp.uint32(0)), axis=1))
        W1 = jnp.stack(cols, axis=1)  # [N, EW+1]
    else:
        j = jnp.arange(EW + 1, dtype=jnp.int32)[None, :]
        wi = (ws >> 4)[:, None] + j
        flat = row[:, None] * wp + jnp.clip(wi, 0, wp - 1)
        W1 = jnp.take(packed.reshape(-1), flat)  # [N, EW+1] uint32
    sh = (2 * (ws & 15)).astype(jnp.uint32)[:, None]
    lo = W1[:, :-1]
    hi = W1[:, 1:]
    return jnp.where(sh == 0, lo, (lo >> sh) | (hi << (jnp.uint32(32) - sh)))


@functools.partial(jax.jit, static_argnames=("W",))
def extend_packed(
    qp: jax.Array,  # [n_q, WP] uint32 packed query rows
    dp: jax.Array,  # [n_db, WP] uint32 packed db rows
    r: jax.Array,  # [N] int32 query read ids
    s: jax.Array,  # [N] int32 db read ids
    qoff: jax.Array,  # [N] int32 one past seed end, row coords (pos_q - qstart)
    doff: jax.Array,  # [N] int32 one past seed end, row coords (pos_db - dstart)
    qlen: jax.Array,  # [N] int32 query read length
    dlen: jax.Array,  # [N] int32 db read length
    raw_min: jax.Array,  # [N] int32 per-candidate gate threshold
    *,
    W: int,
) -> ExtendPackedResult:
    assert W % BASES_PER_WORD == 0
    N = r.shape[0]
    wp_q = qp.shape[1]
    wp_d = dp.shape[1]
    EW = (2 * W + 32) // BASES_PER_WORD  # window words
    o = jnp.arange(W, dtype=jnp.int32)[None, :]
    NEGI = jnp.int32(-(2**30))

    # One aligned match-bit window per candidate covering both walks:
    # base index b of the window = query base ws_q + b = db base ws_d + b.
    ws_q = qoff - (W + BASES_PER_WORD)
    ws_d = doff - (W + BASES_PER_WORD)
    qw = _window_words(qp, r, wp_q, ws_q, EW)
    dw = _window_words(dp, s, wp_d, ws_d, EW)
    m = ~(qw ^ dw)
    m2 = m & (m >> jnp.uint32(1)) & jnp.uint32(0x55555555)
    bitpos = (2 * jnp.arange(BASES_PER_WORD, dtype=jnp.uint32))[None, None, :]
    matchall = ((m2[:, :, None] >> bitpos) & jnp.uint32(1)).astype(jnp.bool_)
    matchall = matchall.reshape(N, EW * BASES_PER_WORD)

    fwd = matchall[:, W + 16 : 2 * W + 16]  # match at (qoff+o, doff+o)
    bwd = matchall[:, 4 : W + 4][:, ::-1]  # match at (qoff-13-o, doff-13-o)

    # ---- forward pass ----
    flim = jnp.minimum(dlen - 1 - doff, qlen - 1 - qoff)  # [N]
    in_b = o <= flim[:, None]
    match = fwd & in_b
    pm = jnp.where(in_b, jnp.where(match, POINT, -POINT), 0)
    S = SEED_SCORE + jnp.cumsum(pm, axis=1)

    first_oob = jnp.clip(flim + 1, 0, W)
    first_np = _first_true((S <= 0) & in_b, W)
    stop = jnp.minimum(first_oob, first_np + 1)
    processed = o < stop[:, None]

    idents_fwd = jnp.sum(match & processed, axis=1).astype(jnp.int32)
    Sm = jnp.where(processed, S, NEGI)
    M = jnp.max(Sm, axis=1)
    has_high = M >= SEED_SCORE
    o_best = _last_true(processed & (S == M[:, None]), W)
    end_row = jnp.where(has_high, doff + o_best, doff - 1)
    high_right = jnp.maximum(SEED_SCORE, M)

    # ---- backward pass (running score seeded with high_right) ----
    blim = jnp.minimum(doff, qoff) - (FIXED_K + 1)
    in_b2 = o <= blim[:, None]
    match2 = bwd & in_b2
    pm2 = jnp.where(in_b2, jnp.where(match2, POINT, -POINT), 0)
    S2 = high_right[:, None] + jnp.cumsum(pm2, axis=1)

    first_oob2 = jnp.clip(blim + 1, 0, W)
    first_np2 = _first_true((S2 <= 0) & in_b2, W)
    stop2 = jnp.minimum(first_oob2, first_np2 + 1)
    processed2 = o < stop2[:, None]

    idents_bwd = jnp.sum(match2 & processed2, axis=1).astype(jnp.int32)
    S2m = jnp.where(processed2, S2, NEGI)
    M2 = jnp.max(S2m, axis=1)
    has_high2 = M2 >= SEED_SCORE
    o_best2 = _last_true(processed2 & (S2 == M2[:, None]), W)
    start_row = jnp.where(
        has_high2, (doff - FIXED_K - 1) - o_best2, doff - FIXED_K
    )

    idents = FIXED_K + idents_fwd + idents_bwd
    t_len = (end_row - start_row).astype(jnp.int32)
    raw = (2 * idents - t_len) * POINT

    # A walk is fully determined inside the window iff it stopped for a
    # real reason (read bound: lim < W, or score death: first_np < W)
    # rather than running out of window.  The backward walk seeds its
    # running score from the forward watermark, so forward exactness is
    # required for backward exactness (covered by the conjunction).
    fwd_exact = (flim < W) | (first_np < W)
    bwd_exact = (blim < W) | (first_np2 < W)

    return ExtendPackedResult(
        raw=raw,
        passes=raw >= raw_min,
        t_len=t_len,
        idents=idents,
        exact=fwd_exact & bwd_exact,
    )


def pack_stream(codes: np.ndarray) -> np.ndarray:
    """Pack a concatenated code array 2 bits/base into uint32 words (base b
    at bits 2*(b%16) of word b//16) -- the minimal H2D representation of a
    sample (0.25 B/base); rows_from_stream rebuilds per-read rows on
    device.  Tail bases of the last word are zero."""
    n = len(codes)
    wp = -(-max(n, 1) // BASES_PER_WORD)
    pad = np.zeros(wp * BASES_PER_WORD, np.uint8)
    pad[:n] = codes
    shifts = (2 * np.arange(BASES_PER_WORD, dtype=np.uint32))[None, :]
    return np.bitwise_or.reduce(
        pad.reshape(wp, BASES_PER_WORD).astype(np.uint32) << shifts, axis=1
    )


@functools.partial(jax.jit, static_argnames=("row_len",))
def rows_from_stream(
    stream: jax.Array,  # [W_s] uint32 packed concatenated codes
    start: jax.Array,  # [n] int32 read start offsets (base coords)
    lens: jax.Array,  # [n] int32 read lengths (0 for padding rows)
    *,
    row_len: int,
) -> jax.Array:
    """Device-side pack_read_rows: funnel-shift each read's packed words
    out of the concatenated stream and mask bases past the read length.
    Bit-identical to pack_read_rows (tests/test_extend_packed.py); moves
    the per-compare H2D payload from padded rows (row_len/4 B/read) down
    to the 2-bit stream (len/4 B/read)."""
    assert row_len % BASES_PER_WORD == 0
    wp = row_len // BASES_PER_WORD
    n = start.shape[0]
    Ws = stream.shape[0]
    j = jnp.arange(wp, dtype=jnp.int32)[None, :]
    wi = (start >> 4)[:, None] + j
    lo = stream[jnp.clip(wi, 0, Ws - 1)]  # [n, wp]
    hi = stream[jnp.clip(wi + 1, 0, Ws - 1)]
    sh = (2 * (start & 15)).astype(jnp.uint32)[:, None]
    rows = jnp.where(sh == 0, lo, (lo >> sh) | (hi << (jnp.uint32(32) - sh)))
    # mask bases past the read length: word w keeps nb = len - 16w bases
    nb = jnp.clip(lens[:, None] - BASES_PER_WORD * j, 0, BASES_PER_WORD)
    full = nb >= BASES_PER_WORD
    mask = jnp.where(
        full,
        jnp.uint32(0xFFFFFFFF),
        (jnp.uint32(1) << (2 * jnp.clip(nb, 0, 15)).astype(jnp.uint32))
        - jnp.uint32(1),
    )
    return rows & mask
