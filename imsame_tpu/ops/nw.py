"""Batched anti-diagonal wavefront formulation of the reference aligner.

The reference computes the DP row-major with two running trackers: a row
maximum ``mf`` and per-column maxima ``mc`` used for "long gap" moves
(src/alignmentFunctions.c:389-489).  All four score reads of cell (i, j)
live on anti-diagonals d-2 and d-3 (d = i+j):

    T[i-1][j-1]  diag d-2   (diagonal move)
    T[i][j-2]    diag d-2   (mf compare quirk, SURVEY.md 6.3)
    T[i-1][j-2]  diag d-3   (mf assign quirk)
    T[i-2][j-1]  diag d-3   (mc update, SURVEY.md 6.4)

and the mf/mc trackers advance exactly once per (row, diagonal) /
(column, diagonal), so the whole recurrence -- quirks included -- maps onto
a wavefront with carried state vectors.

Key layout decision (no gathers/scatters in the hot loop):
everything is kept in *row-aligned diagonal coordinates*.  For the cells of
diagonal d, index i is the row; the column is j = d - i.  Then:

  * score diagonals S2/S3 are row-indexed; the four reads above are static
    shift-by-one/two of those vectors;
  * the per-row ``mf`` state is row-indexed: elementwise updates;
  * the per-column ``mc`` state is stored *aligned*: slot i holds the state
    of column d-1-i, exactly the column cell (i, d-i) consults for its
    "up-gap" move.  Advancing d moves every column's slot down by one, so
    the whole tracker is a static shift per step, with the freshly
    initialized column (from this diagonal's row-0 cell) entering at slot 0;
  * the query chars along the diagonal shift the same way.

Backpointers are stored in diagonal layout: bp[b, d, i] = xfrom*4096+yfrom
for cell (i, d-i), -1 outside; the traceback reads bp[b, px+py, px].

Tie-breaking parity: the reference picks the best cell by scanning the last
row/column in row-major order with ``>=`` (src/alignmentFunctions.c:481-484),
i.e. the lexicographic max of (score, i, j); reproduced with a packed
(score, i) reduction per diagonal plus (score, i) comparison across
diagonals (same i on a later diagonal implies larger j).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..constants import POINT

NEG = -(2**28)  # "minus infinity" safe against int32 overflow (Python int:
# a module-level jnp constant would initialize the XLA backend at import,
# breaking jax.distributed.initialize in multi-process runs)
PACK = 4096  # coordinate packing base; MAX_READ_SIZE=3000 < 4096

# Backpointer word layout (int32): bits 0-23 = xfrom*PACK+yfrom (< 2^24
# since coords < 3072), bits 24-27 = length of the diagonal-move run
# ending at this cell (capped at RUN_CAP, 0 for gap moves), bits 28-31 =
# matches within that run.  The run fields let the traceback jump whole
# diagonal runs per iteration (the while-loop's serial latency dominates
# otherwise) while staying bit-equivalent.  -1 stays the no-cell
# sentinel: its low 24 bits decode to coords >= 3072, unreachable.
RUN_CAP = 15
BP_MASK = 0x00FFFFFF  # Python int (see NEG)


class NWResult(NamedTuple):
    bp: jax.Array  # [B, 2L-1, L] int32 packed words (see layout above)
    best_score: jax.Array  # [B] int32
    best_i: jax.Array  # [B] int32
    best_j: jax.Array  # [B] int32


class NWStatsResult(NamedTuple):
    """Forward-only result: the accept-gate stats of the best path, with no
    backpointer tensor (see nw_stats_batch)."""

    best_score: jax.Array  # [B] int32
    best_i: jax.Array  # [B] int32
    best_j: jax.Array  # [B] int32
    length: jax.Array  # [B] int32 alignment length of the best path
    identities: jax.Array  # [B] int32 matches on the best path


def _shift1(a, fill=NEG):
    """a'[:, i] = a[:, i-1]; a'[:, 0] = fill."""
    return jnp.concatenate(
        [jnp.full((a.shape[0], 1), fill, a.dtype), a[:, :-1]], axis=1
    )


@functools.partial(jax.jit, static_argnames=("max_len",))
def nw_forward_batch(
    X: jax.Array,  # [B, L] uint8 codes, padded
    Y: jax.Array,  # [B, L] uint8 codes, padded
    xlen: jax.Array,  # [B] int32 actual db-read lengths (>= 2)
    ylen: jax.Array,  # [B] int32 actual query-read lengths (>= 2)
    igap: jax.Array,  # scalar int32 (negative)
    egap: jax.Array,  # scalar int32 (negative)
    *,
    max_len: int,
) -> NWResult:
    B, L = X.shape
    assert L == max_len
    ND = 2 * L - 1
    i_idx = jnp.arange(L, dtype=jnp.int32)[None, :]  # [1, L] row index
    xlenc = xlen.astype(jnp.int32)[:, None]
    ylenc = ylen.astype(jnp.int32)[:, None]
    igap = jnp.asarray(igap, jnp.int32)
    egap = jnp.asarray(egap, jnp.int32)

    Xc = X.astype(jnp.int32)
    Yc = Y.astype(jnp.int32)
    ZCOL = jnp.zeros((B, 1), jnp.int32)

    def body(d, carry):
        (s1, s2, s3, rn1, rn2, mr1, mr2,
         mf_s, mf_x, mf_y, mc_s, mc_x, yd, bs, bi, bj, bp) = carry
        d = jnp.int32(d)
        j_idx = d - i_idx  # [1, L] column per row on this diagonal

        # Query chars along the diagonal: yd[:, i] == Y[:, d-i].
        y_new = jax.lax.dynamic_slice(Yc, (jnp.int32(0), d), (B, 1))
        yd = jnp.concatenate([y_new, yd[:, :-1]], axis=1)

        valid = (j_idx >= 0) & (i_idx < xlenc) & (j_idx < ylenc)
        inner = valid & (i_idx >= 1) & (j_idx >= 1)
        s_pm = jnp.where(Xc == yd, POINT, -POINT)  # [B, L]

        t_im1_jm1 = _shift1(s2)
        t_i_jm2 = s2
        t_im1_jm2 = _shift1(s3)
        t_im2_jm1 = _shift1(_shift1(s3))

        # --- mf update (before the cell), rows with j > 1 ---
        mf_upd = valid & (i_idx >= 1) & (j_idx >= 2) & (mf_s <= t_i_jm2)
        mf_s = jnp.where(mf_upd, t_im1_jm2, mf_s)
        mf_x = jnp.where(mf_upd, i_idx - 1, mf_x)
        mf_y = jnp.where(mf_upd, j_idx - 2, mf_y)

        # --- cell scores ---
        score_diag = t_im1_jm1 + s_pm
        score_left = jnp.where(
            j_idx >= 2, mf_s + igap + (j_idx - (mf_y + 1)) * egap + s_pm, NEG
        )
        # mc state for column j-1 sits at aligned slot i.
        score_right = jnp.where(
            i_idx >= 2, mc_s + igap + (i_idx - (mc_x + 1)) * egap + s_pm, NEG
        )

        pick_diag = (score_diag >= score_left) & (score_diag >= score_right)
        pick_right = (~pick_diag) & (score_right > score_left)
        cell = jnp.where(
            pick_diag, score_diag, jnp.where(pick_right, score_right, score_left)
        )
        xfrom = jnp.where(pick_diag, i_idx - 1, jnp.where(pick_right, mc_x, mf_x))
        yfrom = jnp.where(
            pick_diag, j_idx - 1, jnp.where(pick_right, j_idx - 1, mf_y)
        )

        # Diagonal-run tracking for the jumping traceback: cell (i-1,j-1)
        # lives on diagonal d-2 at row i-1.
        match_i = jnp.where(Xc == yd, 1, 0)
        run_prev = _shift1(rn2, 0)
        mr_prev = _shift1(mr2, 0)
        is_diag = pick_diag & inner
        capped = run_prev == RUN_CAP
        run_cur = jnp.where(
            is_diag, jnp.where(capped, 1, run_prev + 1), 0
        )
        mr_cur = jnp.where(
            is_diag, jnp.where(capped, match_i, mr_prev + match_i), 0
        )

        # Border cells (i==0 or j==0) score +/-POINT with no gap moves.
        border = valid & ((i_idx == 0) | (j_idx == 0))
        cell = jnp.where(border, s_pm, cell)
        s0 = jnp.where(valid, cell, NEG)

        # --- mc update (after the cell), strict >, from two rows up ---
        mc_upd = inner & (i_idx >= 2) & (j_idx >= 2) & (t_im2_jm1 > mc_s)
        mc_s = jnp.where(mc_upd, t_im2_jm1, mc_s)
        mc_x = jnp.where(mc_upd, i_idx - 2, mc_x)

        # --- mf re-init from this diagonal's column-0 cell (d, 0) ---
        col0_ok = (d < L) & (xlen.astype(jnp.int32) > d)  # [B]
        x_at_d = jax.lax.dynamic_slice(Xc, (jnp.int32(0), d), (B, 1))
        col0_score = jnp.where(x_at_d == Yc[:, :1], POINT, -POINT)
        upd_col = (i_idx == d) & col0_ok[:, None]
        mf_s = jnp.where(upd_col, col0_score, mf_s)
        mf_x = jnp.where(upd_col, d, mf_x)
        mf_y = jnp.where(upd_col, 0, mf_y)

        # --- advance mc to diagonal d+1: shift down, push column d ---
        row0_ok = (d < L) & (ylen.astype(jnp.int32) > d)  # [B]
        new_col_s = jnp.where(row0_ok[:, None], s0[:, :1], NEG)
        mc_s = jnp.concatenate([new_col_s, mc_s[:, :-1]], axis=1)
        mc_x = jnp.concatenate([ZCOL, mc_x[:, :-1]], axis=1)

        # --- best cell on last row/column, reference tie-break ---
        elig = inner & ((i_idx == xlenc - 1) | (j_idx == ylenc - 1))
        packed = jnp.where(elig, s0 * 8192 + i_idx, jnp.int32(-(2**31) + 1))
        dbest = jnp.max(packed, axis=1)
        any_elig = jnp.any(elig, axis=1)
        ds = jnp.floor_divide(dbest, 8192)
        di = dbest - ds * 8192
        take = any_elig & ((ds > bs) | ((ds == bs) & (di >= bi)))
        bs = jnp.where(take, ds, bs)
        bi = jnp.where(take, di, bi)
        bj = jnp.where(take, d - di, bj)

        # --- backpointers for this diagonal (packed with run fields) ---
        bp_d = jnp.where(
            inner,
            (xfrom * PACK + yfrom) | (run_cur << 24) | (mr_cur << 28),
            jnp.int32(-1),
        )
        zero = jnp.int32(0)
        bp = jax.lax.dynamic_update_slice(bp, bp_d[:, None, :], (zero, d, zero))

        # Rotate score diagonals: next (d-1, d-2, d-3) = (d, d-1, d-2).
        return (s0, s1, s2, run_cur, rn1, mr_cur, mr1,
                mf_s, mf_x, mf_y, mc_s, mc_x, yd, bs, bi, bj, bp)

    z = lambda: jnp.full((B, L), NEG, jnp.int32)
    zi = lambda: jnp.zeros((B, L), jnp.int32)
    init = (
        z(),  # s1: diag d-1 (passed through one step)
        z(),  # s2: diag d-2
        z(),  # s3: diag d-3
        zi(),  # rn1: diag-run lengths of d-1
        zi(),  # rn2: diag-run lengths of d-2
        zi(),  # mr1: run match counts of d-1
        zi(),  # mr2: run match counts of d-2
        z(),  # mf_s
        zi(),  # mf_x
        zi(),  # mf_y
        z(),  # mc_s (aligned: slot i = column d-1-i)
        zi(),  # mc_x
        zi(),  # yd (query chars along diagonal)
        jnp.full((B,), jnp.int32(-(2**31) + 1)),  # best score
        jnp.zeros((B,), jnp.int32),
        jnp.zeros((B,), jnp.int32),
        jnp.full((B, ND, L), -1, jnp.int32),  # bp
    )
    out = jax.lax.fori_loop(0, ND, body, init)
    bs, bi, bj, bp = out[-4], out[-3], out[-2], out[-1]
    return NWResult(bp=bp, best_score=bs, best_i=bi, best_j=bj)


@functools.partial(jax.jit, static_argnames=("max_len",))
def nw_stats_batch(
    X: jax.Array,  # [B, L] uint8 codes, padded
    Y: jax.Array,  # [B, L] uint8 codes, padded
    xlen: jax.Array,  # [B] int32 actual db-read lengths (>= 2)
    ylen: jax.Array,  # [B] int32 actual query-read lengths (>= 2)
    igap: jax.Array,  # scalar int32 (negative)
    egap: jax.Array,  # scalar int32 (negative)
    *,
    max_len: int,
) -> NWStatsResult:
    """Forward-only aligner: same recurrence and tie-breaks as
    nw_forward_batch, but instead of materializing the [B, 2L-1, L]
    backpointer tensor it *propagates the accept-gate statistics of the
    best path through the DP itself*.

    Each cell carries (length, identities) of the path the traceback would
    reconstruct from it; the per-move contributions mirror
    ops/traceback.py exactly (which itself mirrors the reference
    backtracker, src/alignmentFunctions.c:493-560):

      border cell (i==0 or j==0)   len = 0, id = 0 (the traceback stops
                                   there without reading its move)
      diagonal from (i-1, j-1)     len+1, id+match(i,j)
      gap from (fx, fy)            len += max-side run (dx if dx>dy else
                                   dy), id += 0

    The mf/mc gap trackers therefore carry the (len, id) of their tracked
    cell next to its score: mf assigns from T[i-1][j-2] (diag d-3, the
    SURVEY.md 6.3 quirk), mc from T[i-2][j-1] (diag d-3, quirk 6.4), and
    both re-initialize from border cells (len = id = 0).

    Both stats ride ONE int32 word w = len + (id << 16): every update is
    an add or a select, len < 2*MAX_READ_SIZE < 2^16 never carries into
    the id half, and the packing halves the carried wavefront state.

    Why this exists: acceptance (coverage/identity, reference
    src/alignmentFunctions.c:163) needs only (length, identities, ylen) --
    the full chain is needed only to *render* accepted pairs.  Dropping bp
    removes ~0.5 MB/pair of device-memory writes at L=256; the report path
    re-runs the bp kernel on accepted pairs only.  Bit-equality with
    nw_forward_batch + traceback_batch is proven in tests/test_nw_stats.py.
    On a GPU the accept gate runs ops/cuda/nw_stats.cu instead, which is
    bit-equal to this function (chip_smoke.py); this is its reference.
    """
    B, L = X.shape
    assert L == max_len
    ND = 2 * L - 1
    i_idx = jnp.arange(L, dtype=jnp.int32)[None, :]
    xlenc = xlen.astype(jnp.int32)[:, None]
    ylenc = ylen.astype(jnp.int32)[:, None]
    igap = jnp.asarray(igap, jnp.int32)
    egap = jnp.asarray(egap, jnp.int32)

    Xc = X.astype(jnp.int32)
    Yc = Y.astype(jnp.int32)
    ZCOL = jnp.zeros((B, 1), jnp.int32)

    def body(d, carry):
        (s1, s2, s3, w1, w2, w3,
         mf_s, mf_x, mf_y, mf_w, mc_s, mc_x, mc_w, yd,
         bs, bi, bj, bw) = carry
        d = jnp.int32(d)
        j_idx = d - i_idx

        y_new = jax.lax.dynamic_slice(Yc, (jnp.int32(0), d), (B, 1))
        yd = jnp.concatenate([y_new, yd[:, :-1]], axis=1)

        valid = (j_idx >= 0) & (i_idx < xlenc) & (j_idx < ylenc)
        inner = valid & (i_idx >= 1) & (j_idx >= 1)
        s_pm = jnp.where(Xc == yd, POINT, -POINT)
        # diag-move stat increment: len +1, id +match
        diag_add = jnp.where(Xc == yd, (1 << 16) + 1, 1)

        t_im1_jm1 = _shift1(s2)
        t_i_jm2 = s2
        t_im1_jm2 = _shift1(s3)
        t_im2_jm1 = _shift1(_shift1(s3))
        # packed path stats of the same from-cells
        w_im1_jm1 = _shift1(w2, 0)
        w_im1_jm2 = _shift1(w3, 0)
        w_im2_jm1 = _shift1(_shift1(w3, 0), 0)

        # --- mf update (before the cell), rows with j > 1 ---
        mf_upd = valid & (i_idx >= 1) & (j_idx >= 2) & (mf_s <= t_i_jm2)
        mf_s = jnp.where(mf_upd, t_im1_jm2, mf_s)
        mf_x = jnp.where(mf_upd, i_idx - 1, mf_x)
        mf_y = jnp.where(mf_upd, j_idx - 2, mf_y)
        mf_w = jnp.where(mf_upd, w_im1_jm2, mf_w)

        # --- cell scores (identical decision logic to nw_forward_batch) ---
        score_diag = t_im1_jm1 + s_pm
        score_left = jnp.where(
            j_idx >= 2, mf_s + igap + (j_idx - (mf_y + 1)) * egap + s_pm, NEG
        )
        score_right = jnp.where(
            i_idx >= 2, mc_s + igap + (i_idx - (mc_x + 1)) * egap + s_pm, NEG
        )
        pick_diag = (score_diag >= score_left) & (score_diag >= score_right)
        pick_right = (~pick_diag) & (score_right > score_left)
        cell = jnp.where(
            pick_diag, score_diag, jnp.where(pick_right, score_right, score_left)
        )

        # --- path stats of this cell ---
        # gap-move length adds: the traceback's where(dx > dy, dx, dy).
        dxl = i_idx - mf_x
        dyl = j_idx - mf_y
        add_left = jnp.where(dxl > dyl, dxl, dyl)
        dxr = i_idx - mc_x
        add_right = jnp.where(dxr > 1, dxr, 1)
        w_new = jnp.where(
            pick_diag,
            w_im1_jm1 + diag_add,
            jnp.where(pick_right, mc_w + add_right, mf_w + add_left),
        )

        border = valid & ((i_idx == 0) | (j_idx == 0))
        cell = jnp.where(border, s_pm, cell)
        s0 = jnp.where(valid, cell, NEG)
        w0 = jnp.where(inner, w_new, 0)

        # --- mc update (after the cell), strict >, from two rows up ---
        mc_upd = inner & (i_idx >= 2) & (j_idx >= 2) & (t_im2_jm1 > mc_s)
        mc_s = jnp.where(mc_upd, t_im2_jm1, mc_s)
        mc_x = jnp.where(mc_upd, i_idx - 2, mc_x)
        mc_w = jnp.where(mc_upd, w_im2_jm1, mc_w)

        # --- mf re-init from this diagonal's column-0 cell (d, 0) ---
        col0_ok = (d < L) & (xlen.astype(jnp.int32) > d)
        x_at_d = jax.lax.dynamic_slice(Xc, (jnp.int32(0), d), (B, 1))
        col0_score = jnp.where(x_at_d == Yc[:, :1], POINT, -POINT)
        upd_col = (i_idx == d) & col0_ok[:, None]
        mf_s = jnp.where(upd_col, col0_score, mf_s)
        mf_x = jnp.where(upd_col, d, mf_x)
        mf_y = jnp.where(upd_col, 0, mf_y)
        mf_w = jnp.where(upd_col, 0, mf_w)  # border cell: stats 0

        # --- advance mc to diagonal d+1: shift down, push column d ---
        row0_ok = (d < L) & (ylen.astype(jnp.int32) > d)
        new_col_s = jnp.where(row0_ok[:, None], s0[:, :1], NEG)
        mc_s = jnp.concatenate([new_col_s, mc_s[:, :-1]], axis=1)
        mc_x = jnp.concatenate([ZCOL, mc_x[:, :-1]], axis=1)
        mc_w = jnp.concatenate([ZCOL, mc_w[:, :-1]], axis=1)  # border: 0

        # --- best cell on last row/column, reference tie-break ---
        elig = inner & ((i_idx == xlenc - 1) | (j_idx == ylenc - 1))
        packed = jnp.where(elig, s0 * 8192 + i_idx, jnp.int32(-(2**31) + 1))
        dbest = jnp.max(packed, axis=1)
        any_elig = jnp.any(elig, axis=1)
        ds = jnp.floor_divide(dbest, 8192)
        di = dbest - ds * 8192
        take = any_elig & ((ds > bs) | ((ds == bs) & (di >= bi)))
        at_di = i_idx == di[:, None]
        w_at = jnp.sum(jnp.where(at_di, w0, 0), axis=1)
        bs = jnp.where(take, ds, bs)
        bi = jnp.where(take, di, bi)
        bj = jnp.where(take, d - di, bj)
        bw = jnp.where(take, w_at, bw)

        return (s0, s1, s2, w0, w1, w2,
                mf_s, mf_x, mf_y, mf_w, mc_s, mc_x, mc_w, yd,
                bs, bi, bj, bw)

    z = lambda: jnp.full((B, L), NEG, jnp.int32)
    zi = lambda: jnp.zeros((B, L), jnp.int32)
    init = (
        z(), z(), z(),  # s1, s2, s3
        zi(), zi(), zi(),  # w1, w2, w3
        z(), zi(), zi(), zi(),  # mf_s, mf_x, mf_y, mf_w
        z(), zi(), zi(),  # mc_s, mc_x, mc_w
        zi(),  # yd
        jnp.full((B,), jnp.int32(-(2**31) + 1)),  # best score
        jnp.zeros((B,), jnp.int32),  # best i
        jnp.zeros((B,), jnp.int32),  # best j
        jnp.zeros((B,), jnp.int32),  # best packed stats
    )
    out = jax.lax.fori_loop(0, ND, body, init)
    bs, bi, bj, bw = out[-4], out[-3], out[-2], out[-1]
    return NWStatsResult(
        best_score=bs, best_i=bi, best_j=bj,
        length=bw & 0xFFFF, identities=bw >> 16,
    )
