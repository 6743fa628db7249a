"""Faithful scalar implementation of the reference's gapped aligner.

This is NOT textbook Needleman-Wunsch.  The reference variant
(src/alignmentFunctions.c:389-489) is semi-global with free end gaps and a
"long gap" model: instead of adjacent-cell gap moves it jumps from running
row/column maxima, paying one gap-open plus per-base gap-extend for the
distance.  Several order-sensitive quirks are load-bearing for traceback
parity (SURVEY.md section 6.2-6.4) and reproduced exactly:

  * first row and column hold bare +/-POINT scores and admit no gap moves;
    the best cell is searched only on the last row/column, ties broken in
    scan order by ``>=`` (later cells win);
  * the row-max tracker ``mf`` compares against table[i][j-2] but *assigns*
    table[i-1][j-2] (src/alignmentFunctions.c:434-438);
  * the column-max tracker ``mc[j-1]`` is updated from table[i-2][j-1], two
    rows up, with strict ``>`` (src/alignmentFunctions.c:476-480), and is
    initialized from row 0;
  * mf is re-initialized at each row start to the column-0 cell with
    xpos = i (not i-1), so a "left" move's from-cell can sit on the same row.

The backtracker (src/alignmentFunctions.c:493-560) emits into right-aligned
buffers whose last written index is 2*max(xlen, ylen); gap runs emit the run
plus the aligned char of the moving side, and head padding uses spaces on
the side that reached the matrix edge.

This module is the behavioral oracle for the batched wavefront aligners in
imsame_tpu/ops/nw.py and imsame_tpu/ops/cuda/nw_stats.cu.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

from ..constants import POINT

NEG = np.int64(np.iinfo(np.int64).min)


class BestCell(NamedTuple):
    score: int
    xpos: int
    ypos: int


class BasicAlignment(NamedTuple):
    identities: int
    length: int
    igaps: int
    egaps: int


def nw_faithful(
    X: np.ndarray, Y: np.ndarray, igap: int, egap: int
) -> Tuple[np.ndarray, np.ndarray, BestCell]:
    """Compute the DP over full reads X (db) and Y (query).

    Returns (score_table int64[Xend,Yend], from_table int64[Xend,Yend,2],
    best_cell).  Row 0 / column 0 from-entries are undefined (never read by
    the backtracker), as in the reference.
    """
    Xend, Yend = len(X), len(Y)
    score = np.empty((Xend, Yend), dtype=np.int64)
    frm = np.zeros((Xend, Yend, 2), dtype=np.int64)

    bc_score, bc_x, bc_y = int(NEG), 0, 0

    # First row + column-max init (src/alignmentFunctions.c:404-413).
    score[0, :] = np.where(X[0] == Y[:Yend], POINT, -POINT)
    mc_score = score[0, :].copy()  # per-column running max
    mc_x = np.zeros(Yend, dtype=np.int64)
    mc_y = np.arange(Yend, dtype=np.int64)

    for i in range(1, Xend):
        # First column cell + row-max re-init (src/alignmentFunctions.c:426-429).
        s0 = POINT if X[i] == Y[0] else -POINT
        score[i, 0] = s0
        mf_score, mf_x, mf_y = s0, i, 0

        row_i = score[i]
        row_i1 = score[i - 1]
        row_i2 = score[i - 2] if i > 1 else None

        for j in range(1, Yend):
            # Row-max update quirk: compare current row, assign previous row
            # (src/alignmentFunctions.c:434-438).
            if j > 1 and mf_score <= row_i[j - 2]:
                mf_score = row_i1[j - 2]
                mf_x = i - 1
                mf_y = j - 2

            s = POINT if X[i] == Y[j] else -POINT
            score_diag = row_i1[j - 1] + s
            if j > 1:
                score_left = mf_score + igap + (j - (mf_y + 1)) * egap + s
            else:
                score_left = NEG
            if i > 1:
                score_right = mc_score[j - 1] + igap + (i - (mc_x[j - 1] + 1)) * egap + s
            else:
                score_right = NEG

            if score_diag >= score_left and score_diag >= score_right:
                row_i[j] = score_diag
                frm[i, j, 0] = i - 1
                frm[i, j, 1] = j - 1
            elif score_right > score_left:
                row_i[j] = score_right
                frm[i, j, 0] = mc_x[j - 1]
                frm[i, j, 1] = mc_y[j - 1]
            else:
                row_i[j] = score_left
                frm[i, j, 0] = mf_x
                frm[i, j, 1] = mf_y

            # Column-max update from two rows up, strict >
            # (src/alignmentFunctions.c:476-480).
            if i > 1 and j > 1 and row_i2[j - 1] > mc_score[j - 1]:
                mc_score[j - 1] = row_i2[j - 1]
                mc_x[j - 1] = i - 2
                mc_y[j - 1] = j - 1

            # Best cell only on last row/column, >= so later wins
            # (src/alignmentFunctions.c:481-484).
            if i == Xend - 1 or j == Yend - 1:
                if row_i[j] >= bc_score:
                    bc_score = int(row_i[j])
                    bc_x, bc_y = i, j

    return score, frm, BestCell(bc_score, bc_x, bc_y)


def backtrack_faithful(
    X: np.ndarray,
    Y: np.ndarray,
    frm: np.ndarray,
    bc: BestCell,
    x_chars: np.ndarray,
    y_chars: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, int, int, BasicAlignment, int]:
    """Reproduce backtrackingNW (src/alignmentFunctions.c:493-560).

    x_chars/y_chars are the ASCII byte arrays of the reads (for emitting).
    Returns (rec_x, rec_y, head_x, head_y, ba, maximum_len) where rec_* are
    uint8 buffers right-aligned at index maximum_len, ba.identities is 0
    (identities are counted during rendering, as in the reference).
    """
    Xend, Yend = len(X), len(Y)
    maximum_len = 2 * max(Xend, Yend)
    DASH, SPACE = ord("-"), ord(" ")
    # Slack past maximum_len mirrors the reference's reused oversized buffer;
    # bytes there are never rendered and never produce identities.
    buf_len = 2 * maximum_len + 2
    rec_x = np.full(buf_len, SPACE, dtype=np.uint8)
    rec_y = np.full(buf_len, SPACE, dtype=np.uint8)
    head_x = maximum_len
    head_y = maximum_len

    curr_x, curr_y = bc.xpos, bc.ypos
    prev_x, prev_y = curr_x, curr_y
    length = 0
    igaps = 0
    egaps = 0

    for k in range(Xend - 1, curr_x, -1):
        rec_x[head_x] = DASH
        head_x -= 1
    for k in range(Yend - 1, curr_y, -1):
        rec_y[head_y] = DASH
        head_y -= 1

    while curr_x > 0 and curr_y > 0:
        curr_x = int(frm[prev_x, prev_y, 0])
        curr_y = int(frm[prev_x, prev_y, 1])

        if curr_x == prev_x - 1 and curr_y == prev_y - 1:
            rec_x[head_x] = x_chars[prev_x]
            head_x -= 1
            rec_y[head_y] = y_chars[prev_y]
            head_y -= 1
            length += 1
        elif (prev_x - curr_x) > (prev_y - curr_y):
            for k in range(prev_x, curr_x, -1):
                rec_y[head_y] = DASH
                head_y -= 1
                rec_x[head_x] = x_chars[k]
                head_x -= 1
                length += 1
                egaps += 1
            igaps += 1
            egaps -= 1
        else:
            for k in range(prev_y, curr_y, -1):
                rec_x[head_x] = DASH
                head_x -= 1
                rec_y[head_y] = y_chars[k]
                head_y -= 1
                length += 1
                egaps += 1
            igaps += 1
            egaps -= 1
        prev_x, prev_y = curr_x, curr_y

    huecos_x = 0
    huecos_y = 0
    for k in range(curr_x - 1, -1, -1):
        rec_x[head_x] = DASH
        head_x -= 1
        huecos_x += 1
    for k in range(curr_y - 1, -1, -1):
        rec_y[head_y] = DASH
        head_y -= 1
        huecos_y += 1
    if huecos_x >= huecos_y:
        while huecos_x > 0:
            rec_y[head_y] = SPACE
            head_y -= 1
            huecos_x -= 1
    else:
        while huecos_y > 0:
            rec_x[head_x] = SPACE
            head_x -= 1
            huecos_y -= 1

    ba = BasicAlignment(0, length, igaps, egaps)
    return rec_x, rec_y, head_x, head_y, ba, maximum_len
