"""Faithful scalar ungapped extension + Karlin-Altschul e-value.

Mirrors reference alignmentFromQuickHits (src/alignmentFunctions.c:276-387)
step for step, including its quirks (SURVEY.md section 6.6):

  * the backward pass starts its running score at the forward pass's high
    watermark (src/alignmentFunctions.c:339);
  * watermark updates use ``<=`` so later equal scores win;
  * ``idents`` counts matches from *both* passes even beyond the watermarked
    endpoints, and t_len = final_end_x - final_start_x with no +1;
  * the e-value multiplies the full query-read length by the *total*
    database length (not the fragment length).

Used as the behavioral oracle for the batched extension kernel.
"""

from __future__ import annotations

import math
from typing import NamedTuple

from ..constants import FIXED_K, POINT, QF_KARLIN, QF_LAMBDA
from ..io.fasta import SeqInfo


class Quickfrag(NamedTuple):
    x_start: int
    y_start: int
    t_len: int
    coverage: float
    e_value: float


def extend_hit(
    db: SeqInfo,
    q: SeqInfo,
    pos_database: int,
    pos_query: int,
    curr_read: int,
    curr_db_seq: int,
) -> Quickfrag:
    """pos_database/pos_query are one past the seed k-mer's last base."""
    dcodes, qcodes = db.codes, q.codes

    if curr_db_seq == db.n_seqs - 1:
        read_x_start = int(db.start[curr_db_seq])
        read_x_end = db.total_len
    else:
        read_x_start = int(db.start[curr_db_seq])
        read_x_end = int(db.start[curr_db_seq + 1]) - 1

    if curr_read == q.n_seqs - 1:
        read_y_start = int(q.start[curr_read])
        read_y_end = q.total_len
    else:
        read_y_start = int(q.start[curr_read])
        read_y_end = int(q.start[curr_read + 1]) - 1

    cdb = pos_database
    cqy = pos_query
    final_end_x = pos_database - 1
    final_start_x = final_end_x - FIXED_K + 1
    final_start_y = pos_query - FIXED_K
    score_right = FIXED_K * POINT
    score_left = score_right
    high_left = score_left
    high_right = score_right
    idents = FIXED_K

    # Forward search (src/alignmentFunctions.c:318-333).
    while True:
        if score_right > 0 and cdb < db.total_len and cqy < q.total_len:
            if cdb > read_x_end or cqy > read_y_end:
                break
            if dcodes[cdb] == qcodes[cqy]:
                score_right += POINT
                idents += 1
            else:
                score_right -= POINT
            if high_right <= score_right:
                final_end_x = cdb
                high_right = score_right
            cdb += 1
            cqy += 1
        else:
            break

    # Backward search, seeded with the forward high score
    # (src/alignmentFunctions.c:336-357).
    cdb = pos_database - FIXED_K - 1
    cqy = pos_query - FIXED_K - 1
    score_left = high_right
    while True:
        if score_left > 0 and cdb >= 0 and cqy >= 0:
            if cdb < read_x_start or cqy < read_y_start:
                break
            if dcodes[cdb] == qcodes[cqy]:
                score_left += POINT
                idents += 1
            else:
                score_left -= POINT
            if high_left <= score_left:
                final_start_x = cdb
                final_start_y = cqy
                high_left = score_left
            cdb -= 1
            cqy -= 1
        else:
            break

    t_len = final_end_x - final_start_x  # no +1 (src/alignmentFunctions.c:359)
    rawscore = float(idents * POINT - (t_len - idents) * POINT)

    if curr_read == q.n_seqs - 1:
        qlen = float(q.total_len - q.start[curr_read])
    else:
        qlen = float(q.start[curr_read + 1] - q.start[curr_read])

    exponent = -QF_LAMBDA * rawscore
    # C computes expl() in long double: no overflow until exponent ~11356.
    # Python math.exp raises OverflowError past ~709; clamp to +inf, which
    # gives the same (failing) gate comparison.
    ex = math.inf if exponent > 709.0 else math.exp(exponent)
    e_value = QF_KARLIN * qlen * db.total_len * ex
    coverage = t_len / qlen
    return Quickfrag(final_start_x, final_start_y, t_len, coverage, e_value)
