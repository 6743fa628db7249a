"""Faithful sequential engine -- the behavioral oracle for the batched pipeline.

Reproduces the reference worker loop computeAlignmentsByThread
(src/alignmentFunctions.c:43-208) semantics exactly, including:

  * the read-boundary off-by-one: each read's last base is not consumed for
    its own k-mer stream but becomes the first char of the next read's
    stream (SURVEY.md section 6.5);
  * a thread's *first* read does not receive the previous read's trailing
    base, so the candidate stream depends on the thread split
    (src/IMSAME.c:414-452); n_threads=1 gives the canonical stream;
  * hits walked newest-first (descending database position);
  * first accepted alignment wins and the rest of the read is skipped
    (NWaligned, src/alignmentFunctions.c:172,189-190); after the *last*
    read accepts, the reference reads start_pos[n_seqs] (one past the
    array) -- with a fresh zero page this yields a huge unsigned position
    and ends the scan, which is what we do deterministically.

Slow (scalar Python); intended for tests on small inputs and as the parity
anchor for the batched engine.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import Config
from ..constants import FIXED_K, MAX_READ_SIZE
from ..index.kmer import KmerIndex, build_index, pack_kmers
from ..io.fasta import CODE_TO_CHAR, SeqInfo
from ..io.report import format_record, render_alignment
from .extend import extend_hit
from .nw import backtrack_faithful, nw_faithful


@dataclasses.dataclass
class CompareResult:
    accepted: int
    n_query: int
    n_db: int
    pairs: List[Tuple[int, int]]  # (query_read, db_read) accepted pairs
    out_bytes: bytes  # byte-identical -out file content (thread-seq order)

    @property
    def jaccard(self) -> float:
        return self.accepted / ((self.n_db + self.n_query) - self.accepted)


class OracleEngine:
    def __init__(self, db: SeqInfo, cfg: Optional[Config] = None):
        self.db = db
        self.cfg = cfg or Config()
        self.cfg.validate()
        self.index: KmerIndex = build_index(db)
        # (db_seq, q_read) -> (length, identities, record_block)
        self._nw_cache: Dict[Tuple[int, int], Tuple[int, int, bytes]] = {}

    def _nw_pair(self, q: SeqInfo, curr_db_seq: int, curr_read: int):
        key = (curr_db_seq, curr_read)
        hit = self._nw_cache.get(key)
        if hit is not None:
            return hit
        db = self.db
        xs, xe = int(db.start[curr_db_seq]), db.read_end(curr_db_seq)
        ys, ye = int(q.start[curr_read]), q.read_end(curr_read)
        X = db.codes[xs:xe]
        Y = q.codes[ys:ye]
        _, frm, bc = nw_faithful(X, Y, self.cfg.igap, self.cfg.egap)
        rec_x, rec_y, hx, hy, ba, ml = backtrack_faithful(
            X, Y, frm, bc, CODE_TO_CHAR[X], CODE_TO_CHAR[Y]
        )
        block, identities = render_alignment(rec_x, rec_y, hx, hy, ml)
        out = (ba.length, identities, block)
        self._nw_cache[key] = out
        return out

    def _run_thread(self, q: SeqInfo, rfrom: int, rto: int):
        cfg = self.cfg
        db = self.db
        idx = self.index
        accepted = 0
        records: List[bytes] = []
        pairs: List[Tuple[int, int]] = []
        if rfrom >= q.n_seqs or rfrom >= rto:
            return accepted, records, pairs

        curr_read = rfrom
        curr_pos = int(q.start[curr_read])
        crr_seq_l = 0
        total_len = q.total_len
        n_seqs = q.n_seqs
        idx_pos, idx_sid = idx.pos, idx.sid

        while curr_read < rto and curr_pos < total_len:
            up_to = int(q.start[curr_read + 1]) - 1 if curr_read < n_seqs - 1 else total_len
            if curr_pos == up_to:
                crr_seq_l = 0
                curr_read += 1
                continue
            crr_seq_l += 1  # concatenated array holds only ACGT
            nw_aligned = False
            if crr_seq_l >= FIXED_K:
                kstart = np.array([curr_pos - FIXED_K + 1], dtype=np.int64)
                key = int(pack_kmers(q.codes, kstart)[0])
                lo, hi = idx.lookup_range(key)
                for h in range(lo, hi):  # descending db position
                    if nw_aligned:
                        break
                    curr_db_seq = int(idx_sid[h])
                    qf = extend_hit(
                        db, q, int(idx_pos[h]), curr_pos + 1, curr_read, curr_db_seq
                    )
                    if qf.e_value < cfg.min_e_value:
                        xlen = db.read_len(curr_db_seq)
                        ylen = q.read_len(curr_read)
                        if xlen > MAX_READ_SIZE or ylen > MAX_READ_SIZE:
                            raise ValueError("Read size reached for gapped alignment.")
                        length, identities, block = self._nw_pair(q, curr_db_seq, curr_read)
                        if (
                            length / ylen >= cfg.min_coverage
                            and identities / length >= cfg.min_identity
                        ):
                            accepted += 1
                            records.append(
                                format_record(
                                    curr_read, curr_db_seq, identities, length, ylen, block
                                )
                            )
                            pairs.append((curr_read, curr_db_seq))
                            nw_aligned = True
                if nw_aligned:
                    if curr_read == n_seqs - 1:
                        break  # reference reads start_pos one past the end here
                    curr_pos = int(q.start[curr_read + 1]) - 2
                else:
                    crr_seq_l -= 1
            curr_pos += 1

        return accepted, records, pairs

    def compare(self, q: SeqInfo) -> CompareResult:
        """All query reads vs the database; reproduces the reference's
        static thread partition (src/IMSAME.c:414-452)."""
        n_threads = self.cfg.n_threads
        rpt = q.n_seqs // n_threads
        accepted = 0
        out = bytearray()
        pairs: List[Tuple[int, int]] = []
        for t in range(n_threads):
            rfrom = t * rpt
            rto = (t + 1) * rpt if t < n_threads - 1 else q.n_seqs
            a, recs, prs = self._run_thread(q, rfrom, rto)
            accepted += a
            for r in recs:
                out.extend(r)
            pairs.extend(prs)
        return CompareResult(
            accepted=accepted,
            n_query=q.n_seqs,
            n_db=self.db.n_seqs,
            pairs=pairs,
            out_bytes=bytes(out),
        )
