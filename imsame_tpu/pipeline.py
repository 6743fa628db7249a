"""Batched single-host engine: seed scan -> extension gate -> NW resolve.

Replaces the reference's per-thread sequential scan
(src/alignmentFunctions.c:43-208) with batched device stages while keeping
its acceptance semantics bit-exact:

  * Each query read has a totally ordered candidate stream: k-mer start
    positions in scan order (including the boundary-base quirk, SURVEY.md
    6.5) x bucket hits in descending database position (6.1).
  * The reference walks that stream sequentially, runs the gapped aligner
    on every e-value-passing hit, and the first *accepting* pair wins the
    read ("NWaligned", 6.8).  The winner only depends on the (query read,
    db read) pair -- the aligner sees full reads -- so acceptance can be
    evaluated out of order and the winner recovered as the first candidate
    whose pair accepts.  We therefore:
      1. gate each read's first few candidates on device (ops/candidates.py
         flat gate over packed rows, ops/extend_packed.py) -- most reads
         accept their first candidate, mirroring the reference's early
         exit -- then gate every remaining candidate of the unresolved
         tail in one flat pass (random reads have no passing candidate
         anywhere, so the reference walks their whole stream too);
      2. gapped-align every unique passing (read, db read) pair in one
         dispatch wave with the stats-only aligner (ops/resolve.py
         nw_stats_rows -- no backpointer tensor), then
      3. replay each read's candidate stream on the host: the first
         candidate whose pair accepted wins the read (_judge_and_replay).
         Traceback chains are produced at render time by re-running the
         bp kernel on accepted pairs only.

This yields identical accepted pairs and, with the shared renderer, a
byte-identical report to the reference binary at n_threads=1.

Row-coordinate bound reduction (used by the packed extension): the
reference clamps the extension walk with four checks -- array end, and the
per-read bounds rxs/rxe/rys/rye from _read_bounds_ext (last read's end
bound is total_len, src/alignmentFunctions.c:280-294).  Because reads are
concatenated contiguously, all four reduce in row coordinates to
``o <= read_len - 1 - offset`` (forward) and ``o <= offset - K - 1``
(backward) for *both* the last-read and interior cases, so the walk never
leaves the owning read and per-read packed rows are sufficient.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import native
from .config import Config
from .constants import FIXED_K, MAX_READ_SIZE
from .index.kmer import KmerIndex, build_index, rolling_keys
from .io.fasta import CODE_TO_CHAR, SeqInfo
from .io.reconstruct import backtrack_from_chain
from .io.report import format_record, render_alignment
from .ops.candidates import (
    encode_seg_chunk,
    flat_gate,
    flat_gate_packed,
    flat_gate_seg,
)
from .ops.enum_gate import (
    build_enum_tables,
    enum_gate_chunk,
    enum_select_prefix,
)
from .ops.extend import raw_score_threshold
from .ops.extend_packed import pack_stream, rows_from_stream
from .ops.resolve import nw_stats_rows, nw_traceback_rows
from .utils.timing import PhaseTimer

from jax.sharding import NamedSharding, PartitionSpec as _P


# The one-word formats (index payload sid << 12 | offset, candidate
# read id << 12 | offset) hold read ids below this; larger samples take
# the wide formats.
PACKED_MAX_READS = 1 << 20


@dataclasses.dataclass(slots=True)
class AcceptedRead:
    qread: int
    dbread: int
    length: int
    identities: int
    ylen: int
    # Traceback data: the accept path runs the stats-only aligner (no
    # backpointer tensor); the chain is produced by re-running the bp
    # kernel on accepted pairs only, at render time (render_report).
    n_steps: int = -1
    chain: Optional[np.ndarray] = None


@dataclasses.dataclass
class PipelineResult:
    accepted: int
    n_query: int
    n_db: int
    pairs: List[Tuple[int, int]]
    records: List[AcceptedRead]
    timings: Dict[str, float]
    nw_cells: int  # DP cells computed (for GCUPS accounting)
    n_candidates: int  # extension candidates evaluated
    # (records, pending) render-NW work dispatched inside compare (the
    # wave-1 winners overlap the wave-2/3 judging); consumed by
    # render_report -> _materialize_chains.
    early_render: Optional[tuple] = None

    @property
    def jaccard(self) -> float:
        return self.accepted / ((self.n_db + self.n_query) - self.accepted)


def _host_async(x) -> None:
    """Enqueue the D2H copy of a just-dispatched result NOW.

    Device ops and transfers run in dispatch order; a device_get issued
    later in host code would wait behind everything queued in between
    (later candidate uploads, later gate chunks).  copy_to_host_async()
    right after the dispatch puts the copy in order right behind the
    producing kernel, so the later device_get finds the bytes on host.
    Whether this pays on a local GPU is not measured yet."""
    x.copy_to_host_async()


def _pad_pow2_1d(
    a: np.ndarray, fill, min_size: int = 256, steps: Tuple[int, ...] = (2,)
) -> np.ndarray:
    """Pad a 1-D array to the next quantized length (>= min_size).

    Compiled kernel shapes are keyed on every table's length; quantizing
    lengths makes different queries / db samples of similar size reuse the
    same executables instead of recompiling.  Default grid: powers of two.
    For very large tables the caller passes steps=(2, 3) -- sizes {2^k,
    1.5*2^k} -- which halves the average padding (fewer bytes uploaded
    and held on device) at the cost of one extra compiled shape per
    octave."""
    n = len(a)
    p = min_size
    while True:
        for s in steps:
            q = p * s // 2 if s != 2 else p
            if q >= n:
                p = q
                break
        else:
            p *= 2
            continue
        break
    if p == n:
        return a
    out = np.full(p, fill, a.dtype)
    out[:n] = a
    return out


class _KeySet:
    """Sorted-array membership set for pair keys (read * n_db + sid).

    The judge path tests hundreds of thousands of candidate keys against
    the rejected-pair set per compare; a Python int set costs a per-key
    interpreter hop (~1 s at 100k-read scale), while a sorted array +
    searchsorted is one vectorized pass."""

    def __init__(self):
        self._arr = np.empty(0, np.int64)
        self._pend: List[np.ndarray] = []

    def add(self, keys: np.ndarray) -> None:
        if len(keys):
            self._pend.append(np.asarray(keys, np.int64))

    def _materialize(self) -> np.ndarray:
        if self._pend:
            self._arr = np.unique(
                np.concatenate([self._arr] + self._pend)
            )
            self._pend = []
        return self._arr

    def contains(self, keys: np.ndarray) -> np.ndarray:
        a = self._materialize()
        if not len(a) or not len(keys):
            return np.zeros(len(keys), bool)
        i = np.minimum(np.searchsorted(a, keys), len(a) - 1)
        return a[i] == keys


class TpuEngine:
    """Compare query samples against one database sample on device."""

    def __init__(
        self,
        db: SeqInfo,
        cfg: Optional[Config] = None,
        index: Optional[KmerIndex] = None,
    ):
        self.db = db
        self.cfg = cfg or Config()
        self.cfg.validate()
        self.timer = PhaseTimer()
        with self.timer.phase("index_build"):
            # A prebuilt index (load_index; orchestrator per-sample reuse,
            # SURVEY.md 5.4) skips the build; the reference rebuilds its
            # dictionary from FASTA every run (src/IMSAME.c:196-289).
            self.index: KmerIndex = index if index is not None else build_index(db)
        self.db_read_lens = db.read_lens()
        self._db_bucket = (
            self._nw_bucket(int(self.db_read_lens.max()))
            if db.n_seqs
            else self.cfg.length_buckets[0]
        )
        self._mesh = self._make_mesh()
        self._gate_steps: Dict[int, object] = {}
        self._gate_wide_steps: Dict[int, object] = {}
        self._gate_routed_steps: Dict[int, object] = {}
        self._nw_stats_steps: Dict[int, object] = {}
        self._nw_render_steps: Dict[int, object] = {}
        self._dp_cache: Dict[int, jax.Array] = {}
        # Engine-fixed device tables, pow2-padded for cross-sample shape
        # reuse (padding entries are masked or clipped on device).  With a
        # mesh, the index payload -- the large per-base array -- is
        # sharded by row range over 'dict'; everything else replicates.
        i32p = lambda a, fill=0: self._put(
            _pad_pow2_1d(np.asarray(a, np.int32), fill)
        )
        max_dlen = int(self.db_read_lens.max()) if db.n_seqs else 0
        # One-word index payload (sid << 12 | doff): halves the
        # engine-init H2D transfer and drops two gathers from the gate.
        self._packed_idx = db.n_seqs < PACKED_MAX_READS and max_dlen < 4096
        n_dict = self._mesh.shape["dict"] if self._mesh else 1
        if self._packed_idx:
            if self.index.packed is not None:
                words = self.index.packed.view(np.int32)
            else:
                sid = np.asarray(self.index.sid, np.int64)
                doff = np.asarray(self.index.pos, np.int64) - db.start[sid]
                words = ((sid.astype(np.uint32) << np.uint32(12))
                         | doff.astype(np.uint32)).view(np.int32)
            words = _pad_pow2_1d(words, 0, steps=(2, 3))
            self._shard_rows = len(words) // n_dict
            self._d_idx_tab = self._put_dict(words)
        else:
            idx_pos = _pad_pow2_1d(
                np.asarray(self.index.pos, np.int32), 0, steps=(2, 3)
            )
            idx_sid = _pad_pow2_1d(
                np.asarray(self.index.sid, np.int32), 0, steps=(2, 3)
            )
            self._shard_rows = len(idx_pos) // n_dict
            self._d_idx_tab = (
                self._put_dict(idx_pos),
                self._put_dict(idx_sid),
                i32p(db.start),
            )
        self._d_dlen = i32p(self.db_read_lens, 2)
        self._nw_cells = 0
        self._n_cands = 0
        # Device-side candidate enumeration (ops/enum_gate.py): resident
        # bucket prefix table; per-compare slot tables built in _compare.
        # Default OFF (see Config.gate_enum); the path is kept bit-equal
        # and tested.
        use_enum = self.cfg.gate_enum
        if use_enum is None:
            use_enum = False
        self._use_enum = (
            bool(use_enum) and self._mesh is None and self._packed_idx
        )
        self._d_bs = (
            jnp.asarray(np.ascontiguousarray(self.index.bucket_start, np.int32))
            if self._use_enum
            else None
        )
        # Device handles of the last compare()'s query-side tables; the
        # render path re-runs the bp kernel on accepted pairs from these.
        self._last_dev: Optional[Tuple] = None
        self.stage_stats: Dict[str, tuple] = {}

    # ------------------------------------------------------------------
    # Mesh plumbing (SURVEY.md 2a: data axis = the reference's pthread
    # split of query work, src/IMSAME.c:414-462; dict axis = sharded
    # Container payload, src/alignmentFunctions.h:4-6).
    def _make_mesh(self):
        ms = self.cfg.mesh_shape
        if ms is None:
            return None
        from .parallel.mesh import make_mesh

        if ms == "auto":
            nd = len(jax.local_devices())  # task-level distribution: each
            # process meshes over its own addressable devices (mesh.py)
            if nd <= 1:
                return None
            # Largest data-axis width every fixed batch shape divides
            # into evenly (gate chunks need n_data*32 candidates for the
            # per-shard bit packing; NW batches keep the inherited
            # n_data*8-pair granularity).
            d = nd
            while d > 1 and (
                any(c % (d * 32) for c in self.cfg.gate_chunks)
                or any(b % (d * 8) for b in self.cfg.nw_stats_batches)
                or any(b % (d * 8) for b in self.cfg.nw_render_batches)
            ):
                d //= 2
            if d <= 1:
                return None
            return make_mesh(n_data=d, n_dict=1)
        n_data, n_dict = ms
        if n_data * n_dict <= 1:
            return None
        if any(c % (n_data * n_dict * 32) for c in self.cfg.gate_chunks) or any(
            b % (n_data * n_dict * 8)
            for b in self.cfg.nw_stats_batches + self.cfg.nw_render_batches
        ):
            raise ValueError(
                "gate_chunks / NW batch shapes must divide evenly over the "
                "mesh (n_data*n_dict*32 and n_data*n_dict*8 respectively; "
                "the dict-routed gate slices chunks over both axes)"
            )
        return make_mesh(n_data=n_data, n_dict=n_dict)

    def _put(self, x) -> jax.Array:
        """Replicate across the mesh (or plain upload, single-device)."""
        if self._mesh is None:
            return jnp.asarray(x)
        return jax.device_put(x, NamedSharding(self._mesh, _P()))

    def _put_dict(self, x) -> jax.Array:
        """Shard the index payload by row range over 'dict'."""
        if self._mesh is None:
            return jnp.asarray(x)
        return jax.device_put(x, NamedSharding(self._mesh, _P("dict")))

    def _put_cand(self, x) -> jax.Array:
        """Shard a [2, N] candidate chunk over 'data'."""
        if self._mesh is None:
            return jnp.asarray(x)
        return jax.device_put(x, NamedSharding(self._mesh, _P(None, "data")))

    def _put_pair(self, x) -> jax.Array:
        """Shard a [2, B] NW pair batch over both axes flattened."""
        if self._mesh is None:
            return jnp.asarray(x)
        return jax.device_put(
            x, NamedSharding(self._mesh, _P(None, ("data", "dict")))
        )

    def _rows_on_device(
        self, codes: np.ndarray, start: np.ndarray, lens: np.ndarray,
        row_len: int,
    ) -> jax.Array:
        """Packed read rows built ON DEVICE from the 2-bit concatenated
        stream: the H2D payload is len/4 bytes per read instead of
        row_len/4 (row padding + pow2 row-count padding never cross the
        host-to-device copy).  Row count is pow2-padded for cross-sample
        shape reuse."""
        stream = _pad_pow2_1d(pack_stream(codes), 0)
        n_pad = len(_pad_pow2_1d(np.empty(max(len(start), 1), np.int32), 0))
        start_p = np.zeros(n_pad, np.int32)
        lens_p = np.zeros(n_pad, np.int32)
        start_p[: len(start)] = start
        lens_p[: len(start)] = lens
        return rows_from_stream(
            self._put(stream), self._put(start_p), self._put(lens_p),
            row_len=row_len,
        )

    def _packed_db_rows(self, row_len: int) -> jax.Array:
        if row_len not in self._dp_cache:
            self._dp_cache[row_len] = self._rows_on_device(
                self.db.codes, self.db.start, self.db_read_lens, row_len
            )
        return self._dp_cache[row_len]

    # ------------------------------------------------------------------
    def _stream_bounds(self, q: SeqInfo):
        """Per-read k-mer stream bounds (host, vectorized, cheap).

        Returns (qlo, qhi, n_kmers): concatenated-coordinate stream window
        per read, with the boundary-base quirk (SURVEY.md 6.5) and the
        n_threads split semantics (a thread's first read does not inherit
        the previous read's trailing base, reference worker init)."""
        n = q.n_seqs
        starts = q.start.astype(np.int64)
        total = q.total_len
        qlo = starts.copy()
        if n > 0:
            qlo[1:] = starts[1:] - 1
            n_threads = self.cfg.n_threads
            if n_threads > 1:
                rpt = n // n_threads
                tstarts = np.array(
                    [t * rpt for t in range(n_threads)], dtype=np.int64
                )
                tstarts = tstarts[tstarts < n]
                qlo[tstarts] = starts[tstarts]
        qhi = np.empty(n, np.int64)
        if n > 1:
            qhi[:-1] = starts[1:] - 2
        if n > 0:
            qhi[-1] = total - 1
        n_kmers = np.maximum(0, qhi - FIXED_K + 1 - qlo + 1)  # [n]
        return qlo, qhi, n_kmers

    def _kmer_stream(self, q: SeqInfo):
        """Per-read candidate stream tables (host, vectorized).

        Returns (kp, K_off, lo, cnt, Ccum, C_off):
          kp[i]    k-mer start position of global k-mer slot i (stream order)
          K_off[r] first k-mer slot of read r (K_off[n] = total slots)
          lo[i]    index bucket start for slot i
          cnt[i]   bucket size for slot i
          Ccum[i]  exclusive cumsum of cnt (global candidate offsets)
          C_off[r] first global candidate rank boundary per read
        """
        n = q.n_seqs
        starts = q.start.astype(np.int64)
        qlo, qhi, n_kmers = self._stream_bounds(q)
        K_off = np.zeros(n + 1, np.int64)
        K_off[1:] = n_kmers.cumsum()
        total_kmers = int(K_off[-1])

        # Native fused pass: rolling key + bucket lookup + prefix sum in one
        # linear scan (native/host.c imsame_kmer_stream).
        arrs = native.kmer_stream_arrays(
            q.codes, qlo, n_kmers, FIXED_K, self.index.bucket_start
        )
        if arrs is not None:
            kp, lo, cnt, Ccum = arrs
            C_off = Ccum[K_off]
            return kp, K_off, lo, cnt, Ccum, C_off

        # numpy fallback: k-mer start positions via vectorized repeat.
        kp = (
            np.repeat(qlo, n_kmers)
            + np.arange(total_kmers, dtype=np.int64)
            - np.repeat(K_off[:-1], n_kmers)
        )

        # keys + bucket ranges in one vectorized pass
        all_keys = rolling_keys(q.codes)  # key at every concat position
        keys = all_keys[kp] if total_kmers else np.empty(0, np.uint32)
        lo, hi = self.index.lookup_ranges(keys)
        cnt = (hi - lo).astype(np.int64)
        Ccum = np.zeros(total_kmers + 1, np.int64)
        np.cumsum(cnt, out=Ccum[1:])
        C_off = Ccum[K_off]
        return kp, K_off, lo, cnt, Ccum, C_off

    # ------------------------------------------------------------------
    def _nw_bucket(self, L: int):
        for b in self.cfg.length_buckets:
            if L <= b:
                return b
        raise ValueError("Read size reached for gapped alignment.")

    def _render_sizes(self, L: int) -> tuple:
        """Render ladder for length bucket L: the configured ladder capped
        so one chunk's bp tensor (8*L^2 bytes/pair) fits the budget *per
        device* (the pair batch shards over every mesh device).  At the
        3072 bucket even the smallest configured size (256 pairs) would be
        ~19 GB on one device, so large-L ladders collapse to (cap, gran)
        with gran 8 pairs times the mesh size."""
        n_dev = 1 if self._mesh is None else int(self._mesh.devices.size)
        gran = 8 * n_dev
        cap = int(self.cfg.nw_render_bp_budget * n_dev // (8 * L * L))
        cap = max(gran, (cap // gran) * gran)
        sizes = tuple(b for b in self.cfg.nw_render_batches if b <= cap)
        if not sizes:
            sizes = (cap,) if cap == gran else (cap, gran)
        return sizes

    def _nw_chunks(
        self, r_ids: np.ndarray, sids: np.ndarray, qlens: np.ndarray,
        sizes: tuple = None,
        render: bool = False,
        count_cells: bool = True,
    ):
        """Split pairs into fixed-shape padded chunks bucketed by length.

        Yields (chunk_indices, rpad, spad, L).  ``sizes`` is the descending
        ladder of allowed batch shapes: each distinct shape is one XLA
        compile and each chunk one dispatch, so chunks pad up to the
        smallest ladder size that covers the remainder (the stats ladder
        tops out much higher than the render ladder, whose bp tensor
        costs 8*L^2 bytes/pair of device memory).
        With ``render=True`` the ladder is re-derived per length bucket
        (see _render_sizes)."""
        P = len(r_ids)
        xls = self.db_read_lens[sids]
        yls = qlens[r_ids]
        if P and (int(xls.max()) > MAX_READ_SIZE or int(yls.max()) > MAX_READ_SIZE):
            raise ValueError("Read size reached for gapped alignment.")
        if count_cells:  # render re-runs aren't compare GCUPS; skipping
            # the tally (instead of save/restore) keeps this re-entrant
            # for the orchestrator's deferred-render worker thread
            self._nw_cells += int(np.sum(xls.astype(np.int64) * yls))
        maxl = np.maximum(xls, yls)
        buckets = np.array([self._nw_bucket(int(m)) for m in maxl], np.int64) \
            if P else np.empty(0, np.int64)
        for L in np.unique(buckets):
            idxs = np.flatnonzero(buckets == L)
            lsizes = self._render_sizes(int(L)) if render else sizes
            pos = 0
            while pos < len(idxs):
                rem = len(idxs) - pos
                B = lsizes[0]
                for z in lsizes[1:]:
                    if z >= rem:
                        B = z
                chunk = idxs[pos : pos + min(rem, B)]
                pos += len(chunk)
                rpad = np.zeros(B, np.int32)
                spad = np.zeros(B, np.int32)
                rpad[: len(chunk)] = r_ids[chunk]
                spad[: len(chunk)] = sids[chunk]
                yield chunk, rpad, spad, int(L)

    def _nw_dispatch_pairs(
        self,
        r_ids: np.ndarray,  # [P] query read ids
        sids: np.ndarray,  # [P] db read ids
        qlens: np.ndarray,  # per-read query lengths (host)
        d_qp: jax.Array,
        d_dp: jax.Array,
        d_qlen: jax.Array,
        d_dlen: jax.Array,
    ):
        """Dispatch the stats-only aligner over pairs (no backpointer
        tensor) without fetching -- device work queues asynchronously, so
        the caller can overlap further host/gate work before waiting in
        _nw_fetch_pairs."""
        pending = []
        t0 = time.perf_counter()
        for chunk, rpad, spad, L in self._nw_chunks(
            r_ids, sids, qlens, self.cfg.nw_stats_batches
        ):
            res = self._nw_stats_dispatch(
                d_qp, d_dp, np.stack([rpad, spad]), d_qlen, d_dlen, L
            )
            _host_async(res)
            pending.append((chunk, res))
        # sub-span of resolve.nw: host chunking + async dispatch calls
        self.timer.accumulate("nw.dispatch", time.perf_counter() - t0)
        return len(r_ids), pending

    def _nw_fetch_pairs(self, P: int, pending, label: str = "nw.fetch") -> np.ndarray:
        """Fetch dispatched stats; one synchronization for every chunk
        (stats come back as one stacked [3, B] array per chunk).  Returns
        a [P, 3]
        int64 array of (length, identities, ylen) per pair -- the
        accept-gate inputs -- assembled vectorized (a Python tuple per
        pair cost ~0.5 s at 100k-read scale)."""
        t0 = time.perf_counter()
        flat = jax.device_get([res for _, res in pending])
        self.timer.accumulate(label, time.perf_counter() - t0)
        t1 = time.perf_counter()
        out = np.empty((P, 3), np.int64)
        for (chunk, _res), stats in zip(pending, flat):
            out[chunk] = stats[:, : len(chunk)].T
        self.timer.accumulate("nw.scatter", time.perf_counter() - t1)
        return out

    # ------------------------------------------------------------------
    def _gate(
        self, rids32, hits, qoffs, thr, d_thr, d_qp, d_qlen, window,
        small_first=True,
    ) -> np.ndarray:
        """Gate a flat candidate list on device; returns bool[len(hits)].

        Per-candidate device traffic is two words: the index hit row, and
        the read id packed with the k-mer end offset (flat_gate_packed;
        the wide 4-word format remains for >=2^20-read queries).  Two
        tiers: a small window first (random candidates' walks provably
        terminate inside it, flagged exact), then the full window only for
        the rare escapees."""
        N = len(hits)
        out = np.zeros(N, bool)
        if N == 0:
            return out
        packed = len(thr) < PACKED_MAX_READS
        if packed:
            rq = (rids32.astype(np.uint32) << np.uint32(12)) | qoffs.astype(
                np.uint32
            )
            a, b, c = hits, rq, d_thr
        else:
            a, b, c = hits, rids32, qoffs  # wide path reorders below

        w_small = self.cfg.gate_window_small if small_first else 0
        if w_small and w_small < window:
            p1, e1 = self._gate_chunks(
                packed, a, b, c, thr, d_qp, d_qlen, w_small
            )
            out[:] = p1
            esc = np.flatnonzero(~e1)
            if len(esc):
                p2, _ = self._gate_chunks(
                    packed, a[esc], b[esc], c if packed else c[esc],
                    thr, d_qp, d_qlen, window,
                )
                out[esc] = p2
        else:
            out[:], _ = self._gate_chunks(
                packed, a, b, c, thr, d_qp, d_qlen, window
            )
        return out

    def _gate_chunks(self, packed, hits, b, c, thr, d_qp, d_qlen, window):
        """Dispatch fixed-shape gate chunks; one fetch for all results.
        Returns (passes, exact) bool arrays.

        packed=True: b = rq uint32 array, c = device threshold table.
        packed=False: b = rids int32, c = qoffs int32 (thresholds gathered
        on host from thr)."""
        if (
            packed
            and self._mesh is not None
            and self._mesh.shape["dict"] > 1
            # escape hatch for A/B measurement of routed vs broadcast
            # -- the broadcast step replicates extension compute
            # n_dict-fold
            and not os.environ.get("IMSAME_GATE_BROADCAST")
        ):
            return self._gate_chunks_routed(hits, b, c, d_qp, d_qlen, window)
        pending = self._gate_chunks_dispatch(
            packed, hits, b, c, thr, d_qp, d_qlen, window
        )
        return self._gate_chunks_fetch(pending, len(hits))

    def _gate_chunks_dispatch(
        self, packed, hits, b, c, thr, d_qp, d_qlen, window
    ):
        """Dispatch half of _gate_chunks: queues the chunk kernels and
        returns the pending list WITHOUT blocking, so callers can overlap
        the gate's device time (and its fetch) with other device waves --
        _gate_chunks_fetch collects the bits later."""
        N = len(hits)
        sizes = sorted(self.cfg.gate_chunks, reverse=True)
        pending = []
        # gate.dispatch / gate.fetch are sub-spans of resolve.extend (the
        # same wall time appears under both keys in the reported timings).
        t_disp0 = time.perf_counter()
        pos = 0
        while pos < N:
            rem = N - pos
            # Cheapest covering plan: the smallest size whose repetition
            # count doesn't exceed a single larger chunk's padded slots.
            size = sizes[0]
            for z in sizes[1:]:
                if -(-rem // z) * z <= size:
                    size = z
            take = min(rem, size)
            sl = slice(pos, pos + take)
            if packed:
                bits = None
                if (
                    self._mesh is None
                    and self._packed_idx
                    and self._d_idx_tab.shape[0] <= (1 << 25)
                    and not os.environ.get("IMSAME_GATE_NOSEG")
                ):
                    # Segment-encoded chunk: 4 B/candidate + ~8 B/segment
                    # instead of 8 B/candidate of host-to-device copy
                    # (ops/candidates.py flat_gate_seg).  Native one-pass
                    # encoder; numpy fallback is bit-identical.
                    rq_sl = b[sl]
                    rids_c = (rq_sl >> np.uint32(12)).astype(np.int32)
                    qoffs_c = (rq_sl & np.uint32(0xFFF)).astype(np.int32)
                    enc = None
                    if native.lib is not None:
                        # one O(n) pass at the larger capacity; if the
                        # segment count also fits the small fixed shape,
                        # slice down (each (size, cap) pair is its own
                        # compiled gate shape)
                        nat = native.seg_encode(
                            rids_c, qoffs_c, hits[sl], size, size // 8
                        )
                        if nat is not None:
                            cand1, rt, rb, nseg = nat
                            small = size // 128
                            if nseg <= small:
                                rt, rb = rt[:small], rb[:small]
                            enc = (cand1, rt, rb)
                    if enc is None and native.lib is None:
                        cand1, rtab, rbase = encode_seg_chunk(
                            rids_c, qoffs_c, hits[sl], size
                        )
                        for cap in (size // 128, size // 8):
                            if len(rtab) <= cap:
                                rt = np.zeros(cap, np.int32)
                                rb = np.zeros(cap, np.int32)
                                rt[: len(rtab)] = rtab
                                rb[: len(rtab)] = rbase
                                enc = (cand1, rt, rb)
                                break
                    if enc is not None:
                        bits = flat_gate_seg(
                            d_qp,
                            self._dp_cache[self._row_len],
                            d_qlen,
                            self._d_dlen,
                            self._d_idx_tab,
                            jnp.asarray(enc[0]),
                            jnp.asarray(enc[1]),
                            jnp.asarray(enc[2]),
                            c,
                            window=window,
                            packed_idx=True,
                        )
                if bits is None:
                    cand = np.zeros((2, size), np.int32)
                    cand[0, :take] = hits[sl]
                    cand[1, :take] = b[sl].view(np.int32)
                    bits = self._gate_dispatch(
                        d_qp,
                        self._dp_cache[self._row_len],
                        d_qlen,
                        self._d_dlen,
                        self._put_cand(cand),
                        c,
                        window,
                    )
            else:
                if self._mesh is not None:
                    cand = np.zeros((5, size), np.int32)
                    cand[0, :take] = hits[sl]
                    cand[1, :take] = b[sl]
                    cand[2, :take] = c[sl]
                    cand[3, :take] = thr[b[sl]]
                    cand[4, :take] = 1
                    bits = self._gate_dispatch_wide(
                        d_qp, self._dp_cache[self._row_len], d_qlen,
                        self._d_dlen, self._put_cand(cand), window,
                    )
                else:
                    hpad = np.zeros(size, np.int32)
                    rpad = np.zeros(size, np.int32)
                    qpad = np.zeros(size, np.int32)
                    tpad = np.full(size, np.iinfo(np.int32).max, np.int32)
                    hpad[:take] = hits[sl]
                    rpad[:take] = b[sl]
                    qpad[:take] = c[sl]
                    tpad[:take] = thr[b[sl]]
                    bits = flat_gate(
                        d_qp,
                        self._dp_cache[self._row_len],
                        d_qlen,
                        self._d_dlen,
                        self._d_idx_tab,
                        jnp.asarray(rpad),
                        jnp.asarray(hpad),
                        jnp.asarray(qpad),
                        jnp.asarray(tpad),
                        jnp.asarray(np.int32(take)),
                        window=window,
                        packed_idx=self._packed_idx,
                    )
            _host_async(bits)
            pending.append((pos, take, size, bits))
            pos += take
        self.timer.accumulate("gate.dispatch", time.perf_counter() - t_disp0)
        return pending

    def _gate_chunks_fetch(self, pending, N):
        """Fetch half of _gate_chunks; blocks on the queued chunk kernels
        and unpacks the verdict bits."""
        passes = np.zeros(N, bool)
        exact = np.zeros(N, bool)
        t_f0 = time.perf_counter()
        fetched = jax.device_get([bits for _, _, _, bits in pending])
        self.timer.accumulate("gate.fetch", time.perf_counter() - t_f0)
        for (pos, take, size, _), pb in zip(pending, fetched):
            pb = np.ascontiguousarray(pb, dtype="<u4")
            flat = np.unpackbits(
                pb.view(np.uint8).reshape(2, -1), axis=1, bitorder="little"
            )[:, :size].astype(bool)
            passes[pos : pos + take] = flat[0, :take]
            exact[pos : pos + take] = flat[1, :take]
        return passes, exact

    def _gate_dispatch(self, d_qp, d_dp, d_qlen, d_dlen, cand, thr_tab, window):
        """Single-device flat gate or the mesh-sharded twin."""
        if self._mesh is None:
            return flat_gate_packed(
                d_qp, d_dp, d_qlen, d_dlen, self._d_idx_tab,
                cand, thr_tab, window=window, packed_idx=self._packed_idx,
            )
        step = self._gate_steps.get(window)
        if step is None:
            from .parallel.sharded import make_engine_gate_step

            step = make_engine_gate_step(
                self._mesh, window, self._shard_rows, self._packed_idx
            )
            self._gate_steps[window] = step
        return step(
            d_qp, d_dp, d_qlen, d_dlen, self._d_idx_tab, cand, thr_tab
        )

    def _gate_dispatch_wide(self, d_qp, d_dp, d_qlen, d_dlen, cand, window):
        """Mesh dispatch for the wide candidate format (>= 2^20-read
        queries): [5, N] stack of (hit, rid, qoff, thr, valid)."""
        step = self._gate_wide_steps.get(window)
        if step is None:
            from .parallel.sharded import make_engine_gate_step_wide

            step = make_engine_gate_step_wide(
                self._mesh, window, self._shard_rows, self._packed_idx
            )
            self._gate_wide_steps[window] = step
        return step(d_qp, d_dp, d_qlen, d_dlen, self._d_idx_tab, cand)

    def _gate_chunks_routed(self, hits, rq, thr_tab, d_qp, d_qlen, window):
        """Dict-routed gate planner (mesh with n_dict > 1, packed query
        format): candidates are grouped by owning index shard
        (hit // shard_rows) and laid out so flat segment s = d*n_dict + k
        holds only shard k's candidates; the routed step then shards the
        chunk over the flattened ('data','dict') axes and every device
        gates exclusively candidates it owns -- extension compute scales
        with n_dict instead of replicating (parallel/sharded.py
        make_engine_gate_step_routed).  Bits are un-permuted on fetch.

        Chunk slots per shard are fixed (C // n_dict), so shard skew
        costs padding, not correctness; k-mer keys spread uniformly over
        the row ranges for metagenomic reads, keeping skew small."""
        mesh = self._mesh
        n_data = mesh.shape["data"]
        n_dict = mesh.shape["dict"]
        N = len(hits)
        d_dp = self._dp_cache[self._row_len]
        shard = hits // np.int32(self._shard_rows)
        order = np.argsort(shard, kind="stable")
        counts = np.bincount(shard, minlength=n_dict).astype(np.int64)
        shard_off = np.zeros(n_dict + 1, np.int64)
        np.cumsum(counts, out=shard_off[1:])
        sizes = sorted(self.cfg.gate_chunks, reverse=True)
        qpos = np.zeros(n_dict, np.int64)
        pending = []
        t_disp0 = time.perf_counter()
        while True:
            rem = counts - qpos
            rem_max = int(rem.max()) if n_dict else 0
            if rem_max == 0:
                break
            C = sizes[0]
            for z in sizes[1:]:
                if z // n_dict >= rem_max:
                    C = z
            S = C // n_dict  # slots per shard in this chunk
            seg = C // (n_data * n_dict)  # slots per flat segment
            cand = np.zeros((2, C), np.int32)
            perm = np.full(C, -1, np.int64)
            for k in range(n_dict):
                take = int(min(S, rem[k]))
                if take == 0:
                    continue
                idxs = order[
                    shard_off[k] + qpos[k] : shard_off[k] + qpos[k] + take
                ]
                j = np.arange(take, dtype=np.int64)
                posn = (j // seg * n_dict + k) * seg + (j % seg)
                cand[0, posn] = hits[idxs]
                cand[1, posn] = rq[idxs].view(np.int32)
                perm[posn] = idxs
                qpos[k] += take
            pad = np.flatnonzero(perm < 0)
            if len(pad):  # padding rows must stay in the owning shard's
                # row range (local hit 0 after the on-device rebase)
                cand[0, pad] = (
                    (pad // seg) % n_dict
                ).astype(np.int32) * np.int32(self._shard_rows)
            step = self._gate_routed_steps.get(window)
            if step is None:
                from .parallel.sharded import make_engine_gate_step_routed

                step = make_engine_gate_step_routed(
                    mesh, window, self._shard_rows, self._packed_idx
                )
                self._gate_routed_steps[window] = step
            bits = step(
                d_qp, d_dp, d_qlen, self._d_dlen, self._d_idx_tab,
                self._put_cand_routed(cand), thr_tab,
            )
            _host_async(bits)
            pending.append((perm, C, bits))
        self.timer.accumulate("gate.dispatch", time.perf_counter() - t_disp0)
        passes = np.zeros(N, bool)
        exact = np.zeros(N, bool)
        t_f0 = time.perf_counter()
        fetched = jax.device_get([bits for _, _, bits in pending])
        self.timer.accumulate("gate.fetch", time.perf_counter() - t_f0)
        for (perm, C, _), pb in zip(pending, fetched):
            pb = np.ascontiguousarray(pb, dtype="<u4")
            flat = np.unpackbits(
                pb.view(np.uint8).reshape(2, -1), axis=1, bitorder="little"
            )[:, :C].astype(bool)
            valid = perm >= 0
            passes[perm[valid]] = flat[0, valid]
            exact[perm[valid]] = flat[1, valid]
        return passes, exact

    def _put_cand_routed(self, x) -> jax.Array:
        """Shard a [2, C] routed chunk over the flattened axes."""
        return jax.device_put(
            x, NamedSharding(self._mesh, _P(None, ("data", "dict")))
        )

    # ------------------------------------------------------------------
    # Device-side candidate enumeration (ops/enum_gate.py): the gate
    # consumes rank windows instead of host-built candidate arrays, so
    # per-candidate host-to-device traffic disappears.  Host keeps its own
    # stream tables solely to map the ~sparse PASSING bits back to (read,
    # db read) pairs.
    def _enum_prepare(self, q: SeqInfo, d_qp, d_qlen, qlo, n_kmers):
        """Upload per-read scalars and dispatch the slot-table build
        (async; overlaps the host k-mer scan)."""
        R = d_qp.shape[0]
        n = q.n_seqs
        hasb = np.zeros(R, np.int32)
        hasb[:n] = (qlo != q.start.astype(np.int64)).astype(np.int32)
        nk = np.zeros(R, np.int32)
        nk[:n] = np.minimum(n_kmers, np.iinfo(np.int32).max)
        d_hasb = jnp.asarray(hasb)
        lo_g, cnt_g, Rcum, _tot = build_enum_tables(
            d_qp, self._d_bs, d_hasb, jnp.asarray(nk), d_qlen[:R],
            row_len=self._row_len,
        )
        self._enum_state = (lo_g, cnt_g, Rcum, d_hasb, hasb[:n])

    def _enum_gate_stage(
        self, frm_np, to_np, N, window, d_qp, d_dp, d_qlen, d_dlen, d_thr
    ):
        """Gate the rank-window selection [frm, to) per read (device
        enumeration); returns (passes, exact) bool[N] in stream order."""
        lo_g, cnt_g, Rcum, d_hasb, _ = self._enum_state
        R = lo_g.shape[0]
        frm_p = np.zeros(R, np.int32)
        to_p = np.zeros(R, np.int32)
        frm_p[: len(frm_np)] = frm_np
        to_p[: len(to_np)] = to_np
        scum, start_off = enum_select_prefix(
            cnt_g, Rcum, jnp.asarray(frm_p), jnp.asarray(to_p)
        )
        sizes = sorted(self.cfg.gate_chunks, reverse=True)
        pending = []
        pos = 0
        t_disp0 = time.perf_counter()
        while pos < N:
            rem = N - pos
            size = sizes[0]
            for z in sizes[1:]:
                if -(-rem // z) * z <= size:
                    size = z
            take = min(rem, size)
            bits = enum_gate_chunk(
                d_qp, d_dp, d_qlen, d_dlen, self._d_idx_tab, d_thr,
                lo_g, scum, start_off, d_hasb, np.int32(pos),
                chunk=size, window=window, packed_idx=True,
                row_len=self._row_len,
            )
            _host_async(bits)
            pending.append((pos, take, size, bits))
            pos += take
        self.timer.accumulate("gate.dispatch", time.perf_counter() - t_disp0)
        passes = np.zeros(N, bool)
        exact = np.zeros(N, bool)
        t_f0 = time.perf_counter()
        fetched = jax.device_get([bits for _, _, _, bits in pending])
        self.timer.accumulate("gate.fetch", time.perf_counter() - t_f0)
        for (pos, take, size, _), pb in zip(pending, fetched):
            pb = np.ascontiguousarray(pb, dtype="<u4")
            flat = np.unpackbits(
                pb.view(np.uint8).reshape(2, -1), axis=1, bitorder="little"
            )[:, :size].astype(bool)
            passes[pos : pos + take] = flat[0, :take]
            exact[pos : pos + take] = flat[1, :take]
        return passes, exact

    def _nw_stats_dispatch(self, d_qp, d_dp, rs, d_qlen, d_dlen, L):
        if self._mesh is None:
            return nw_stats_rows(
                d_qp, d_dp, jnp.asarray(rs), d_qlen, d_dlen,
                self.cfg.igap, self.cfg.egap, max_len=L,
            )
        step = self._nw_stats_steps.get(L)
        if step is None:
            from .parallel.sharded import make_engine_nw_stats_step

            step = make_engine_nw_stats_step(self._mesh, L)
            self._nw_stats_steps[L] = step
        return step(
            d_qp, d_dp, self._put_pair(rs), d_qlen, d_dlen,
            self.cfg.igap, self.cfg.egap,
        )

    def _nw_render_dispatch(self, d_qp, d_dp, rs, d_qlen, d_dlen, L):
        if self._mesh is None:
            return nw_traceback_rows(
                d_qp, d_dp, jnp.asarray(rs[0]), jnp.asarray(rs[1]),
                d_qlen, d_dlen, self.cfg.igap, self.cfg.egap, max_len=L,
            )
        step = self._nw_render_steps.get(L)
        if step is None:
            from .parallel.sharded import make_engine_nw_render_step

            step = make_engine_nw_render_step(self._mesh, L)
            self._nw_render_steps[L] = step
        return step(
            d_qp, d_dp, self._put_pair(rs), d_qlen, d_dlen,
            self.cfg.igap, self.cfg.egap,
        )

    def _dedup_pairs(self, pass_r, pass_sid, rejected_keys, extra=None):
        """Unique (read, db read) pairs in stream order of first
        occurrence -- excluding already-rejected pairs and the optional
        ``extra`` key array (pairs another in-flight wave already covers)
        -- plus the per-candidate pair-key array."""
        n_db = max(self.db.n_seqs, 1)
        key = pass_r.astype(np.int64) * n_db + pass_sid
        _, first_idx = np.unique(key, return_index=True)
        first_idx.sort()
        ck = key[first_idx]
        if len(ck):
            stale = rejected_keys.contains(ck)
            if extra is not None and len(extra):
                stale |= np.isin(ck, extra)
            fresh = ~stale
            first_idx, ck = first_idx[fresh], ck[fresh]
        return (
            pass_r[first_idx].astype(np.int64),
            pass_sid[first_idx].astype(np.int64),
            ck,
            key,
        )

    def _judge_and_replay(
        self, results, ck, pass_r, pass_sid, key,
        rejected_keys, resolved, accepted_records, cfg,
    ) -> None:
        """Apply the coverage/identity accept gates (reference
        src/alignmentFunctions.c:163) to per-pair NW stats, then replay the
        candidate stream: the first candidate whose pair accepts wins its
        read (NWaligned semantics, src/alignmentFunctions.c:172,189-190;
        the verdict depends only on the two full reads, so all verdicts
        can be computed up front and the sequential walk replayed for
        free)."""
        stats = np.asarray(results, np.int64).reshape(-1, 3)  # [K, 3]
        length, idents, ylen = stats[:, 0], stats[:, 1], stats[:, 2]
        ok = (length >= cfg.min_coverage * ylen) & (
            idents >= cfg.min_identity * length
        )
        rejected_keys.add(ck[~ok])
        acc_rows = np.flatnonzero(ok)
        if not len(acc_rows):
            return
        order = acc_rows[np.argsort(ck[acc_rows], kind="stable")]
        acc_sorted = ck[order]
        # First candidate (stream order) whose pair accepted wins its read.
        # Invariant: each read's candidates appear in stream order within
        # the flat arrays (reads from different gate segments may
        # interleave in id space, so pass_r is NOT globally monotonic);
        # np.unique(return_index) picks the first array occurrence per
        # read, which is that read's earliest surviving candidate.
        p = np.searchsorted(acc_sorted, key)
        pc = np.minimum(p, len(acc_sorted) - 1)
        hit = acc_sorted[pc] == key
        live = np.flatnonzero(hit & ~resolved[pass_r])
        if len(live):
            _, first = np.unique(pass_r[live], return_index=True)
            win = live[first]
            krow = order[pc[win]]  # stats row of the winning pair
            resolved[pass_r[win]] = True
            for i, k in zip(win, krow):
                accepted_records.append(
                    AcceptedRead(
                        int(pass_r[i]), int(pass_sid[i]),
                        int(length[k]), int(idents[k]), int(ylen[k]),
                    )
                )

    # ------------------------------------------------------------------
    def compare(self, q: SeqInfo) -> PipelineResult:
        if self.cfg.profile_dir:
            with jax.profiler.trace(self.cfg.profile_dir):
                return self._compare(q)
        return self._compare(q)

    def _compare(self, q: SeqInfo) -> PipelineResult:
        cfg = self.cfg
        db = self.db
        idx = self.index
        self._nw_cells = 0
        self._n_cands = 0

        n = q.n_seqs
        qlens = q.read_lens() if n else np.empty(0, np.int64)
        thr = raw_score_threshold(qlens, db.total_len, cfg.min_e_value)

        # shared packed-row length: one bucket covering both samples
        max_rl = 1
        if n:
            max_rl = max(max_rl, int(qlens.max()))
        if db.n_seqs:
            max_rl = max(max_rl, int(self.db_read_lens.max()))
        window = self._nw_bucket(max_rl)
        self._row_len = window

        # Dispatch the device uploads FIRST (device_put / row unpacking are
        # async), so H2D and the row build overlap the host k-mer scan
        # below instead of serializing after it.
        d_qp = d_dp = d_qlen = d_thr = d_dlen = None
        if n and db.n_seqs:
            with self.timer.phase("upload"):
                d_qp = self._rows_on_device(q.codes, q.start, qlens, window)
                d_dp = self._packed_db_rows(window)
                d_qlen = self._put(
                    _pad_pow2_1d(np.asarray(qlens, np.int32), 2)
                )
                d_thr = self._put(
                    _pad_pow2_1d(
                        np.asarray(thr, np.int32), np.iinfo(np.int32).max
                    )
                )
                d_dlen = self._d_dlen
                self._last_dev = (d_qp, d_dp, d_qlen, d_dlen)

        # Enumeration-gate prep: dispatch the device slot-table build
        # BEFORE the host k-mer scan so the two overlap (the table build
        # needs only the packed rows + per-read bounds, both cheap).
        use_enum = (
            self._use_enum
            and d_qp is not None
            and d_qp.shape[0] <= self.cfg.gate_enum_max_rows
        )
        if use_enum:
            qlo_e, _, n_kmers_e = self._stream_bounds(q)
            self._enum_prepare(q, d_qp, d_qlen, qlo_e, n_kmers_e)

        with self.timer.phase("kmer_stream"):
            kp, K_off, lo, cnt, Ccum, C_off = self._kmer_stream(q)
        N_r = (C_off[1:] - C_off[:-1]) if n else np.empty(0, np.int64)
        if use_enum and n and int(Ccum[-1]) >= 2**31:
            # The device enumeration ranks candidates with an int32 cumsum
            # (ops/enum_gate.py enum_select_prefix); a compare whose total
            # candidate count overflows int32 must take the host gate.
            use_enum = False

        resolved = np.zeros(n, bool)
        rejected_keys = _KeySet()
        accepted_records: List[AcceptedRead] = []
        early = None  # render overlap (set in the resolve block)
        # Per-stage counters (bench's large block surfaces them): candidate
        # counts, gate-pass counts and NW pair counts per stage.
        ss = self.stage_stats = {}

        if idx.n_entries and n and Ccum[-1]:
            q_start = q.start.astype(np.int64)

            def build_flat(read_ids, from_rank, to_rank):
                """Flat (rids, hits, qoffs) int32 arrays for candidate
                ranks [from, to) per read, read-major, stream order.
                hits are index rows (sid/pos are direct gathers); qoffs
                are k-mer end offsets in read-row coordinates."""
                out_size = int(
                    np.maximum(
                        0, np.minimum(to_rank, N_r[read_ids]) - from_rank
                    ).sum()
                )
                arrs = native.build_flat_arrays(
                    read_ids, from_rank, to_rank, K_off, C_off,
                    kp, lo, cnt, Ccum, q_start, FIXED_K, out_size,
                )
                if arrs is not None:
                    return arrs
                # numpy fallback: expand each read's slot list by its
                # bucket counts and trim the rank window, all vectorized.
                slot_lens = (K_off[read_ids + 1] - K_off[read_ids]).astype(
                    np.int64
                )
                tot_slots = int(slot_lens.sum())
                pre = np.concatenate(([0], np.cumsum(slot_lens)[:-1]))
                slots = (
                    np.repeat(K_off[read_ids], slot_lens)
                    + np.arange(tot_slots, dtype=np.int64)
                    - np.repeat(pre, slot_lens)
                )
                ts_full = np.repeat(slots, cnt[slots])
                seg_lens = N_r[read_ids]
                total_full = int(seg_lens.sum())
                seg_pre = np.concatenate(([0], np.cumsum(seg_lens)[:-1]))
                pos = np.arange(total_full, dtype=np.int64) - np.repeat(
                    seg_pre, seg_lens
                )
                keep = (pos >= np.repeat(from_rank, seg_lens)) & (
                    pos < np.repeat(to_rank, seg_lens)
                )
                gcs = (np.repeat(C_off[read_ids], seg_lens) + pos)[keep]
                rids = np.repeat(read_ids, seg_lens)[keep]
                ts = ts_full[keep]
                hits = (lo[ts] + gcs - Ccum[ts]).astype(np.int32)
                qoffs = (kp[ts] + FIXED_K - q_start[rids]).astype(np.int32)
                return rids.astype(np.int32), hits, qoffs

            def map_selected(sel_idx, frm, to):
                """Map stage-selection ranks to (read, hit, qoff) with the
                host stream tables -- the exact inverse of the device
                enumeration's addressing (ops/enum_gate.py)."""
                lo_r = np.minimum(frm, N_r)
                hi_r = np.minimum(to, N_r)
                sel_r = np.maximum(hi_r - lo_r, 0)
                selcum = np.zeros(n + 1, np.int64)
                np.cumsum(sel_r, out=selcum[1:])
                r = np.searchsorted(selcum, sel_idx, side="right") - 1
                rank = lo_r[r] + (sel_idx - selcum[r])
                gc = C_off[r] + rank
                slot = np.searchsorted(Ccum, gc, side="right") - 1
                hits = (lo[slot] + (gc - Ccum[slot])).astype(np.int32)
                qoffs = (kp[slot] + FIXED_K - q_start[r]).astype(np.int32)
                return r.astype(np.int32), hits, qoffs

            def run_gate_enum(read_ids, from_rank, to_rank, small_first):
                """Device-enumerated twin of run_gate: ships rank windows
                (O(n_reads) words) instead of candidate arrays."""
                frm = np.zeros(n, np.int64)
                to = np.zeros(n, np.int64)
                frm[read_ids] = from_rank
                to[read_ids] = to_rank
                N = int(
                    np.maximum(
                        np.minimum(to, N_r) - np.minimum(frm, N_r), 0
                    ).sum()
                )
                self._n_cands += N
                if N == 0:
                    return np.empty(0, np.int32), np.empty(0, np.int64)
                w_small = self.cfg.gate_window_small if small_first else 0
                with self.timer.phase("resolve.extend"):
                    if w_small and w_small < window:
                        passes, exact = self._enum_gate_stage(
                            frm, to, N, w_small,
                            d_qp, d_dp, d_qlen, d_dlen, d_thr,
                        )
                        esc = np.flatnonzero(~exact)
                        if len(esc):
                            er, eh, eq = map_selected(esc, frm, to)
                            rq = (
                                er.astype(np.uint32) << np.uint32(12)
                            ) | eq.astype(np.uint32)
                            p2, _ = self._gate_chunks(
                                True, eh, rq, d_thr, thr, d_qp, d_qlen,
                                window,
                            )
                            passes[esc] = p2
                    else:
                        passes, _ = self._enum_gate_stage(
                            frm, to, N, window,
                            d_qp, d_dp, d_qlen, d_dlen, d_thr,
                        )
                pidx = np.flatnonzero(passes)
                pr, ph, _ = map_selected(pidx, frm, to)
                if idx.packed is not None:
                    sids = (idx.packed[ph] >> np.uint32(12)).astype(np.int64)
                else:
                    sids = idx.sid[ph]
                return pr, sids

            def gate_begin(read_ids, from_rank, to_rank, prebuilt=None,
                           allow_small=True):
                """Dispatch a gate for a rank window WITHOUT fetching;
                returns a closure that fetches and maps the passes later,
                so the gate's device time and fetch hide behind the NW
                wave and the wave-1 judging.  The dispatch runs the
                SMALL extension window first (these stages gate the full
                streams of unresolved -- overwhelmingly random -- reads,
                whose walks provably die inside it); the rare escapees
                re-gate at the full window inside finish().  Returns None
                when this
                stage must run synchronously (enum path, dict-routed
                mesh, or read windows past the packed-rq format)."""
                packed = len(thr) < PACKED_MAX_READS
                routed = (
                    packed
                    and self._mesh is not None
                    and self._mesh.shape["dict"] > 1
                    and not os.environ.get("IMSAME_GATE_BROADCAST")
                )
                if use_enum or routed or window > 256:
                    return None
                if prebuilt is not None:
                    rids, hits, qoffs = prebuilt
                else:
                    with self.timer.phase("gate.build"):
                        rids, hits, qoffs = build_flat(
                            read_ids, from_rank, to_rank
                        )
                self._n_cands += len(rids)
                w_small = self.cfg.gate_window_small
                # The small tier's escalation costs one extra dispatch and
                # fetch; the ~2M-candidate cut-off is inherited and not
                # yet measured on the GPU.
                use_small = (
                    allow_small
                    and 0 < w_small < window
                    and len(rids) > 2_000_000
                )
                w1 = w_small if use_small else window
                with self.timer.phase("resolve.extend"):
                    if packed:
                        rq = (
                            rids.astype(np.uint32) << np.uint32(12)
                        ) | qoffs.astype(np.uint32)
                        pending = self._gate_chunks_dispatch(
                            True, hits, rq, d_thr, thr, d_qp, d_qlen, w1
                        )
                    else:
                        pending = self._gate_chunks_dispatch(
                            False, hits, rids, qoffs, thr, d_qp, d_qlen, w1
                        )

                def finish():
                    with self.timer.phase("resolve.extend"):
                        passes, exact = self._gate_chunks_fetch(
                            pending, len(hits)
                        )
                        if use_small:
                            esc = np.flatnonzero(~exact)
                            if len(esc):
                                if packed:
                                    p2, _ = self._gate_chunks(
                                        True, hits[esc], rq[esc], d_thr,
                                        thr, d_qp, d_qlen, window,
                                    )
                                else:
                                    p2, _ = self._gate_chunks(
                                        False, hits[esc], rids[esc],
                                        qoffs[esc], thr, d_qp, d_qlen,
                                        window,
                                    )
                                passes[esc] = p2
                    pidx = np.flatnonzero(passes)
                    if idx.packed is not None:
                        sids = (
                            idx.packed[hits[pidx]] >> np.uint32(12)
                        ).astype(np.int64)
                    else:
                        sids = idx.sid[hits[pidx]]
                    return rids[pidx], sids

                return finish

            def run_gate(read_ids, from_rank, to_rank, small_first=True):
                """Gate a rank window; returns the passing candidates'
                (read, db read) flat arrays in stream order (rids is
                non-decreasing along the flat stream)."""
                if use_enum:
                    return run_gate_enum(
                        read_ids, from_rank, to_rank, small_first
                    )
                with self.timer.phase("gate.build"):
                    rids, hits, qoffs = build_flat(
                        read_ids, from_rank, to_rank
                    )
                self._n_cands += len(rids)
                with self.timer.phase("resolve.extend"):
                    passes = self._gate(
                        rids, hits, qoffs, thr, d_thr, d_qp, d_qlen, window,
                        small_first=small_first,
                    )
                pidx = np.flatnonzero(passes)
                if idx.packed is not None:
                    sids = (idx.packed[hits[pidx]] >> np.uint32(12)).astype(
                        np.int64
                    )
                else:
                    sids = idx.sid[hits[pidx]]
                return rids[pidx], sids

            with self.timer.phase("resolve"):
                # Stage 1: first few candidates of every read (most reads
                # accept their first candidate, mirroring the reference's
                # early exit).  Its NW wave is DISPATCHED but not fetched,
                # and the stage-2 gate for reads with no passing stage-1
                # candidate -- which wave 1 cannot possibly resolve --
                # runs while that wave executes; only then is wave 1
                # fetched.  The rare reads whose stage-1 pairs all got
                # rejected gate their remainder afterwards, and one final
                # NW wave resolves everything stage 2 surfaced.
                F = cfg.first_window
                if cfg.first_window_auto and idx.n_entries:
                    # see Config.first_window_auto: dense dictionaries
                    # need a wider stage-1 window to surface the true
                    # partner's seed among ~load junk hits per bucket.
                    # The cap bounds only the auto-widening -- an
                    # explicitly larger first_window is honored.
                    load = idx.n_entries / float(4 ** FIXED_K)
                    F = max(
                        F,
                        min(64, F * max(1, int(np.ceil(2.0 * load)))),
                    )
                self._first_window_eff = F
                all_reads = np.flatnonzero(N_r > 0)
                # Stage-1 candidates are ~half true-pair seeds whose walks
                # span the whole read and escape the small tier anyway; on
                # short-read windows the direct full-window gate does the
                # same device work with one fewer dispatch and fetch.
                c0 = self._n_cands
                # Stage 1 async + speculative tail build: while stage 1's
                # chunks compute on device, the host builds the [F, N_r)
                # candidate tails of ALL reads (native, GIL-light) --
                # stage 2 gates the no-pass subset and stage 3 the
                # rejected-leftover subset, both row-compressions of this
                # one array, so their gate.build cost leaves the critical
                # path.  Stage 1 keeps the full extension window
                # (allow_small=False): half its candidates are true-pair
                # seeds whose walks escape the small tier anyway.
                fin1 = gate_begin(
                    all_reads,
                    np.zeros(len(all_reads), np.int64),
                    np.minimum(N_r[all_reads], F),
                    allow_small=False,
                )
                tail_pre = None
                if fin1 is not None:
                    with self.timer.phase("gate.build"):
                        tail_reads = np.flatnonzero(N_r > F)
                        if len(tail_reads):
                            tail_pre = build_flat(
                                tail_reads,
                                np.full(len(tail_reads), F, np.int64),
                                N_r[tail_reads],
                            )
                    pr1, ps1 = fin1()
                else:
                    pr1, ps1 = run_gate(
                        all_reads,
                        np.zeros(len(all_reads), np.int64),
                        np.minimum(N_r[all_reads], F),
                        small_first=window > 256,
                    )
                cr1, cs1, ck1, key1 = self._dedup_pairs(
                    pr1, ps1, rejected_keys
                )
                ss["s1"] = (self._n_cands - c0, len(pr1), len(cr1))
                with self.timer.phase("resolve.nw"):
                    P1, pend1 = self._nw_dispatch_pairs(
                        cr1, cs1, qlens, d_qp, d_dp, d_qlen, d_dlen
                    )

                has_pass = np.zeros(n, bool)
                if len(pr1):
                    has_pass[pr1] = True
                spec = np.flatnonzero(~has_pass & (N_r > F))
                pr2 = np.empty(0, np.int32)
                ps2 = np.empty(0, np.int64)
                fin2 = None
                if len(spec):
                    # Stage 2 dispatched behind wave 1 on the device queue
                    # and fetched only after judging -- its compute AND its
                    # fetch overlap the NW wave + host judging.
                    sub2 = None
                    if tail_pre is not None:
                        t_r, t_h, t_q = tail_pre
                        with self.timer.phase("gate.build"):
                            keep = ~has_pass[t_r]
                            sub2 = (t_r[keep], t_h[keep], t_q[keep])
                    fin2 = gate_begin(
                        spec, np.full(len(spec), F, np.int64), N_r[spec],
                        prebuilt=sub2,
                    )
                    if fin2 is None:
                        pr2, ps2 = run_gate(
                            spec, np.full(len(spec), F, np.int64), N_r[spec]
                        )

                with self.timer.phase("resolve.nw"):
                    results1 = self._nw_fetch_pairs(P1, pend1, 'nw.fetch1')
                self._judge_and_replay(
                    results1, ck1, pr1, ps1, key1,
                    rejected_keys, resolved, accepted_records, cfg,
                )

                leftover = np.flatnonzero(~resolved & (N_r > F) & has_pass)
                fin3 = None
                if len(leftover):
                    # dispatch the leftover gate BEFORE fetching stage 2:
                    # it queues behind stage 2 and computes during stage
                    # 2's fetch.
                    sub3 = None
                    if tail_pre is not None:
                        t_r, t_h, t_q = tail_pre
                        with self.timer.phase("gate.build"):
                            k3 = has_pass[t_r] & ~resolved[t_r]
                            sub3 = (t_r[k3], t_h[k3], t_q[k3])
                    fin3 = gate_begin(
                        leftover, np.full(len(leftover), F, np.int64),
                        N_r[leftover], prebuilt=sub3,
                    )
                if fin2 is not None:
                    pr2, ps2 = fin2()
                # Speculative wave A: NW the stage-2 passes' unique pairs
                # NOW, before the leftover gate's fetch -- the wave
                # computes during that fetch.  The leftover reads are
                # disjoint from spec, so their pairs join as wave B and
                # one combined judge replays both stream segments.
                cr2, cs2, ck2, key2 = self._dedup_pairs(
                    pr2, ps2, rejected_keys
                )
                ss["s2"] = (
                    int(N_r[spec].sum() - len(spec) * F) if len(spec) else 0,
                    len(pr2), len(cr2),
                )
                with self.timer.phase("resolve.nw"):
                    P2, pend2 = self._nw_dispatch_pairs(
                        cr2, cs2, qlens, d_qp, d_dp, d_qlen, d_dlen
                    )
                pr3 = np.empty(0, np.int32)
                ps3 = np.empty(0, np.int64)
                if len(leftover):
                    if fin3 is not None:
                        pr3, ps3 = fin3()
                    else:
                        pr3, ps3 = run_gate(
                            leftover, np.full(len(leftover), F, np.int64),
                            N_r[leftover],
                        )
                cr3, cs3, ck3, key3 = self._dedup_pairs(
                    pr3, ps3, rejected_keys, extra=ck2
                )
                ss["s3"] = (
                    int(N_r[leftover].sum() - len(leftover) * F)
                    if len(leftover) else 0,
                    len(pr3), len(cr3),
                )
                with self.timer.phase("resolve.nw"):
                    P3, pend3 = self._nw_dispatch_pairs(
                        cr3, cs3, qlens, d_qp, d_dp, d_qlen, d_dlen
                    )
                # Render overlap (VERDICT r4 item 5): the wave-1 winners
                # are final (first-accept-wins; later waves only touch
                # unresolved reads), so their render-NW + chain prefix
                # dispatch NOW -- queued behind the small wave-2/3 NW --
                # and compute during those fetches and the final judging
                # instead of serially inside render_report.
                if (
                    cfg.render_overlap and accepted_records
                    and self._mesh is None
                ):
                    early_todo = list(accepted_records)
                    with self.timer.phase("render.early_dispatch"):
                        early = (
                            early_todo,
                            self._render_dispatch_chains(
                                early_todo,
                                (d_qp, d_dp, d_qlen, d_dlen),
                            ),
                        )
                with self.timer.phase("resolve.nw"):
                    results2 = self._nw_fetch_pairs(P2, pend2, 'nw.fetch2')
                    results3 = self._nw_fetch_pairs(P3, pend3, 'nw.fetch3')
                if len(pr2) or len(pr3):
                    self._judge_and_replay(
                        np.concatenate([results2, results3]),
                        np.concatenate([ck2, ck3]),
                        np.concatenate([pr2, pr3]),
                        np.concatenate([ps2, ps3]),
                        np.concatenate([key2, key3]),
                        rejected_keys, resolved, accepted_records, cfg,
                    )

        with self.timer.phase("render"):
            accepted_records.sort(key=lambda a: a.qread)

        return PipelineResult(
            accepted=len(accepted_records),
            n_query=n,
            n_db=db.n_seqs,
            pairs=[(a.qread, a.dbread) for a in accepted_records],
            records=accepted_records,
            timings=dict(self.timer.items()),
            nw_cells=self._nw_cells,
            n_candidates=self._n_cands,
            early_render=early,
        )

    # ------------------------------------------------------------------
    # Chain prefix fetched speculatively at dispatch: chains are
    # diagonal-run compressed, so max(n_steps)+1 is typically tens of
    # entries while the tensor is 2L wide -- the prefix cuts the render's
    # device-to-host copy ~10x.  Chunks whose chains exceed it re-fetch a
    # wider pow2 slice at collect time.
    _CHAIN_PREFIX = 64

    def _render_dispatch_chains(self, todo: List[AcceptedRead], dev):
        """Dispatch the render-NW (backpointer kernel + traceback) over
        ``todo`` records WITHOUT fetching, with async host copies of the
        per-pair stats and a speculative chain prefix queued right behind
        each chunk's kernel -- the caller collects via
        _render_collect_chains.  Used both by _materialize_chains and by
        _compare's render overlap (the wave-1 winners' chains compute
        during the wave-2/3 judging; VERDICT r4 item 5)."""
        d_qp, d_dp, d_qlen, d_dlen = dev
        r_ids = np.array([rec.qread for rec in todo], np.int64)
        sids = np.array([rec.dbread for rec in todo], np.int64)
        qlens = np.zeros(int(r_ids.max()) + 1, np.int64)
        for rec in todo:
            qlens[rec.qread] = rec.ylen
        pending = []
        for chunk, rpad, spad, L in self._nw_chunks(
            r_ids, sids, qlens, render=True, count_cells=False
        ):
            res = self._nw_render_dispatch(
                d_qp, d_dp, np.stack([rpad, spad]), d_qlen, d_dlen, L
            )
            pre = res.chain[:, : self._CHAIN_PREFIX]
            for a in (res.length, res.identities, res.n_steps, pre):
                _host_async(a)
            pending.append((chunk, res, pre))
        return pending

    def _render_collect_chains(
        self, todo: List[AcceptedRead], pending
    ) -> None:
        """Fetch + assign the chains dispatched by _render_dispatch_chains
        (stats cross-check included: the stats aligner must equal the
        traceback aligner per pair)."""
        flat = jax.device_get(
            [a for _, res, pre in pending
             for a in (res.length, res.identities, res.n_steps, pre)]
        )
        chain_parts = []
        for ci, (chunk, res, _pre) in enumerate(pending):
            nsteps = flat[4 * ci + 2]
            ch = res.chain
            need = int(nsteps.max()) + 1 if len(nsteps) else 1
            if need <= self._CHAIN_PREFIX:
                chain_parts.append(None)  # speculative prefix suffices
                continue
            W = self._CHAIN_PREFIX
            while W < need:
                W *= 2
            chain_parts.append(ch if W >= ch.shape[1] else ch[:, :W])
        wide = jax.device_get([c for c in chain_parts if c is not None])
        wi = 0
        for ci, (chunk, _res, _pre) in enumerate(pending):
            lengths, idents, nsteps = flat[4 * ci : 4 * ci + 3]
            if chain_parts[ci] is None:
                chains = flat[4 * ci + 3]
            else:
                chains = wide[wi]
                wi += 1
            for b, i in enumerate(chunk):
                rec = todo[i]
                assert int(lengths[b]) == rec.length
                assert int(idents[b]) == rec.identities
                rec.n_steps = int(nsteps[b])
                rec.chain = chains[b]

    def _materialize_chains(
        self, records: List[AcceptedRead], dev=None, early=None
    ) -> None:
        """Produce traceback chains for accepted pairs by re-running the
        backpointer kernel + traceback on exactly those pairs (the accept
        path used the stats-only aligner, which writes no bp tensor --
        accepted pairs are the only ones whose path must be rendered).

        ``dev`` is an optional snapshot of the compare's device state
        (d_qp, d_dp, d_qlen, d_dlen): pass it when rendering runs
        concurrently with a later compare on the same engine (the
        orchestrator's deferred-render worker), since self._last_dev is
        overwritten per compare.  ``early`` is a PipelineResult's
        early_render (records already dispatched inside _compare)."""
        if early is not None:
            early_todo, early_pending = early
            if early_pending:
                self._render_collect_chains(early_todo, early_pending)
                # consume: a second render_report must not re-fetch
                early_pending.clear()
        todo = [rec for rec in records if rec.chain is None]
        if not todo:
            return
        dev = dev if dev is not None else self._last_dev
        assert dev is not None, "render before compare"
        pending = self._render_dispatch_chains(todo, dev)
        self._render_collect_chains(todo, pending)

    def render_report(
        self, q: SeqInfo, result: PipelineResult, dev=None
    ) -> bytes:
        """Byte-identical -out file content (records in read order, matching
        the reference at n_threads=1).  The block emission runs in the
        native host library when available (batched backtrack + 60-col
        render, native/host.c imsame_render_blocks); the Python path below
        is the bit-identical fallback.  ``dev``: see _materialize_chains."""
        self._materialize_chains(
            result.records, dev=dev, early=result.early_render
        )
        db = self.db
        recs = result.records
        if recs and native.lib is not None:
            blocks = self._render_blocks_native(q, recs)
            if blocks is not None:
                out = bytearray()
                for a, block in zip(recs, blocks):
                    out += format_record(
                        a.qread, a.dbread, a.identities, a.length, a.ylen,
                        block,
                    )
                return bytes(out)
        out = bytearray()
        for a in recs:
            xs = int(db.start[a.dbread])
            xe = db.read_end(a.dbread)
            ys = int(q.start[a.qread])
            ye = q.read_end(a.qread)
            x_chars = CODE_TO_CHAR[db.codes[xs:xe]]
            y_chars = CODE_TO_CHAR[q.codes[ys:ye]]
            rec_x, rec_y, hx, hy, ml = backtrack_from_chain(
                a.chain, a.n_steps, xe - xs, ye - ys, x_chars, y_chars
            )
            block, identities = render_alignment(rec_x, rec_y, hx, hy, ml)
            assert identities == a.identities  # traceback/render agreement
            out.extend(
                format_record(
                    a.qread, a.dbread, identities, a.length, a.ylen, block
                )
            )
        return bytes(out)

    def _render_blocks_native(self, q: SeqInfo, recs) -> Optional[list]:
        """Batched native block render; returns per-record block bytes.
        Cross-checks the emission-time identity count against the NW
        stats, like the Python path's assert."""
        db = self.db
        P = len(recs)
        # vectorized prep: python-loop gathers cost ~0.1 s at 10k records
        qr = np.fromiter((a.qread for a in recs), np.int64, P)
        dr = np.fromiter((a.dbread for a in recs), np.int64, P)
        db_ends = np.append(db.start[1:], db.total_len)
        q_ends = np.append(q.start[1:], q.total_len)
        xoff = db.start[dr]
        yoff = q.start[qr]
        xlen = (db_ends[dr] - xoff).astype(np.int32)
        ylen = (q_ends[qr] - yoff).astype(np.int32)
        width = max(len(a.chain) for a in recs)
        chains = np.zeros((P, width), np.int32)
        for p, a in enumerate(recs):
            chains[p, : len(a.chain)] = a.chain
        n_steps = np.fromiter((a.n_steps for a in recs), np.int32, P)
        span = 2 * np.maximum(xlen, ylen).astype(np.int64)
        caps = 3 * span + 3 * (span // 60 + 2) + 8
        out_off = np.zeros(P + 1, np.int64)
        np.cumsum(caps, out=out_off[1:])
        res = native.render_blocks(
            chains, n_steps, xlen, ylen,
            CODE_TO_CHAR[db.codes], xoff, CODE_TO_CHAR[q.codes], yoff,
            out_off[:-1], int(out_off[-1]),
        )
        if res is None:
            return None
        out, out_len, identities = res
        for p, a in enumerate(recs):
            assert int(identities[p]) == a.identities
        return [
            out[out_off[p] : out_off[p] + out_len[p]].tobytes()
            for p in range(P)
        ]
