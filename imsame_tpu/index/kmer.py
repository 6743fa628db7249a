"""Sorted k-mer index over a database sample.

Array replacement for the reference's 4^12 pointer table with per-bucket
linked lists (reference: Container at src/alignmentFunctions.h:4-6, build loop
at src/IMSAME.c:232-281, llpos at src/structs.h:26-30).  Instead of 128 MB of
host pointers we store three flat arrays sorted by (key asc, pos desc):

  keys[N]  uint32  packed 2-bit k-mer key, first base most significant
  pos[N]   int64   one past the k-mer's last base in the concatenated array
                   (reference stores the same: src/IMSAME.c:247)
  sid[N]   int64   read id of the k-mer's read

Bucket lookup is a vectorized binary search (``np.searchsorted`` /
``jnp.searchsorted``) for the [lo, hi) range of a key.  Within a bucket,
entries are ordered by *decreasing* pos, which reproduces the reference's
prepend-on-insert iteration order ("newest first", src/IMSAME.c:263-276) --
behavioral quirk #1 in SURVEY.md section 6, load-bearing for which database
read a query pairs with first.
"""

from __future__ import annotations

import numpy as np

from ..constants import FIXED_K
from ..io.fasta import SeqInfo, valid_db_kmer_starts


def pack_kmers(codes: np.ndarray, starts: np.ndarray, k: int = FIXED_K) -> np.ndarray:
    """Pack k-mers starting at ``starts`` into uint32 keys (base-4, first
    base most significant, mirroring the reference's table[c0][c1]...[c11]
    nesting order)."""
    keys = np.zeros(len(starts), dtype=np.uint32)
    for i in range(k):
        keys = (keys << np.uint32(2)) | codes[starts + i].astype(np.uint32)
    return keys


def rolling_keys(codes: np.ndarray, k: int = FIXED_K) -> np.ndarray:
    """Keys for every window start 0..n-k (vectorized rolling pack)."""
    n = len(codes)
    if n < k:
        return np.empty(0, np.uint32)
    keys = np.zeros(n - k + 1, dtype=np.uint32)
    for i in range(k):
        keys = (keys << np.uint32(2)) | codes[i : n - k + 1 + i].astype(np.uint32)
    return keys


class KmerIndex:
    """Flat sorted k-mer index (host arrays; device copies made on demand).

    ``bucket_start`` is the direct-addressed replacement for the
    reference's 4^12 pointer table (src/alignmentFunctions.h:4-6): entry
    [key] is the first index of that key's bucket, [key+1] one past it.
    Lookup is two O(1) gathers instead of a binary search per k-mer.

    ``packed`` holds the device-payload words (sid << 12) | (pos -
    start[sid]); valid only when db_n_seqs < 2^20 and read lengths < 4096
    (pipeline checks).  In that regime the native build scatters ONLY
    these words (the scatter is the build's bandwidth bottleneck) and
    ``keys``/``pos``/``sid`` are derived lazily on first access:
      keys  from bucket_start (each bucket's key repeated count times)
      sid   = packed >> 12
      pos   = db_start[sid] + (packed & 0xFFF)
    The hot pipeline path never touches them (it gathers packed directly).
    """

    def __init__(
        self,
        keys: np.ndarray = None,  # uint32 [N], ascending
        pos: np.ndarray = None,  # int32 [N], one-past k-mer end;
        # descending within a key
        sid: np.ndarray = None,  # int32 [N]
        db_total_len: int = 0,
        db_n_seqs: int = 0,
        bucket_start: np.ndarray = None,  # int32 [4^k + 1]
        packed: np.ndarray = None,  # uint32 [N] or None
        db_start: np.ndarray = None,  # int64 [n_seqs]; for lazy pos
    ):
        self._keys = keys
        self._pos = pos
        self._sid = sid
        self.db_total_len = db_total_len
        self.db_n_seqs = db_n_seqs
        self.packed = packed
        self._db_start = db_start
        if bucket_start is None:
            n_keys = 4**FIXED_K
            counts = np.bincount(keys, minlength=n_keys)
            # int32: halves the memory traffic of the two random gathers
            # per query k-mer (the table is 67 MB; cache-resident slices
            # matter more than the cumsum cost).  cumsum natively then
            # cast -- cumsum with a casting `out=` is ~14x slower.
            bucket_start = np.empty(n_keys + 1, np.int32)
            bucket_start[0] = 0
            bucket_start[1:] = counts.cumsum(dtype=np.int64)
        self.bucket_start = bucket_start

    @property
    def keys(self) -> np.ndarray:
        if self._keys is None:
            counts = np.diff(self.bucket_start)
            self._keys = np.repeat(
                np.arange(len(counts), dtype=np.uint32), counts
            )
        return self._keys

    @property
    def sid(self) -> np.ndarray:
        if self._sid is None:
            self._sid = (self.packed >> np.uint32(12)).astype(np.int32)
        return self._sid

    @property
    def pos(self) -> np.ndarray:
        if self._pos is None:
            doff = self.packed & np.uint32(0xFFF)
            self._pos = (
                self._db_start[self.sid] + doff
            ).astype(np.int32)
        return self._pos

    @property
    def n_entries(self) -> int:
        return int(self.bucket_start[-1])

    def lookup_range(self, key: int):
        """[lo, hi) range of a single key (host path, used by the oracle)."""
        return int(self.bucket_start[key]), int(self.bucket_start[key + 1])

    def lookup_ranges(self, query_keys: np.ndarray):
        lo = self.bucket_start[query_keys]
        hi = self.bucket_start[query_keys.astype(np.int64) + 1]
        return lo, hi


def save_index(idx: KmerIndex, path: str) -> None:
    """Persist the sorted index (SURVEY.md 5.4: the reference rebuilds its
    dictionary from FASTA every run; device-friendly flat arrays serialize
    trivially, making per-sample index reuse an orchestrator-level win).

    Compact uncompressed form: in the packed regime only (packed, keys)
    hit disk (~8 B/entry); pos/sid stay lazy and bucket_start is a
    ~100 ms bincount on load.  savez_compressed here cost 9 s per 5 Mbp
    sample -- 40x the 0.23 s rebuild the cache exists to skip."""
    meta = dict(
        db_total_len=np.int64(idx.db_total_len),
        db_n_seqs=np.int64(idx.db_n_seqs),
    )
    if idx.packed is not None:
        np.savez(path, packed=idx.packed, keys=idx.keys, **meta)
    else:
        np.savez(path, keys=idx.keys, pos=idx.pos, sid=idx.sid, **meta)


def load_index(path: str, db_start: np.ndarray = None) -> KmerIndex:
    """Reload a saved index.  ``db_start`` (the sample's read offsets)
    enables the lazy ``pos`` derivation of packed-regime indexes."""
    with np.load(path) as z:
        packed = z["packed"] if "packed" in z.files else None
        return KmerIndex(
            keys=z["keys"],
            pos=z["pos"] if "pos" in z.files else None,
            sid=z["sid"] if "sid" in z.files else None,
            db_total_len=int(z["db_total_len"]),
            db_n_seqs=int(z["db_n_seqs"]),
            packed=packed,
            db_start=db_start,
        )


def build_index(db: SeqInfo, k: int = FIXED_K) -> KmerIndex:
    """Build the sorted index over a database SeqInfo.

    Insertion set and per-bucket order are bit-compatible with the reference
    build loop: k-mers fully inside a read with no window reset inside
    (valid_db_kmer_starts), ordered newest-first within each bucket.
    """
    if k <= 16:
        from .. import native

        lens = db.read_lens()
        packable = db.n_seqs < (1 << 20) and (
            db.n_seqs == 0 or int(lens.max()) < 4096
        )
        arrs = native.build_index_arrays(
            db.codes, db.fresh, db.start, k, packable
        )
        if arrs is not None:
            bucket_start, packed, pos, sid = arrs
            return KmerIndex(
                pos=pos,
                sid=sid,
                db_total_len=db.total_len,
                db_n_seqs=db.n_seqs,
                bucket_start=bucket_start,
                packed=packed,
                db_start=db.start,
            )

    starts = valid_db_kmer_starts(db, k)
    keys = rolling_keys(db.codes, k)[starts] if len(starts) else np.empty(
        0, np.uint32
    )
    pos = (starts + k).astype(np.int32)  # one past the last base
    # (reference: src/IMSAME.c:247)
    # sid: read containing the k-mer == read containing its first base.
    sid = (np.searchsorted(db.start, starts, side="right") - 1).astype(
        np.int32
    )
    # Sort by key asc, pos desc: entries are generated in ascending pos, so
    # a *stable* sort of the reversed key array (numpy radix-sorts integer
    # keys) yields descending pos within each key -- one 32-bit radix pass
    # instead of a 64-bit composite sort.
    order = len(keys) - 1 - np.argsort(keys[::-1], kind="stable")
    return KmerIndex(
        keys=keys[order],
        pos=pos[order],
        sid=sid[order],
        db_total_len=db.total_len,
        db_n_seqs=db.n_seqs,
    )
