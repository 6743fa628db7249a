"""Flat candidate gate: one fused jit step over packed read rows.

The reference walks each query read's candidate stream sequentially --
k-mer scan positions x posting-list hits -- running the ungapped
extension + e-value gate per candidate (src/alignmentFunctions.c:118-199).
Here the host enumerates the exact candidate list to gate (it owns the
cheap stream tables: k-mer slots, bucket offsets, per-read ranks) and
ships three int32 vectors per candidate chunk -- query read id, index-hit
row, and the k-mer's one-past-end offset within the read -- plus the
per-candidate score threshold.  The device maps hits to (db read, row
offset) with two gathers from engine-resident arrays and runs the packed
extension (ops/extend_packed.py), returning one bit per candidate.

Chunks are padded to a few fixed power-of-two sizes: each distinct shape
is a separate XLA compile.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .extend_packed import extend_packed


def gate_core(
    qp, dp, qlen, dlen, idx_tab, r, hit, qoff, thr,
    *, window: int, packed_idx: bool,
):
    """Unjitted gate body: candidate -> (pass bool, exact bool).  Shared
    by the single-device flat_gate and the data-parallel sharded step
    (parallel/sharded.py).

    ``idx_tab`` is either one int32 array of (sid << 12) | doff words
    (packed_idx=True: half the device-resident index payload and one
    gather instead of two; requires n_db < 2^20 reads and db read
    length < 4096) or the (idx_pos, idx_sid, db_start) triple."""
    if packed_idx:
        hit = jnp.clip(hit, 0, jnp.maximum(idx_tab.shape[0] - 1, 0))
        w = idx_tab[hit].astype(jnp.uint32)
        s = (w >> jnp.uint32(12)).astype(jnp.int32)
        doff = (w & jnp.uint32(0xFFF)).astype(jnp.int32)
    else:
        idx_pos, idx_sid, db_start = idx_tab
        hit = jnp.clip(hit, 0, jnp.maximum(idx_pos.shape[0] - 1, 0))
        s = idx_sid[hit]
        doff = idx_pos[hit] - db_start[s]
    res = extend_packed(
        qp, dp, r, s, qoff, doff, qlen[r], dlen[s], thr, W=window
    )
    return res.passes, res.exact


@functools.partial(jax.jit, static_argnames=("window", "packed_idx"))
def flat_gate_packed(
    qp: jax.Array,  # [n_q, WP] uint32 packed query rows
    dp: jax.Array,  # [n_db, WP] uint32 packed db rows
    qlen: jax.Array,  # [n_q] int32
    dlen: jax.Array,  # [n_db] int32
    idx_tab,  # packed index words, or (idx_pos, idx_sid, db_start) triple
    cand: jax.Array,  # [2, N] int32: row 0 index-hit row, row 1 the
    # (query read id << 12) | qoff word (bit-cast from uint32)
    thr_tab: jax.Array,  # [n_q] int32 per-READ raw-score threshold
    *,
    window: int,
    packed_idx: bool,
) -> jax.Array:
    """flat_gate with candidate traffic halved and one buffer each way:
    the read id and the k-mer offset share one uint32 (qoff <=
    MAX_READ_SIZE < 2^12; requires n_q < 2^20), both candidate vectors
    ride one stacked array, and the per-read threshold lives in a table
    uploaded once per compare instead of once per candidate.  Padding
    entries return garbage bits; callers read only the first `take`
    bits of the result."""
    N = cand.shape[1]
    hit = cand[0]
    rq = cand[1].astype(jnp.uint32)
    r = (rq >> jnp.uint32(12)).astype(jnp.int32)
    qoff = (rq & jnp.uint32(0xFFF)).astype(jnp.int32)
    passes, exact = gate_core(
        qp, dp, qlen, dlen, idx_tab,
        r, hit, qoff, thr_tab[r], window=window, packed_idx=packed_idx,
    )
    stacked = jnp.stack([passes, exact])  # [2, N]
    bits = stacked.reshape(2, N // 32, 32).astype(jnp.int32)
    weights = (jnp.int32(1) << jnp.arange(32, dtype=jnp.int32))[None, None, :]
    return jnp.sum(bits * weights, axis=2).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("window", "packed_idx"))
def flat_gate_seg(
    qp: jax.Array,  # [n_q, WP] uint32 packed query rows
    dp: jax.Array,  # [n_db, WP] uint32 packed db rows
    qlen: jax.Array,  # [n_q] int32
    dlen: jax.Array,  # [n_db] int32
    idx_tab,  # packed index words, or (idx_pos, idx_sid, db_start) triple
    cand: jax.Array,  # [C] int32 words: new_seg<<31 | qoff_delta<<25 | hit
    rtab: jax.Array,  # [S] int32 query read id per segment
    rbase: jax.Array,  # [S] int32 qoff decode base per segment
    thr_tab: jax.Array,  # [n_q] int32 per-READ raw-score threshold
    *,
    window: int,
    packed_idx: bool,
) -> jax.Array:
    """Segment-encoded twin of flat_gate_packed at HALF the per-candidate
    host-to-device bytes (at 100k reads the gate ships ~12M candidates).
    Whether the saving pays on a local GPU is not measured yet.

    The host exploits stream order (read-major, qoff non-decreasing
    within a read): each candidate is ONE int32 -- bit 31 a new-segment
    flag, bits 25..30 the qoff delta vs the previous candidate (0..63),
    bits 0..24 the index-hit row -- plus two per-SEGMENT words (read id,
    qoff decode base).  Segments break on read change, qoff-delta
    overflow, or chunk start, so decoding is exact:

        rix  = cumsum(flag) - 1
        r    = rtab[rix]
        qoff = rbase[rix] + cumsum(delta)

    Requires index rows < 2^25 (the host falls back to flat_gate_packed
    otherwise) and segments <= S (host checks; S is a fixed shape for
    compile reuse).  Padding candidates decode to garbage but their bits
    are ignored by the caller, like flat_gate_packed."""
    C = cand.shape[0]
    w = jax.lax.bitcast_convert_type(cand, jnp.uint32)
    flag = (w >> jnp.uint32(31)).astype(jnp.int32)
    qd = ((w >> jnp.uint32(25)) & jnp.uint32(0x3F)).astype(jnp.int32)
    hit = (w & jnp.uint32(0x1FFFFFF)).astype(jnp.int32)
    rix = jnp.cumsum(flag) - 1
    r = rtab[jnp.clip(rix, 0, rtab.shape[0] - 1)]
    qoff = rbase[jnp.clip(rix, 0, rbase.shape[0] - 1)] + jnp.cumsum(qd)
    passes, exact = gate_core(
        qp, dp, qlen, dlen, idx_tab,
        r, hit, qoff, thr_tab[r], window=window, packed_idx=packed_idx,
    )
    stacked = jnp.stack([passes, exact])  # [2, C]
    bits = stacked.reshape(2, C // 32, 32).astype(jnp.int32)
    weights = (jnp.int32(1) << jnp.arange(32, dtype=jnp.int32))[None, None, :]
    return jnp.sum(bits * weights, axis=2).astype(jnp.int32)


def encode_seg_chunk(rids, qoffs, hits, size: int):
    """Host-side segment encoding for one chunk slice (numpy, vectorized).

    Returns (cand[size] int32, rtab[n_seg] int32, rbase[n_seg] int32);
    the caller pads rtab/rbase to its fixed segment-capacity shape (or
    falls back to the 8-byte format when n_seg exceeds every capacity)."""
    import numpy as np

    n = len(rids)
    new_seg = np.empty(n, bool)
    new_seg[0] = True
    dq = np.empty(n, np.int64)
    dq[0] = 0
    dq[1:] = qoffs[1:].astype(np.int64) - qoffs[:-1]
    new_seg[1:] = (rids[1:] != rids[:-1]) | (dq[1:] < 0) | (dq[1:] > 63)
    qd = np.where(new_seg, 0, dq)
    cs = np.cumsum(qd)
    cand = np.zeros(size, np.int32)
    cand[:n] = (
        (new_seg.astype(np.uint32) << np.uint32(31))
        | (qd.astype(np.uint32) << np.uint32(25))
        | hits.astype(np.uint32)
    ).view(np.int32)
    rtab = rids[new_seg].astype(np.int32)
    rbase = (qoffs.astype(np.int64) - cs)[new_seg].astype(np.int32)
    return cand, rtab, rbase


@functools.partial(jax.jit, static_argnames=("window", "packed_idx"))
def flat_gate(
    qp: jax.Array,  # [n_q, WP] uint32 packed query rows
    dp: jax.Array,  # [n_db, WP] uint32 packed db rows
    qlen: jax.Array,  # [n_q] int32
    dlen: jax.Array,  # [n_db] int32
    idx_tab,  # packed index words, or (idx_pos, idx_sid, db_start) triple
    r: jax.Array,  # [N] int32 query read id per candidate
    hit: jax.Array,  # [N] int32 index row per candidate
    qoff: jax.Array,  # [N] int32 one past seed end, query row coords
    thr: jax.Array,  # [N] int32 raw-score threshold per candidate
    n_valid: jax.Array,  # [] int32 count of real candidates (rest padding)
    *,
    window: int,
    packed_idx: bool,
) -> jax.Array:
    """Returns pass and exactness bits, each packed 32 candidates per
    int32 word, stacked as [2, N//32] (row 0 = pass, row 1 = exact)."""
    N = r.shape[0]
    passes, exact = gate_core(
        qp, dp, qlen, dlen, idx_tab, r, hit, qoff, thr,
        window=window, packed_idx=packed_idx,
    )
    valid = jnp.arange(N, dtype=jnp.int32) < n_valid
    stacked = jnp.stack([passes & valid, exact])  # [2, N]
    bits = stacked.reshape(2, N // 32, 32).astype(jnp.int32)
    weights = (jnp.int32(1) << jnp.arange(32, dtype=jnp.int32))[None, None, :]
    return jnp.sum(bits * weights, axis=2).astype(jnp.int32)
