"""Device-side candidate enumeration for the extension gate.

The host candidate path (pipeline.build_flat + ops/candidates.py) ships two
int32 words per candidate from host to device; at ~40 candidates per read
that is ~8 bytes x 800k candidates per 20k-read compare, plus a host
expansion pass.  This module rebuilds the reference worker's
candidate stream (src/alignmentFunctions.c:91-186: k-mer scan positions in
order x bucket hits newest-first) ON DEVICE from data that is already
there:

  * the packed 2-bit query rows (uploaded once per compare),
  * the index bucket prefix table ``bucket_start`` (uploaded once per
    ENGINE -- 4^12 int32 words; the one new resident),
  * per-read scalars (lengths, boundary flags, rank windows): O(n_reads)
    words per stage instead of O(candidates).

Layout: a [R, S] slot grid, S = row_len - K + 2 slot columns per read.
Slot j of read r is the j-th k-mer of the read's scan stream, INCLUDING
the reference's boundary-base quirk (SURVEY.md 6.5): a read whose stream
inherits the previous read's trailing base (hasb[r] = 1) has slot 0 =
that base + its own first K-1 bases, and slot j covers row offsets
[j - hasb, j - hasb + K - 1].  hasb is computed by the host (it owns the
n_threads split semantics) and uploaded as one word per read.

Candidate rank windows [frm[r], to[r]) select per-read slices of the
stream in stream order; a chunk call materializes C consecutive selected
candidates (one inverse-prefix search) and feeds them straight into the
shared gate body (ops/candidates.gate_core) -- one fused jit, no
candidate bytes copied from the host.  Bit-for-bit the same verdict stream as the
host path (tests/test_enum_gate.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..constants import FIXED_K
from .candidates import gate_core

BASES_PER_WORD = 16


def _rev2_groups(w: jax.Array) -> jax.Array:
    """Reverse the sixteen 2-bit groups of each uint32 lane."""
    w = ((w & jnp.uint32(0x33333333)) << jnp.uint32(2)) | (
        (w >> jnp.uint32(2)) & jnp.uint32(0x33333333)
    )
    w = ((w & jnp.uint32(0x0F0F0F0F)) << jnp.uint32(4)) | (
        (w >> jnp.uint32(4)) & jnp.uint32(0x0F0F0F0F)
    )
    w = ((w & jnp.uint32(0x00FF00FF)) << jnp.uint32(8)) | (
        (w >> jnp.uint32(8)) & jnp.uint32(0x00FF00FF)
    )
    return (w << jnp.uint32(16)) | (w >> jnp.uint32(16))


@functools.partial(jax.jit, static_argnames=("row_len",))
def build_enum_tables(
    qp: jax.Array,  # [R, WP] uint32 packed query rows
    bs: jax.Array,  # [4^K + 1] int32 bucket prefix table (engine-resident)
    hasb: jax.Array,  # [R] int32 1 iff the read inherits a boundary base
    n_kmers: jax.Array,  # [R] int32 slots per read (0 past real reads)
    qlen: jax.Array,  # [R] int32 read lengths
    *,
    row_len: int,
):
    """Per-compare slot tables: (lo, cnt, Rcum, tot).

    lo[r, j]   first index row of slot j's bucket
    cnt[r, j]  bucket size (0 outside the read's slot range)
    Rcum[r, j] exclusive per-read prefix of cnt (candidate rank base)
    tot[r]     candidate count of read r (== N_r of the host stream)
    """
    R, WP = qp.shape
    S = row_len - FIXED_K + 2
    # 16-base windows at every row offset t in [0, S-2] (slot offsets).
    t = jnp.arange(S - 1, dtype=jnp.int32)
    wi = t >> 4
    sh = (2 * (t & 15)).astype(jnp.uint32)[None, :]
    lo_w = qp[:, wi]
    hi_w = qp[:, jnp.minimum(wi + 1, WP - 1)]
    w16 = jnp.where(sh == 0, lo_w, (lo_w >> sh) | (hi_w << (jnp.uint32(32) - sh)))
    # big-endian 12-mer key starting at offset t (reference rolling-key
    # convention: first base in the high bits, src/IMSAME.c:236-239)
    key_at = (_rev2_groups(w16) >> jnp.uint32(8)) & jnp.uint32(0xFFFFFF)
    # boundary slot key: previous read's last base + own first 11 bases
    ridx = jnp.arange(R, dtype=jnp.int32)
    prev = jnp.maximum(ridx - 1, 0)
    pl_off = jnp.maximum(qlen[prev] - 1, 0)
    pword = qp[prev, pl_off >> 4]
    prev_last = (pword >> (2 * (pl_off & 15)).astype(jnp.uint32)) & jnp.uint32(3)
    key_m1 = (prev_last << jnp.uint32(22)) | (key_at[:, 0] >> jnp.uint32(2))
    keys1 = jnp.concatenate([key_m1[:, None], key_at], axis=1)  # hasb = 1
    keys0 = jnp.concatenate(
        [key_at, jnp.zeros((R, 1), jnp.uint32)], axis=1
    )  # hasb = 0
    keys = jnp.where(hasb[:, None] == 1, keys1, keys0).astype(jnp.int32)
    valid = jax.lax.broadcasted_iota(jnp.int32, (R, S), 1) < n_kmers[:, None]
    keys = jnp.where(valid, keys, 0)
    lo = bs[keys]
    hi = bs[keys + 1]
    cnt = jnp.where(valid, hi - lo, 0)
    ccum = jnp.cumsum(cnt, axis=1, dtype=jnp.int32)
    Rcum = ccum - cnt  # exclusive
    tot = ccum[:, -1]
    return lo, cnt, Rcum, tot


@jax.jit
def enum_select_prefix(
    cnt: jax.Array,  # [R, S]
    Rcum: jax.Array,  # [R, S]
    frm: jax.Array,  # [R] first selected rank per read
    to: jax.Array,  # [R] one past last selected rank (0 = read unselected)
):
    """Inclusive prefix of the per-slot selected-candidate counts, plus the
    flattened per-slot selection start offsets.  One call per stage; the
    chunk calls below search it."""
    lo_r = jnp.maximum(frm[:, None], Rcum)
    hi_r = jnp.minimum(to[:, None], Rcum + cnt)
    sel = jnp.maximum(hi_r - lo_r, 0)
    start_off = (lo_r - Rcum).astype(jnp.int32)  # valid where sel > 0
    scum = jnp.cumsum(sel.reshape(-1), dtype=jnp.int32)  # [R*S] inclusive
    return scum, start_off.reshape(-1)


@functools.partial(
    jax.jit, static_argnames=("chunk", "window", "packed_idx", "row_len")
)
def enum_gate_chunk(
    qp: jax.Array,  # [R, WP] uint32 packed query rows
    dp: jax.Array,  # [n_db, WPd] uint32 packed db rows
    qlen: jax.Array,
    dlen: jax.Array,
    idx_tab,  # engine index payload (packed words or triple)
    thr_tab: jax.Array,  # [R] per-read raw-score thresholds
    lo_g: jax.Array,  # [R, S] from build_enum_tables
    scum: jax.Array,  # [R*S] from enum_select_prefix
    start_off: jax.Array,  # [R*S]
    hasb: jax.Array,  # [R]
    o_base,  # scalar: global selected rank of this chunk's first slot
    *,
    chunk: int,
    window: int,
    packed_idx: bool,
    row_len: int,
) -> jax.Array:
    """Gate selected candidates [o_base, o_base + chunk) of the current
    stage; returns pass/exact bits packed as [2, chunk // 32] int32 (same
    contract as flat_gate_packed; entries past the stage total are
    garbage)."""
    S = row_len - FIXED_K + 2
    RS = lo_g.shape[0] * S
    o = jnp.asarray(o_base, jnp.int32) + jnp.arange(chunk, dtype=jnp.int32)
    p = jnp.searchsorted(scum, o, side="right").astype(jnp.int32)
    p = jnp.minimum(p, RS - 1)
    r = p // S
    j = p - r * S
    sel_before = jnp.where(p > 0, scum[jnp.maximum(p - 1, 0)], 0)
    h = o - sel_before
    hit = lo_g.reshape(-1)[p] + start_off[p] + h
    qoff = j - hasb[r] + FIXED_K
    passes, exact = gate_core(
        qp, dp, qlen, dlen, idx_tab, r, hit, qoff, thr_tab[r],
        window=window, packed_idx=packed_idx,
    )
    stacked = jnp.stack([passes, exact])  # [2, chunk]
    bits = stacked.reshape(2, chunk // 32, 32).astype(jnp.int32)
    weights = (jnp.int32(1) << jnp.arange(32, dtype=jnp.int32))[None, None, :]
    return jnp.sum(bits * weights, axis=2).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("chunk", "row_len"))
def enum_candidates_debug(
    lo_g, scum, start_off, hasb, o_base, *, chunk: int, row_len: int
):
    """Candidate triples (rid, hit, qoff) for a chunk -- test-only twin of
    enum_gate_chunk's addressing, compared against the host build_flat."""
    S = row_len - FIXED_K + 2
    RS = lo_g.shape[0] * S
    o = jnp.asarray(o_base, jnp.int32) + jnp.arange(chunk, dtype=jnp.int32)
    p = jnp.searchsorted(scum, o, side="right").astype(jnp.int32)
    p = jnp.minimum(p, RS - 1)
    r = p // S
    j = p - r * S
    sel_before = jnp.where(p > 0, scum[jnp.maximum(p - 1, 0)], 0)
    h = o - sel_before
    hit = lo_g.reshape(-1)[p] + start_off[p] + h
    qoff = j - hasb[r] + FIXED_K
    return r, hit, qoff
