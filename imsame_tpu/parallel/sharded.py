"""Sharded production-engine steps: shard_map over the ('data', 'dict')
mesh.  These are the exact steps TpuEngine dispatches when a mesh is set
(pipeline.py _gate_dispatch/_nw_stats_dispatch/_nw_render_dispatch); the
single-device engine calls the same underlying kernels unsharded, so mesh
runs are byte-identical by construction (proven end-to-end against the
reference binary in tests/test_engine_mesh.py + tests/test_pipeline_parity.py,
which run on an 8-virtual-device CPU mesh).

Sharding design (replaces the reference's pthread fan-out over a shared
read-only dictionary, src/IMSAME.c:414-462 + alignmentFunctions.h:4-6):

  * 'data' axis: flat candidate chunks and NW pair batches are sharded;
    sequence tables (packed rows, lengths, thresholds) are replicated --
    they are the small shared "model".
  * 'dict' axis: the sorted-index payload (pos, sid) -- the large array,
    ~8 bytes of index per db k-mer -- is sharded by contiguous row range.
    Bucket lookup happens on the host (bucket_start is host-resident), so
    device-side retrieval is a row gather.  Two step flavors: the
    broadcast step (make_engine_gate_step) sends every candidate to every
    dict shard, masks non-owned hits, and psum-unions the disjoint bits
    -- simple, but extension compute replicates K-fold; the ROUTED step
    (make_engine_gate_step_routed, the production path when n_dict > 1)
    has the host pre-sort each chunk by owning shard so each device gates
    only candidates it owns -- no mask, no psum, and extension compute
    scales with n_dict.  The axis therefore buys both index *capacity*
    (BASELINE config 3: ~1M-read samples) and gate throughput.

Candidate/pair batches divide evenly: gate chunks must be divisible by
(n_data * 32) and NW batches by (n_data * n_dict * 8); the engine
validates this at construction (pipeline.py _make_mesh).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map


def make_engine_gate_step(
    mesh: Mesh, window: int, shard_rows: int, packed_idx: bool
):
    """Sharded flat_gate_packed twin: candidates P(None, 'data'), index
    payload P('dict'), everything else replicated.  Returns packed
    pass/exact bits [2, N//32] (bit-identical to the single-device gate).
    ``packed_idx`` selects the one-word (sid<<12|doff) index table (see
    ops/candidates.gate_core)."""
    from ..ops.candidates import gate_core

    idx_spec = P("dict") if packed_idx else (P("dict"), P("dict"), P())

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P(), P(), P(), P(), idx_spec,
            P(None, "data"), P(),
        ),
        out_specs=P(None, "data"),
        check_vma=False,
    )
    def gate(qp, dp, qlen, dlen, idx_tab, cand, thr_tab):
        k = jax.lax.axis_index("dict")
        hit = cand[0] - k * shard_rows
        own = (hit >= 0) & (hit < shard_rows)
        hit = jnp.clip(hit, 0, shard_rows - 1)
        rq = cand[1].astype(jnp.uint32)
        r = (rq >> jnp.uint32(12)).astype(jnp.int32)
        qoff = (rq & jnp.uint32(0xFFF)).astype(jnp.int32)
        passes, exact = gate_core(
            qp, dp, qlen, dlen, idx_tab,
            r, hit, qoff, thr_tab[r], window=window, packed_idx=packed_idx,
        )
        stacked = jnp.stack([passes & own, exact & own])  # [2, N_local]
        N = stacked.shape[1]
        bits = stacked.reshape(2, N // 32, 32).astype(jnp.int32)
        weights = (
            jnp.int32(1) << jnp.arange(32, dtype=jnp.int32)
        )[None, None, :]
        words = jnp.sum(bits * weights, axis=2).astype(jnp.int32)
        return jax.lax.psum(words, "dict")  # disjoint bits: sum == union

    return jax.jit(gate)


def make_engine_gate_step_routed(
    mesh: Mesh, window: int, shard_rows: int, packed_idx: bool
):
    """Dict-ROUTED gate: the host pre-sorts each chunk so that segment
    s = d * n_dict + k of the flat candidate axis holds only candidates
    whose hit row lives on dict shard k (pipeline._gate_chunks_routed).
    Sharding the chunk over the flattened ('data', 'dict') axes then
    gives every device exclusively candidates it owns -- no ownership
    mask, no psum, and extension compute *scales* with n_dict instead of
    replicating K-fold (the capacity-only trade the row-range design
    otherwise makes, see module docstring)."""
    from ..ops.candidates import gate_core

    idx_spec = P("dict") if packed_idx else (P("dict"), P("dict"), P())

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P(), P(), P(), P(), idx_spec,
            P(None, ("data", "dict")), P(),
        ),
        out_specs=P(None, ("data", "dict")),
        check_vma=False,
    )
    def gate(qp, dp, qlen, dlen, idx_tab, cand, thr_tab):
        k = jax.lax.axis_index("dict")
        hit = cand[0] - k * shard_rows  # all local candidates are owned
        rq = cand[1].astype(jnp.uint32)
        r = (rq >> jnp.uint32(12)).astype(jnp.int32)
        qoff = (rq & jnp.uint32(0xFFF)).astype(jnp.int32)
        passes, exact = gate_core(
            qp, dp, qlen, dlen, idx_tab,
            r, hit, qoff, thr_tab[r], window=window, packed_idx=packed_idx,
        )
        stacked = jnp.stack([passes, exact])  # [2, N_local]
        N = stacked.shape[1]
        bits = stacked.reshape(2, N // 32, 32).astype(jnp.int32)
        weights = (
            jnp.int32(1) << jnp.arange(32, dtype=jnp.int32)
        )[None, None, :]
        return jnp.sum(bits * weights, axis=2).astype(jnp.int32)

    return jax.jit(gate)


def make_engine_gate_step_wide(
    mesh: Mesh, window: int, shard_rows: int, packed_idx: bool
):
    """Sharded flat_gate twin for the wide candidate format (>= 2^20-read
    queries, where read id and qoff cannot share one uint32): candidate
    vectors ride a [5, N] stack (hit, rid, qoff, thr, valid) sharded over
    'data'; the index payload is row-range sharded over 'dict' with
    psum-union retrieval, like the packed step."""
    from ..ops.candidates import gate_core

    idx_spec = P("dict") if packed_idx else (P("dict"), P("dict"), P())

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P(), P(), P(), P(), idx_spec,
            P(None, "data"),
        ),
        out_specs=P(None, "data"),
        check_vma=False,
    )
    def gate(qp, dp, qlen, dlen, idx_tab, cand):
        k = jax.lax.axis_index("dict")
        hit = cand[0] - k * shard_rows
        own = (hit >= 0) & (hit < shard_rows) & (cand[4] != 0)
        hit = jnp.clip(hit, 0, shard_rows - 1)
        passes, exact = gate_core(
            qp, dp, qlen, dlen, idx_tab,
            cand[1], hit, cand[2], cand[3],
            window=window, packed_idx=packed_idx,
        )
        stacked = jnp.stack([passes & own, exact & own])
        N = stacked.shape[1]
        bits = stacked.reshape(2, N // 32, 32).astype(jnp.int32)
        weights = (
            jnp.int32(1) << jnp.arange(32, dtype=jnp.int32)
        )[None, None, :]
        words = jnp.sum(bits * weights, axis=2).astype(jnp.int32)
        return jax.lax.psum(words, "dict")

    return jax.jit(gate)


def make_engine_nw_stats_step(mesh: Mesh, max_len: int):
    """Sharded nw_stats_rows twin: pair batch P(None, ('data', 'dict')),
    packed rows and gap scores replicated.  Returns stacked [3, B] stats."""
    from ..ops.resolve import nw_stats_rows

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(None, ("data", "dict")), P(), P(), P(), P()),
        out_specs=P(None, ("data", "dict")),
        check_vma=False,
    )
    def step(qp, dp, rs, qlen, dlen, igap, egap):
        return nw_stats_rows(
            qp, dp, rs, qlen, dlen, igap, egap,
            max_len=max_len,
        )

    @jax.jit
    def run(qp, dp, rs, qlen, dlen, igap, egap):
        return step(
            qp, dp, rs, qlen, dlen,
            jnp.asarray(igap, jnp.int32), jnp.asarray(egap, jnp.int32),
        )

    return run


def make_engine_nw_render_step(mesh: Mesh, max_len: int):
    """Sharded nw_traceback_rows twin for the render path."""
    from ..ops.resolve import ResolveNWResult, nw_traceback_rows

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P(), P(), P(None, ("data", "dict")), P(), P(), P(), P(),
        ),
        out_specs=ResolveNWResult(
            length=P(("data", "dict")),
            identities=P(("data", "dict")),
            ylen=P(("data", "dict")),
            n_steps=P(("data", "dict")),
            chain=P(("data", "dict"), None),
        ),
        check_vma=False,
    )
    def step(qp, dp, rs, qlen, dlen, igap, egap):
        return nw_traceback_rows(
            qp, dp, rs[0], rs[1], qlen, dlen, igap, egap,
            max_len=max_len,
        )

    @jax.jit
    def run(qp, dp, rs, qlen, dlen, igap, egap):
        return step(
            qp, dp, rs, qlen, dlen,
            jnp.asarray(igap, jnp.int32), jnp.asarray(egap, jnp.int32),
        )

    return run
