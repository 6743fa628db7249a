"""Engine-integrated sharded steps on the 8-virtual-device CPU mesh:
each step must be bit-identical to the single-device op it wraps.
(End-to-end mesh parity incl. reports: tests/test_engine_mesh.py.)"""

import numpy as np
import jax
import jax.numpy as jnp

from imsame_tpu.ops.candidates import flat_gate_packed
from imsame_tpu.ops.resolve import nw_stats_rows, nw_traceback_rows
from imsame_tpu.parallel.mesh import make_mesh
from imsame_tpu.parallel.sharded import (
    make_engine_gate_step,
    make_engine_nw_stats_step,
    make_engine_nw_render_step,
)


def test_devices_available():
    assert len(jax.devices()) >= 8


def _tables(rng, n_reads=64, read_len=100, window=128, n_idx=512):
    from imsame_tpu.ops.extend_packed import pack_read_rows

    codes = rng.integers(0, 4, n_reads * read_len, dtype=np.uint8)
    start = np.arange(n_reads, dtype=np.int64) * read_len
    lens = np.full(n_reads, read_len, np.int64)
    qp = jnp.asarray(pack_read_rows(codes, start, lens, window))
    qlen = jnp.asarray(np.full(n_reads, read_len, np.int32))
    idx_sid = rng.integers(0, n_reads, n_idx).astype(np.int32)
    idx_off = rng.integers(12, read_len, n_idx).astype(np.int32)
    idx_pos = (start[idx_sid] + idx_off).astype(np.int32)
    db_start = start.astype(np.int32)
    return qp, qlen, idx_pos, idx_sid, db_start


def test_gate_step_matches_flat_gate():
    rng = np.random.default_rng(5)
    window, n_idx = 128, 512
    qp, qlen, idx_pos, idx_sid, db_start = _tables(rng, n_idx=n_idx)
    N = 512
    cand = np.zeros((2, N), np.int32)
    cand[0] = rng.integers(0, n_idx, N)
    cand[1] = ((rng.integers(0, 64, N) << 12) | rng.integers(12, 100, N))
    thr = jnp.asarray(np.full(64, 60, np.int32))

    idx_tab = (
        jnp.asarray(idx_pos), jnp.asarray(idx_sid), jnp.asarray(db_start)
    )
    want = flat_gate_packed(
        qp, qp, qlen, qlen, idx_tab, jnp.asarray(cand), thr,
        window=window, packed_idx=False,
    )
    # packed one-word payload must agree with the triple
    packed_tab = jnp.asarray(
        ((idx_sid.astype(np.uint32) << np.uint32(12))
         | (idx_pos - db_start[idx_sid]).astype(np.uint32)).view(np.int32)
    )
    got_p = flat_gate_packed(
        qp, qp, qlen, qlen, packed_tab, jnp.asarray(cand), thr,
        window=window, packed_idx=True,
    )
    np.testing.assert_array_equal(np.asarray(want), np.asarray(got_p))
    for n_data, n_dict in [(8, 1), (4, 2), (2, 4)]:
        mesh = make_mesh(n_data=n_data, n_dict=n_dict)
        shard_rows = n_idx // n_dict
        step = make_engine_gate_step(mesh, window, shard_rows, False)
        got = step(qp, qp, qlen, qlen, idx_tab, jnp.asarray(cand), thr)
        np.testing.assert_array_equal(np.asarray(want), np.asarray(got))
        step_p = make_engine_gate_step(mesh, window, shard_rows, True)
        got2 = step_p(qp, qp, qlen, qlen, packed_tab, jnp.asarray(cand), thr)
        np.testing.assert_array_equal(np.asarray(want), np.asarray(got2))


def test_nw_steps_match_single_device():
    rng = np.random.default_rng(6)
    window = 128
    qp, qlen, *_ = _tables(rng, window=window)
    B = 64
    rs = np.stack([
        rng.integers(0, 64, B).astype(np.int32),
        rng.integers(0, 64, B).astype(np.int32),
    ])
    want = nw_stats_rows(
        qp, qp, jnp.asarray(rs), qlen, qlen, -5, -2,
        max_len=window,
    )
    want_tb = nw_traceback_rows(
        qp, qp, jnp.asarray(rs[0]), jnp.asarray(rs[1]), qlen, qlen, -5, -2,
        max_len=window,
    )
    mesh = make_mesh(n_data=4, n_dict=2)
    stats = make_engine_nw_stats_step(mesh, window)(
        qp, qp, jnp.asarray(rs), qlen, qlen, -5, -2
    )
    np.testing.assert_array_equal(np.asarray(want), np.asarray(stats))
    render = make_engine_nw_render_step(mesh, window)(
        qp, qp, jnp.asarray(rs), qlen, qlen, -5, -2
    )
    for a, b in zip(want_tb, render):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
