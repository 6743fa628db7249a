"""Long-read envelope: the reference aligns reads up to MAX_READ_SIZE=3000
(/root/reference/src/structs.h:19, guard src/alignmentFunctions.c:155) and
allocates its 3000^2 tables up front (src/IMSAME.c:85-95).  These tests
exercise every length bucket in config.length_buckets past the 128/256
pair already covered elsewhere:

  * oracle parity of the jnp stats aligner at the 512 bucket,
  * jnp stats vs jnp forward+traceback bit-equality at 512..3072,
  * the render ladder's per-L bp-tensor cap,
  * end-to-end byte parity vs the reference binary with reads spanning
    ~300..3000 bp, including the exact 3000 bp boundary, and the abort
    above it.
"""

import random

import numpy as np
import jax.numpy as jnp
import pytest

from imsame_tpu.config import Config
from imsame_tpu.constants import MAX_READ_SIZE
from imsame_tpu.io.fasta import read_fasta
from imsame_tpu.io.report import render_alignment
from imsame_tpu.ops.nw import nw_forward_batch, nw_stats_batch
from imsame_tpu.ops.traceback import traceback_batch
from imsame_tpu.pipeline import TpuEngine
from util_synth import (
    mutate,
    parse_reference_summary,
    random_read,
    reference_binaries,
    run_reference,
    write_fasta,
)


def _long_pairs(rng, B, L, lo_frac=0.6):
    """Mutated-copy and random pairs with lengths in [lo_frac*L, L]."""
    lo = max(16, int(L * lo_frac))
    xlen = rng.integers(lo, L + 1, B).astype(np.int32)
    ylen = rng.integers(lo, L + 1, B).astype(np.int32)
    X = rng.integers(0, 4, (B, L)).astype(np.uint8)
    Y = rng.integers(0, 4, (B, L)).astype(np.uint8)
    for b in range(B // 2):
        ylen[b] = xlen[b]
        Y[b] = X[b].copy()
        mut = rng.random(L) < 0.06
        Y[b][mut] = (Y[b][mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        if b % 2 == 0:  # force gap moves with a suffix shift
            cut = int(rng.integers(8, max(9, xlen[b] - 8)))
            Y[b][cut:] = np.roll(Y[b][cut:], int(rng.integers(1, 5)))
    return X, Y, xlen, ylen


def test_oracle_parity_L512():
    """jnp stats aligner vs the scalar oracle at the 512 bucket (the
    oracle is a python double loop; larger buckets use the reference
    binary as the oracle in the e2e test below)."""
    from imsame_tpu.oracle.nw import backtrack_faithful, nw_faithful

    rng = np.random.default_rng(3)
    L, B = 512, 4
    X, Y, xlen, ylen = _long_pairs(rng, B, L, lo_frac=0.9)
    st = nw_stats_batch(
        jnp.asarray(X), jnp.asarray(Y), jnp.asarray(xlen), jnp.asarray(ylen),
        -5, -2, max_len=L,
    )
    for b in range(B):
        xs = X[b, : xlen[b]]
        ys = Y[b, : ylen[b]]
        table, frm, best = nw_faithful(xs, ys, -5, -2)
        assert int(st.best_score[b]) == best.score
        assert int(st.best_i[b]) == best.xpos
        assert int(st.best_j[b]) == best.ypos
        chars = np.frombuffer(b"ACGT", np.uint8)
        rec_x, rec_y, hx, hy, ba, ml = backtrack_faithful(
            xs, ys, frm, best, chars[xs], chars[ys]
        )
        assert int(st.length[b]) == ba.length
        # identities are counted at render time, as in the reference
        _, idents = render_alignment(rec_x, rec_y, hx, hy, ml)
        assert int(st.identities[b]) == idents


@pytest.mark.parametrize("L,B", [(512, 16), (1024, 8), (2048, 8), (3072, 8)])
def test_stats_matches_traceback_long(L, B):
    """Stats aligner == forward+traceback at every untested bucket."""
    rng = np.random.default_rng(L)
    X, Y, xlen, ylen = _long_pairs(rng, B, L)
    jX, jY = jnp.asarray(X), jnp.asarray(Y)
    jxl, jyl = jnp.asarray(xlen), jnp.asarray(ylen)
    res = nw_forward_batch(jX, jY, jxl, jyl, -5, -2, max_len=L)
    tb = traceback_batch(res.bp, res.best_i, res.best_j, jX, jY, max_len=L)
    st = nw_stats_batch(jX, jY, jxl, jyl, -5, -2, max_len=L)
    np.testing.assert_array_equal(
        np.asarray(st.best_score), np.asarray(res.best_score)
    )
    np.testing.assert_array_equal(np.asarray(st.best_i), np.asarray(res.best_i))
    np.testing.assert_array_equal(np.asarray(st.best_j), np.asarray(res.best_j))
    np.testing.assert_array_equal(np.asarray(st.length), np.asarray(tb.length))
    np.testing.assert_array_equal(
        np.asarray(st.identities), np.asarray(tb.identities)
    )


def test_render_ladder_caps_bp_tensor():
    """The render ladder must keep B * 8L^2 under the configured budget
    for every length bucket (256 pairs at 3072 would be ~19 GB)."""
    db = _tiny_seqinfo()
    eng = TpuEngine(db, Config(mesh_shape=None))
    budget = eng.cfg.nw_render_bp_budget
    for L in eng.cfg.length_buckets:
        sizes = eng._render_sizes(L)
        assert sizes, L
        assert all(b % 8 == 0 for b in sizes)
        assert sizes[0] * 8 * L * L <= max(budget, 8 * 8 * L * L), (
            L, sizes
        )
        # ladder is descending and ends at the minimum batch
        assert list(sizes) == sorted(sizes, reverse=True)


def _tiny_seqinfo():
    from imsame_tpu.io.fasta import SeqInfo

    codes = np.zeros(32, np.uint8)
    start = np.array([0], np.int64)
    fresh = np.zeros(32, bool)
    fresh[0] = True
    return SeqInfo(codes=codes, start=start, fresh=fresh, headers=[b"x"])


def _make_long_pair(tmp_path, rng):
    """Reads spanning the full envelope, incl. the exact 3000 bp cap."""
    lens = [300, 700, 1500, 2600, 3000, 450]
    q = [random_read(rng, n) for n in lens]
    db = [mutate(rng, q[i], 0.04, 0.01) for i in (0, 2, 3, 4)]
    db += [random_read(rng, 2000), random_read(rng, 3000)]
    qp, dp = tmp_path / "q.fa", tmp_path / "db.fa"
    write_fasta(qp, q, "q")
    write_fasta(dp, db, "d")
    return qp, dp


def test_pipeline_parity_long_reads(tmp_path):
    """End-to-end byte parity vs the reference binary at the reference's
    full read-length envelope (~300..3000 bp)."""
    ref = reference_binaries()
    if ref is None:
        pytest.skip("reference binaries unavailable")
    imsame, _ = ref
    rng = random.Random(77)
    qp, dp = _make_long_pair(tmp_path, rng)
    ref_out = tmp_path / "ref.align"
    stdout = run_reference(imsame, qp, dp, ref_out, n_threads=1)
    accepted_ref, _, _ = parse_reference_summary(stdout)
    assert accepted_ref >= 3  # the mutated copies must align

    cfg = Config(
        nw_stats_batches=(8,),
        # tiny budget: exercises the per-L cap logic and keeps the CPU
        # test's bp tensor small (8 pairs at 3072 is still ~600 MB)
        nw_render_bp_budget=64 << 20,
        mesh_shape=None,
    )
    q = read_fasta(str(qp))
    eng = TpuEngine(read_fasta(str(dp)), cfg)
    res = eng.compare(q)
    assert res.accepted == accepted_ref
    report = eng.render_report(q, res)
    assert report == ref_out.read_bytes()


def test_read_above_cap_aborts(tmp_path):
    """Reads longer than MAX_READ_SIZE abort with the reference's error
    once they reach the gapped aligner (src/alignmentFunctions.c:155)."""
    rng = random.Random(5)
    base = random_read(rng, MAX_READ_SIZE + 40)
    write_fasta(tmp_path / "q.fa", [base], "q")
    write_fasta(tmp_path / "db.fa", [base], "d")
    q = read_fasta(str(tmp_path / "q.fa"))
    eng = TpuEngine(read_fasta(str(tmp_path / "db.fa")), Config(mesh_shape=None))
    with pytest.raises(ValueError, match="Read size reached"):
        eng.compare(q)
