"""Batched engine vs the scalar oracle (imsame_tpu/oracle/engine.py), with
no reference binary needed: the same query and database must give the
same report bytes, accepted count and Jaccard index on every path the
engine can take -- packed and wide index formats, a sharded mesh, long
reads, non-default thresholds and gap scores, an n_threads split and a
reverse-complemented database (the all-vs-all sweep's second run)."""

import random

import pytest

from imsame_tpu import pipeline
from imsame_tpu.config import Config
from imsame_tpu.io.fasta import parse_fasta_bytes, revcomp_fasta_bytes
from imsame_tpu.oracle.engine import OracleEngine
from imsame_tpu.pipeline import TpuEngine
from util_synth import make_pair, mutate, random_read, write_fasta


def _short_pair(tmp_path, seed, n=24, read_len=120, indel_rate=0.01):
    qp, dp = make_pair(
        tmp_path, random.Random(seed), n_query=n, n_db=n,
        read_len=read_len, sub_rate=0.05, indel_rate=indel_rate,
    )
    return qp.read_bytes(), dp.read_bytes()


def _long_pair(tmp_path, seed):
    rng = random.Random(seed)
    q = [random_read(rng, n) for n in (300, 760, 1000, 520)]
    db = [mutate(rng, q[i], 0.04, 0.01) for i in (0, 2)]
    db += [random_read(rng, 900), random_read(rng, 400)]
    write_fasta(tmp_path / "q.fa", q, "q")
    write_fasta(tmp_path / "db.fa", db, "d")
    return (tmp_path / "q.fa").read_bytes(), (tmp_path / "db.fa").read_bytes()


def _revcomp_pair(tmp_path, seed):
    """Both samples reverse-complemented (and so in reverse read order)."""
    q_bytes, db_bytes = _short_pair(tmp_path, seed)
    return revcomp_fasta_bytes(q_bytes), revcomp_fasta_bytes(db_bytes)


CASES = {
    # name: (pair builder, Config overrides, wide formats)
    "packed": (_short_pair, {}, False),
    "wide": (_short_pair, {}, True),
    "mesh_4x2": (_short_pair, {"mesh_shape": (4, 2)}, False),
    "long_reads": (
        _long_pair,
        {"nw_stats_batches": (8,), "nw_render_bp_budget": 64 << 20},
        False,
    ),
    "thresholds": (
        _short_pair,
        {"min_e_value": 1e-30, "min_coverage": 0.8, "min_identity": 0.85,
         "igap": -3, "egap": -1},
        False,
    ),
    "n_threads_3": (_short_pair, {"n_threads": 3}, False),
    "revcomp": (_revcomp_pair, {}, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_matches_oracle(tmp_path, monkeypatch, case):
    build, overrides, wide = CASES[case]
    q_bytes, db_bytes = build(tmp_path, seed=sorted(CASES).index(case) + 40)
    if wide:
        # force the wide index payload and the wide candidate format
        monkeypatch.setattr(pipeline, "PACKED_MAX_READS", 0)
    cfg = {"mesh_shape": None, **overrides}
    q = parse_fasta_bytes(q_bytes)
    db = parse_fasta_bytes(db_bytes)

    want = OracleEngine(db, Config(**cfg)).compare(q)
    eng = TpuEngine(db, Config(**cfg))
    assert eng._packed_idx is not wide
    got = eng.compare(q)
    report = eng.render_report(q, got)

    assert want.accepted > 0
    assert got.accepted == want.accepted
    assert got.jaccard == want.jaccard
    assert sorted(got.pairs) == sorted(want.pairs)
    # the oracle's threads cover contiguous read ranges in order, so its
    # record order is read order, which is the engine's report order
    assert report == want.out_bytes
