"""End-to-end parity of the batched engine vs the reference binary and
the oracle: identical accepted pairs and byte-identical -out report."""

import random
from pathlib import Path

import pytest

from imsame_tpu.config import Config
from imsame_tpu.io.fasta import read_fasta
from imsame_tpu.pipeline import TpuEngine
from util_synth import (
    make_pair,
    parse_reference_summary,
    reference_binaries,
    run_reference,
)


def _compare(tmp_path: Path, seed: int, cfg_kw=None, ref_extra=None, **pair_kw):
    ref = reference_binaries()
    if ref is None:
        pytest.skip("reference binaries unavailable")
    imsame, _ = ref
    rng = random.Random(seed)
    qp, dp = make_pair(tmp_path, rng, **pair_kw)
    ref_out = tmp_path / "ref.align"
    stdout = run_reference(imsame, qp, dp, ref_out, n_threads=1, extra=ref_extra or [])
    accepted_ref, n_q, n_db = parse_reference_summary(stdout)

    cfg = Config(**(cfg_kw or {}))
    q = read_fasta(str(qp))
    eng = TpuEngine(read_fasta(str(dp)), cfg)
    res = eng.compare(q)

    assert res.accepted == accepted_ref
    report = eng.render_report(q, res)
    assert report == ref_out.read_bytes()


def test_pipeline_parity_default(tmp_path):
    _compare(tmp_path, 21, n_query=40, n_db=40, read_len=150, sub_rate=0.05,
             indel_rate=0.02)


def test_pipeline_parity_heavy(tmp_path):
    _compare(tmp_path, 22, n_query=30, n_db=30, read_len=140, sub_rate=0.22,
             indel_rate=0.06)


def test_pipeline_parity_small_round(tmp_path):
    # tiny candidate windows force multi-round resolution
    _compare(
        tmp_path, 23,
        cfg_kw={"first_window": 4, "gate_chunks": (64, 32), "nw_stats_batches": (8,), "nw_render_batches": (8,)},
        n_query=25, n_db=25, read_len=150, sub_rate=0.08, indel_rate=0.03,
    )


def test_pipeline_parity_thresholds(tmp_path):
    _compare(
        tmp_path, 24,
        cfg_kw={"min_coverage": 0.3, "min_identity": 0.65, "igap": -3, "egap": -1},
        ref_extra=["-coverage", "0.3", "-identity", "0.65", "-igap", "3", "-egap", "1"],
        n_query=25, n_db=25, read_len=150, sub_rate=0.12, indel_rate=0.05,
    )


def test_pipeline_parity_varied_lengths(tmp_path):
    _compare(tmp_path, 25, n_query=30, n_db=30, read_len=120, sub_rate=0.06,
             indel_rate=0.12)


def test_pipeline_parity_render_overlap(tmp_path):
    """render_overlap=True dispatches wave-1 winners' render-NW inside
    compare; render_report must still produce byte-identical output
    (including a second render_report call on the same result)."""
    ref = reference_binaries()
    if ref is None:
        pytest.skip("reference binaries unavailable")
    imsame, _ = ref
    rng = random.Random(26)
    qp, dp = make_pair(tmp_path, rng, n_query=30, n_db=30, read_len=150,
                       sub_rate=0.06, indel_rate=0.03)
    ref_out = tmp_path / "ref.align"
    run_reference(imsame, qp, dp, ref_out, n_threads=1)
    q = read_fasta(str(qp))
    eng = TpuEngine(
        read_fasta(str(dp)),
        Config(render_overlap=True, mesh_shape=None),
    )
    res = eng.compare(q)
    assert res.early_render is not None and res.early_render[1]
    report = eng.render_report(q, res)
    assert report == ref_out.read_bytes()
    # early pending consumed; re-render must still be identical
    assert eng.render_report(q, res) == report
