"""Smoke run of the engine's main path on one NVIDIA GPU.

    python chip_smoke.py                # one card, every phase
    python chip_smoke.py --four-cards   # sharded engine on four cards only

Phases (each fatal: no phase catches its own failure, and nothing falls
back to the CPU or to another kernel):

  1. Device: JAX's first device must be a GPU; the card's name and power
     limit are printed as nvidia-smi reports them.
  2. Kernel parity: the GPU stats kernel (ops/cuda/nw_stats.cu) against
     the plain nw_stats_batch over whole production batches at every
     length bucket, real and edge lengths (2, L-1, L) mixed; then the
     path against the scalar oracle (oracle/nw.py) on a few pairs per
     bucket; then the ``gpu``-marked tests.  Every device op of the NW
     path is int32/uint32/uint8 arithmetic (no floating point, so no
     TF32 or summation order), and the e-value and the accept thresholds
     are float64 on the host: the tolerance is exact equality.
  3. 100k x 100k, 250 bp (bench.synth_pair seed 12345: half the db reads
     are 4%-mutated query copies): index build -> compare -> compare ->
     render.  ``accepted`` must be 50,110, the count the reference binary
     gave on this input.  The scalar OracleEngine then runs 320 contiguous
     query reads (reads 1000..1319, among those with a planted partner)
     against the whole database; its records must equal the engine's byte
     for byte.  The slice's first and last reads are left out: a slice
     starts a fresh k-mer stream at its first read and ends its last
     read's stream one base later than the whole sample does
     (oracle/engine.py).
  4. Long reads: 512 reads of 300..3000 bp (bench.longread_samples, seed
     4242) through the CLI on FASTA files; the report's sha256 must equal
     LONGREAD_SHA256, pinned from a CPU run of the same code.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent

# sha256 of the long-read report (phase 4), produced on the CPU with
#   JAX_PLATFORMS=cpu python -c "import chip_smoke as c; \
#       print(c.longread_report_sha256())"
LONGREAD_SHA256 = (
    "80e63da61e10b3c35b1f7aa510d4e5d8add261c2edb767df37c04f432b43ee3a"
)
EXPECTED_100K_ACCEPTED = 50_110
ORACLE_SLICE = (1000, 1320)  # query reads [lo, hi) checked by the oracle


def card_line() -> str:
    """name, power.limit of every visible card, as nvidia-smi gives them."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip()


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({
        "ok": True,
        "device": {
            "platform": d.platform,
            "kind": d.device_kind,
            "count": len(devices),
        },
    })


def log(msg: str) -> None:
    print(msg, flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(ok, msg="check failed") -> None:
    """Fail the run (unlike assert, not removed under python -O)."""
    if not ok:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------- phase 2
def _mixed_pairs(rng, B: int, L: int):
    """Mutated copies (a third with a shifted suffix, forcing gap moves)
    and random pairs; lengths uniform in [2, L] plus the edges 2, L-1, L
    in both positions."""
    xlen = rng.integers(2, L + 1, B).astype(np.int32)
    ylen = rng.integers(2, L + 1, B).astype(np.int32)
    X = rng.integers(0, 4, (B, L), dtype=np.uint8)
    Y = rng.integers(0, 4, (B, L), dtype=np.uint8)
    h = B // 2
    ylen[:h] = xlen[:h]
    Y[:h] = X[:h]
    mut = rng.random((h, L)) < 0.06
    Y[:h][mut] = (Y[:h][mut] + rng.integers(1, 4, int(mut.sum()))) % 4
    for b in range(0, h, 3):
        cut = int(rng.integers(1, max(2, xlen[b] - 1)))
        Y[b, cut:] = np.roll(Y[b, cut:], int(rng.integers(1, 4)))
    edges = [(L, L), (L - 1, L - 1), (2, L), (L, 2), (L - 1, 2), (2, 2)]
    for k, (a, b) in enumerate(edges, start=1):
        xlen[-k], ylen[-k] = a, b
    return X, Y, xlen, ylen


# (length bucket, pairs): production stats-ladder sizes, as large as
# the plain path can check in seconds at each bucket
PARITY_BATCHES = [
    (128, 32768), (256, 32768), (512, 8192), (1024, 2048), (2048, 512),
    (3072, 256),
]


def _oracle_pairs(L: int):
    """(xlen, ylen) checked against the scalar oracle at bucket L: edge
    lengths everywhere, full-size pairs where the Python loop is quick."""
    pairs = [(L, 40), (40, L), (L - 1, 2), (2, L)]
    if L <= 256:
        pairs += [(L, L), (L - 1, L)]
    return pairs


def phase_kernel_parity() -> None:
    import jax
    import jax.numpy as jnp
    import pytest

    from imsame_tpu.io.report import render_alignment
    from imsame_tpu.ops import nw_cuda
    from imsame_tpu.ops.nw import nw_stats_batch
    from imsame_tpu.ops.resolve import select_stats_kernel
    from imsame_tpu.oracle.nw import backtrack_faithful, nw_faithful

    check(select_stats_kernel(jax.default_backend()) is (
        nw_cuda.nw_stats_batch_cuda
    ), "the GPU path must run the CUDA kernel")
    chars = np.frombuffer(b"ACGT", np.uint8)
    for L, B in PARITY_BATCHES:
        rng = np.random.default_rng(L)
        X, Y, xl, yl = _mixed_pairs(rng, B, L)
        args = [jnp.asarray(a) for a in (X, Y, xl, yl)]
        want = nw_stats_batch(*args, -5, -2, max_len=L)
        got = nw_cuda.nw_stats_batch_cuda(*args, -5, -2, max_len=L)
        for f in want._fields:
            a = np.asarray(getattr(got, f))
            b = np.asarray(getattr(want, f))
            bad = int(np.sum(a != b))
            check(bad == 0, f"L={L} B={B}: {f} differs in {bad} pairs")
        # the path against the scalar oracle on a few pairs
        pairs = _oracle_pairs(L)
        Xo = rng.integers(0, 4, (len(pairs), L), dtype=np.uint8)
        Yo = Xo.copy()
        mut = rng.random(Yo.shape) < 0.05
        Yo[mut] = (Yo[mut] + 1) % 4
        xo = np.array([p[0] for p in pairs], np.int32)
        yo = np.array([p[1] for p in pairs], np.int32)
        st = nw_cuda.nw_stats_batch_cuda(
            jnp.asarray(Xo), jnp.asarray(Yo), jnp.asarray(xo),
            jnp.asarray(yo), -5, -2, max_len=L,
        )
        for k, (a, b) in enumerate(pairs):
            xs, ys = Xo[k, :a], Yo[k, :b]
            _, frm, best = nw_faithful(xs, ys, -5, -2)
            rx, ry, hx, hy, ba, ml = backtrack_faithful(
                xs, ys, frm, best, chars[xs], chars[ys]
            )
            _, idents = render_alignment(rx, ry, hx, hy, ml)
            want_k = (best.score, best.xpos, best.ypos, ba.length, idents)
            got_k = tuple(int(np.asarray(v)[k]) for v in st)
            check(got_k == want_k, f"L={L} pair {a}x{b}: {got_k} != {want_k}")
        log(f"[phase 2] L={L}: kernel == nw_stats_batch over {B} pairs, "
            f"== oracle on {len(pairs)} pairs")
    os.environ["IMSAME_TEST_GPU"] = "1"
    rc = pytest.main([
        "-q", "-m", "gpu", "-p", "no:cacheprovider",
        str(HERE / "tests" / "test_nw_cuda.py"),
    ])
    check(rc == 0, f"gpu-marked tests failed (pytest exit {rc})")


# ---------------------------------------------------------------- phase 3
def _records(report: bytes, offset: int = 0) -> dict:
    """Report -> {query read: record bytes}, read ids shifted by offset."""
    out = {}
    for rec in re.split(rb"(?m)^(?=\(\d+, \d+\) : )", report):
        if not rec:
            continue
        m = re.match(rb"\((\d+), ", rec)
        qread = int(m.group(1)) + offset
        out[qread] = b"(%d, " % qread + rec[m.end():]
    return out


def run_100k(mesh_shape=None, n: int = 100_000) -> tuple:
    """Index -> compare (compile) -> compare -> render on the 100k pair
    (n reads a side); returns (query, db, engine, result, report, walls)."""
    import bench
    from imsame_tpu.config import Config
    from imsame_tpu.pipeline import TpuEngine

    qc, dbc = bench.synth_pair(n, 250, 0.5, seed=12345)
    q = bench.codes_to_seqinfo(qc)
    db = bench.codes_to_seqinfo(dbc)
    walls = {}
    t0 = time.perf_counter()
    eng = TpuEngine(db, Config(mesh_shape=mesh_shape))
    walls["index_s"] = time.perf_counter() - t0
    for k in ("compare1_s", "compare2_s"):
        t0 = time.perf_counter()
        res = eng.compare(q)
        walls[k] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report = eng.render_report(q, res)
    walls["render_s"] = time.perf_counter() - t0
    return q, db, eng, res, report, walls


def phase_100k() -> None:
    from imsame_tpu.config import Config
    from imsame_tpu.oracle.engine import OracleEngine

    q, db, eng, res, report, walls = run_100k(mesh_shape=None)
    log("[phase 3] 100k walls (compare1 includes compiles): "
        + json.dumps({k: round(v, 3) for k, v in walls.items()})
        + f" accepted={res.accepted}")
    check(res.accepted == EXPECTED_100K_ACCEPTED, res.accepted)
    lo, hi = ORACLE_SLICE
    t0 = time.perf_counter()
    want = OracleEngine(db, Config()).compare(q.slice_reads(lo, hi))
    got = _records(report)
    ref = _records(want.out_bytes, offset=lo)
    reads = range(lo + 1, hi - 1)
    got_s = {r: got[r] for r in reads if r in got}
    ref_s = {r: ref[r] for r in reads if r in ref}
    check(got_s.keys() == ref_s.keys(), "accepted reads differ from oracle")
    bad = [r for r in got_s if got_s[r] != ref_s[r]]
    check(not bad, f"records differ from the oracle for reads {bad[:5]}")
    check(len(ref_s) > len(reads) // 3, "oracle slice accepted too few")
    log(f"[phase 3] oracle slice: {len(ref_s)} accepted of "
        f"{len(reads)} reads byte-equal ({time.perf_counter() - t0:.1f} s)")


# ---------------------------------------------------------------- phase 4
def longread_report_sha256(workdir: str = None) -> str:
    """Run the CLI on the long-read samples; sha256 of its report."""
    import bench
    from imsame_tpu import cli

    with tempfile.TemporaryDirectory(dir=workdir) as td:
        qp, dp = bench.longread_samples(Path(td))
        out = Path(td) / "out.align"
        rc = cli.main(["-query", str(qp), "-db", str(dp), "-out", str(out)])
        check(rc == 0, f"CLI exit {rc}")
        return hashlib.sha256(out.read_bytes()).hexdigest()


def phase_longreads() -> None:
    t0 = time.perf_counter()
    digest = longread_report_sha256()
    log(f"[phase 4] long-read report sha256 {digest} "
        f"({time.perf_counter() - t0:.1f} s)")
    check(digest == LONGREAD_SHA256, "long-read report differs from the pin")


# ---------------------------------------------------------------- 4 cards
def phase_four_cards(n: int = 100_000) -> None:
    """The 100k pair on one card, then on four: data=4 ('auto') and the
    (2, 2) mesh (dict-sharded index, routed gate).  Reports must be equal."""
    import jax

    check(len(jax.devices()) == 4, "needs four cards")
    runs = {}
    for name, shape in (("1", None), ("auto", "auto"), ("2x2", (2, 2))):
        _, _, eng, res, report, walls = run_100k(mesh_shape=shape, n=n)
        mesh = None if eng._mesh is None else dict(eng._mesh.shape)
        log(f"[four cards] mesh={mesh} accepted={res.accepted} "
            f"report_bytes={len(report)} "
            + json.dumps({k: round(v, 3) for k, v in walls.items()}))
        runs[name] = report
        if shape == "auto":
            check(dict(eng._mesh.shape) == {"data": 4, "dict": 1})
        if n == 100_000:
            check(res.accepted == EXPECTED_100K_ACCEPTED, res.accepted)
    check(runs["auto"] == runs["1"], "data=4 report differs from one card")
    check(runs["2x2"] == runs["1"], "(2, 2) report differs from one card")
    log("[four cards] reports byte-equal to the one-card run")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded engine on four cards")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devices[0].platform})",
              file=sys.stderr)
        return 2
    log(card_line())
    if args.four_cards:
        phase_four_cards()
        print(result_line(devices), flush=True)
        return 0
    devices = devices[:1]  # the one-card phases pin the first card
    phase_kernel_parity()
    phase_100k()
    phase_longreads()
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
