"""Benchmark: alignment-phase throughput on the BASELINE.md workload.

Runs on an NVIDIA GPU only (it exits non-zero on any other backend) and
prints the card's name and power limit first.

Workload (mirrors the measured reference baseline): 20k query reads x 20k
database reads, 250 bp, 50% of db reads are ~4%-mutated copies of query
reads, default thresholds.  The reference C binary sustains ~2.7k query
reads/s on this workload (BASELINE.md); vs_baseline is reads/s divided by
that.

Prints the FULL payload JSON line first, then a COMPACT summary JSON line
LAST (the driver archives a bounded tail of stdout, so every headline
number -- reads/s, kernel GCUPS, sweep, 100k block, long-read block,
parity -- must fit in the final line):
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N, ...}

Set IMSAME_BENCH_READS to scale the workload (default 20000).
Set IMSAME_BENCH_PARITY=1 to additionally run the compiled reference binary
on the same workload (written out as FASTA) and byte-compare the reports --
the SURVEY.md section 4.1 check at bench scale; adds "parity" to the JSON.
"""

import json
import os
import random as _random
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

BASELINE_READS_PER_S = 2700.0


def synth_pair(n: int, read_len: int, match_frac: float, seed: int):
    """Synthetic query/db code batches (uint8 0..3), BASELINE workload."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (n, read_len), dtype=np.uint8)
    nm = int(n * match_frac)
    db = q[:nm].copy()
    mask = rng.random((nm, read_len)) < 0.04
    db[mask] = (db[mask] + rng.integers(1, 4, int(mask.sum()), dtype=np.uint8)) % 4
    db = np.concatenate(
        [db, rng.integers(0, 4, (n - nm, read_len), dtype=np.uint8)]
    )
    perm = rng.permutation(n)
    return q, db[perm]


def codes_to_seqinfo(reads: np.ndarray):
    from imsame_tpu.io.fasta import SeqInfo

    n, L = reads.shape
    codes = reads.reshape(-1).copy()
    start = (np.arange(n, dtype=np.int64) * L)
    fresh = np.zeros(n * L, bool)
    fresh[start] = True
    return SeqInfo(codes=codes, start=start, fresh=fresh, headers=[b""] * n)


def check_parity(eng, q, res, qc, dbc) -> str:
    """Write the bench workload as FASTA, run the compiled reference binary
    on it, and byte-compare reports (n_threads=1 on both sides, so record
    order is deterministic).  Returns 'byte-identical' or raises."""
    sys.path.insert(0, str(Path(__file__).parent / "tests"))
    from util_synth import (
        parse_reference_summary,
        reference_binaries,
        run_reference,
    )

    ref = reference_binaries()
    if ref is None:
        return "reference unavailable"
    chars = np.frombuffer(b"ACGT", np.uint8)
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        for name, mat in (("q.fa", qc), ("db.fa", dbc)):
            with open(td / name, "wb") as f:
                for i in range(mat.shape[0]):
                    f.write(b">r%d\n" % i)
                    f.write(chars[mat[i]].tobytes())
                    f.write(b"\n")
        ref_out = td / "ref.align"
        stdout = run_reference(
            ref[0], td / "q.fa", td / "db.fa", ref_out, n_threads=1
        )
        accepted_ref, _, _ = parse_reference_summary(stdout)
        assert res.accepted == accepted_ref, (
            f"accepted mismatch: engine {res.accepted} vs "
            f"reference {accepted_ref}"
        )
        report = eng.render_report(q, res)
        assert report == ref_out.read_bytes(), "report bytes differ"
    return "byte-identical"


def sweep_bench(base: np.ndarray) -> dict:
    """All-vs-all sample-pairs/hour (the reference driver's unit of work:
    one unordered sample pair = forward + revcomp runs,
    bin/all_vs_all_metagenomes_IMSAME.sh:27-58).  Four 20k-read samples
    sharing ~half their content run through the production orchestrator
    (engine LRU + per-sample index cache + report rendering); read
    shapes match the warmed compare, so this measures steady-state
    sweep throughput, not compiles."""
    from imsame_tpu.orchestrator import AllVsAllRunner, list_samples

    chars = np.frombuffer(b"ACGT", np.uint8)
    rng = np.random.default_rng(777)
    n, L = base.shape
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        sdir = td / "samples"
        sdir.mkdir()
        for s in range(4):
            if s == 0:
                mat = base
            else:
                nm = n // 2
                mut = base[:nm].copy()
                mask = rng.random(mut.shape) < 0.04
                mut[mask] = (
                    mut[mask]
                    + rng.integers(1, 4, int(mask.sum()), dtype=np.uint8)
                ) % 4
                mat = np.concatenate(
                    [mut, rng.integers(0, 4, (n - nm, L), dtype=np.uint8)]
                )
                mat = mat[rng.permutation(n)]
            with open(sdir / f"s{s}.fasta", "wb") as f:
                for i in range(n):
                    f.write(b">r%d\n" % i)
                    f.write(chars[mat[i]].tobytes())
                    f.write(b"\n")
        samples = list_samples(str(sdir), "fasta")
        # full passes with independent runners/outdirs (engines and
        # index caches cold each pass); the best one is reported
        walls = []
        n_jobs = 0
        for p in range(int(os.environ.get("IMSAME_BENCH_SWEEP_RUNS", "2"))):
            runner = AllVsAllRunner(str(td / f"out{p}"))
            t0 = time.perf_counter()
            stats = runner.run(samples)
            walls.append(round(time.perf_counter() - t0, 2))
            n_jobs = len(stats)
        dt = min(walls)
        n_pairs = len(samples) * (len(samples) - 1) // 2
        return {
            "metric": "all-vs-all sample pairs/hour "
            "(4 x 20k-read samples, fwd+rev, reports written)",
            "pairs": n_pairs,
            "jobs": n_jobs,
            "wall_seconds": dt,
            "wall_seconds_runs": walls,
            "pairs_per_hour": round(3600.0 * n_pairs / dt, 1),
        }


def kernel_gcups_at(L: int, B: int, read_len: int, reps: int = 5) -> float:
    """GCUPS of the accept-gate stats aligner the engine runs on this
    backend (ops/resolve.py select_stats_kernel) at length bucket L, on
    resident random code matrices with every read read_len long."""
    import functools

    import jax
    import jax.numpy as jnp

    from imsame_tpu.ops.resolve import select_stats_kernel

    fn = jax.jit(functools.partial(
        select_stats_kernel(jax.default_backend()), max_len=L
    ))
    rng = np.random.default_rng(L)
    X = jnp.asarray(rng.integers(0, 4, (B, L)).astype(np.uint8))
    Y = jnp.asarray(rng.integers(0, 4, (B, L)).astype(np.uint8))
    lens = jnp.full(B, read_len, jnp.int32)
    args = (X, Y, lens, lens, jnp.int32(-5), jnp.int32(-2))
    jax.block_until_ready(fn(*args))  # compile
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps
    return round(B * read_len * read_len / dt / 1e9, 2)


def longread_samples(td: Path) -> tuple:
    """The long-read pair as FASTA files in td: 512 query reads of
    300..3000 bp (the reference's MAX_READ_SIZE envelope), half of them
    mutated (4% substitutions, 1% indels) into the database, seed 4242.
    Returns (query path, db path)."""
    sys.path.insert(0, str(Path(__file__).parent / "tests"))
    from util_synth import mutate, random_read, write_fasta

    rng = _random.Random(4242)
    nq = 512
    q_reads = [random_read(rng, rng.randint(300, 3000)) for _ in range(nq)]
    db_reads = [
        mutate(rng, q_reads[i], 0.04, 0.01)
        if i % 2 == 0
        else random_read(rng, rng.randint(300, 3000))
        for i in range(nq)
    ]
    rng.shuffle(db_reads)
    write_fasta(td / "q.fa", q_reads, "q")
    write_fasta(td / "db.fa", db_reads, "d")
    return td / "q.fa", td / "db.fa"


def longread_bench() -> dict:
    """Long-read envelope: an end-to-end compare (+ byte-parity check
    when the reference binary is available) with reads spanning
    ~300..3000 bp (the reference's MAX_READ_SIZE envelope,
    src/structs.h:19), and stats-kernel GCUPS at every long length
    bucket."""
    sys.path.insert(0, str(Path(__file__).parent / "tests"))
    from util_synth import (
        parse_reference_summary,
        reference_binaries,
        run_reference,
    )

    from imsame_tpu.config import Config
    from imsame_tpu.io.fasta import read_fasta
    from imsame_tpu.pipeline import TpuEngine

    out = {
        "metric": "long-read envelope (512 reads, 300..3000 bp)",
        "n_reads": 512,
    }
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        qp, dp = longread_samples(td)
        q = read_fasta(str(qp))
        db = read_fasta(str(dp))
        eng = TpuEngine(db, Config())
        eng.render_report(q, eng.compare(q))  # warm long-bucket compiles
        runs = []
        for _ in range(2):
            t0 = time.perf_counter()
            res = eng.compare(q)
            runs.append(round(time.perf_counter() - t0, 3))
        t_r = time.perf_counter()
        report = eng.render_report(q, res)
        out["align_seconds_runs"] = sorted(runs)
        out["render_seconds"] = round(time.perf_counter() - t_r, 3)
        out["accepted"] = res.accepted
        out["nw_cells"] = res.nw_cells
        out["gcups_align"] = round(res.nw_cells / min(runs) / 1e9, 2)
        ref = reference_binaries()
        if ref is not None:
            ref_out = td / "ref.align"
            stdout = run_reference(
                ref[0], qp, dp, ref_out, n_threads=1
            )
            accepted_ref, _, _ = parse_reference_summary(stdout)
            assert res.accepted == accepted_ref, (
                res.accepted, accepted_ref
            )
            out["parity"] = (
                "byte-identical"
                if report == ref_out.read_bytes()
                else "MISMATCH"
            )
    out["kernel_gcups_by_bucket"] = {
        str(L): kernel_gcups_at(L, B=1024 if L >= 2048 else 2048,
                                read_len=min(L - 2, int(L * 0.98)))
        for L in (512, 1024, 2048, 3072)
    }
    return out


# Reference end-to-end wall at the 100k x 100k workload on the CPU (4
# threads, gcc -O3, same synthetic generator; BASELINE.md "100k x 100k"
# section).  Re-measuring it would cost ~73 CPU-seconds per bench run, so
# the constant is pinned here with its provenance instead.
REFERENCE_100K_WALL_S = 73.2


def large_bench(**cfg_kwargs) -> dict:
    """Second timed config: 100k x 100k reads (BASELINE config-2 scale),
    end-to-end through a fresh engine (parse-free synthetic SeqInfo ->
    index build -> compare -> render), single timed run.  The accepted
    count is deterministic for the fixed seed (50,110, the reference
    binary's count on this input), so it doubles as a correctness check
    without paying a 73 s reference run."""
    from imsame_tpu.config import Config
    from imsame_tpu.pipeline import TpuEngine

    n = 100_000
    qc, dbc = synth_pair(n, 250, 0.5, seed=12345)
    q = codes_to_seqinfo(qc)
    db = codes_to_seqinfo(dbc)
    eng0 = TpuEngine(db, Config(**cfg_kwargs))
    # Warm the 100k-shaped compiles (pow2 table sizes differ from the
    # 20k config, so the warmed 20k shapes do not cover them).  The timed
    # section below then measures steady state, like the 20k flow.
    eng0.render_report(q, eng0.compare(q))
    del eng0
    t0 = time.perf_counter()
    eng = TpuEngine(db, Config(**cfg_kwargs))
    t_index = time.perf_counter() - t0
    aligns = []
    best_timings = {}
    for _ in range(int(os.environ.get("IMSAME_BENCH_LARGE_RUNS", "4"))):
        eng.timer.reset()
        t1 = time.perf_counter()
        res = eng.compare(q)
        dt = time.perf_counter() - t1
        if not aligns or dt < min(aligns):
            best_timings = dict(eng.timer.items())
        aligns.append(dt)
    t_align = min(aligns)
    t2 = time.perf_counter()
    report_bytes = len(eng.render_report(q, res))
    t_render = time.perf_counter() - t2
    t_e2e = t_index + t_align + t_render
    return {
        "metric": "100k x 100k end-to-end (index+align+render)",
        "n_reads": n,
        "accepted": res.accepted,
        "expected_accepted": 50_110,
        # enforced, not just displayed: a silent accept-count regression
        # must not ride along looking like a normal run
        "accepted_ok": res.accepted == 50_110,
        "index_seconds": round(t_index, 2),
        "align_seconds": round(t_align, 2),
        "align_seconds_runs": [round(t, 2) for t in sorted(aligns)],
        "render_seconds": round(t_render, 2),
        "e2e_seconds": round(t_e2e, 2),
        "reads_per_s_align": round(n / t_align, 1),
        "reference_e2e_seconds": REFERENCE_100K_WALL_S,
        "vs_reference_e2e": round(REFERENCE_100K_WALL_S / t_e2e, 2),
        "timings": {k: round(v, 3) for k, v in best_timings.items()},
        # per-stage (candidates, gate passes, unique NW pairs)
        "stage_stats": {k: list(v) for k, v in eng.stage_stats.items()},
    }


def card_line() -> str:
    """name, power.limit of the cards, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def main() -> int:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (JAX platform {dev.platform})", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    n_reads = int(os.environ.get("IMSAME_BENCH_READS", "20000"))
    read_len = 250

    from imsame_tpu.config import Config
    from imsame_tpu.pipeline import TpuEngine

    qc, dbc = synth_pair(n_reads, read_len, 0.5, seed=12345)
    q = codes_to_seqinfo(qc)
    db = codes_to_seqinfo(dbc)

    t0 = time.perf_counter()
    eng = TpuEngine(db, Config())
    t_index = time.perf_counter() - t0

    # Warmup with the full query: compiled shapes are keyed on the (pow2-
    # quantized) table sizes, so only a same-size compare triggers every
    # compile outside the timed run.  In production (all-vs-all over many
    # sample pairs) compiles amortize the same way.  Render warms too --
    # its bp-kernel compiles (~2 s) would otherwise land in the timed
    # render below.
    eng.render_report(q, eng.compare(q))

    # Timed runs; the fastest is the headline, all are reported.
    runs = []
    for _ in range(int(os.environ.get("IMSAME_BENCH_RUNS", "5"))):
        eng.timer.reset()
        t1 = time.perf_counter()
        res = eng.compare(q)
        runs.append((
            time.perf_counter() - t1, res, dict(eng.timer.items()),
            dict(eng.stage_stats),
        ))
    runs.sort(key=lambda x: x[0])
    t_align, res, timings, stage_stats = runs[0]

    # Render wall at bench scale (the C baseline's 2.7k reads/s includes
    # writing -out records during alignment, src/alignmentFunctions.c:167;
    # our render is a separate phase, so report it separately AND folded
    # into a comparable end-to-end rate).
    t_r0 = time.perf_counter()
    report_bytes = len(eng.render_report(q, res))
    t_render = time.perf_counter() - t_r0

    # Stats-kernel throughput at the 256 bucket (after the timed sections).
    kgc = kernel_gcups_at(256, B=16384, read_len=read_len)

    # Byte-parity vs the compiled reference at bench scale (SURVEY.md 4.1)
    # -- on by default (IMSAME_BENCH_PARITY=0 disables); runs after the
    # timed section so it never perturbs the measurement.

    parity = None
    if os.environ.get("IMSAME_BENCH_PARITY", "1") != "0":
        parity = check_parity(eng, q, res, qc, dbc)

    # All-vs-all sweep throughput (north-star metric 3); runs after the
    # timed sections so it never perturbs them.
    sweep = None
    if os.environ.get("IMSAME_BENCH_SWEEP", "1") != "0":
        sweep = sweep_bench(qc)

    # 100k x 100k second timed config (BASELINE config-2 scale).  Runs at
    # the default bench size only, unless forced off.
    large = None
    if n_reads == 20000 and os.environ.get("IMSAME_BENCH_LARGE", "1") != "0":
        large = large_bench()

    # Long-read envelope block: parity + per-bucket kernel GCUPS, every
    # default bench run.
    longread = None
    if n_reads == 20000 and os.environ.get("IMSAME_BENCH_LONGREAD", "1") != "0":
        longread = longread_bench()

    reads_per_s = n_reads / t_align
    gcups = res.nw_cells / t_align / 1e9
    payload = {
        "metric": "alignment-phase query reads/s (20k x 20k 250bp, 50% match)",
        "value": round(reads_per_s, 1),
        "unit": "reads/s",
        "vs_baseline": round(reads_per_s / BASELINE_READS_PER_S, 3),
        "detail": {
            "n_reads": n_reads,
            "accepted": res.accepted,
            "jaccard": round(res.jaccard, 6),
            "align_seconds": round(t_align, 3),
            "index_seconds": round(t_index, 3),
            "nw_cells": res.nw_cells,
            "gcups": round(gcups, 3),
            "candidates": res.n_candidates,
            "render_seconds": round(t_render, 3),
            "renders_per_s": round(res.accepted / max(t_render, 1e-9), 1),
            "report_bytes": report_bytes,
            "reads_per_s_incl_render": round(
                n_reads / (t_align + t_render), 1
            ),
            "nw_phase_gcups": round(
                res.nw_cells / max(timings.get("resolve.nw", 0.0), 1e-9) / 1e9,
                3,
            ),
            "nw_kernel_gcups_256": kgc,
            "align_seconds_runs": [round(t, 3) for t, _, _, _ in runs],
            "stage_stats": {k: list(v) for k, v in stage_stats.items()},
            **({"parity": parity} if parity is not None else {}),
            **({"sweep": sweep} if sweep is not None else {}),
            **({"large": large} if large is not None else {}),
            **({"longread": longread} if longread is not None else {}),
            "timings": {k: round(v, 3) for k, v in timings.items()},
        },
    }
    # Full payload first (bulky timings), compact headline summary LAST,
    # so the final line carries every headline.
    print(json.dumps(payload))
    summary = {
        "metric": payload["metric"],
        "value": payload["value"],
        "unit": payload["unit"],
        "vs_baseline": payload["vs_baseline"],
        "align_seconds_runs": payload["detail"]["align_seconds_runs"],
        "reads_per_s_incl_render": payload["detail"][
            "reads_per_s_incl_render"
        ],
        "accepted": res.accepted,
        "nw_kernel_gcups_256": kgc,
        **({"parity": parity} if parity is not None else {}),
    }
    if sweep is not None:
        summary["sweep_pairs_per_hour"] = sweep.get("pairs_per_hour")
        summary["sweep_wall_seconds"] = sweep.get("wall_seconds")
    if large is not None:
        summary["large"] = {
            k: large[k]
            for k in (
                "e2e_seconds",
                "align_seconds",
                "reads_per_s_align",
                "accepted_ok",
                "vs_reference_e2e",
            )
            if k in large
        }
    if longread is not None:
        summary["longread"] = {
            k: longread[k]
            for k in (
                "align_seconds_runs",
                "accepted",
                "parity",
                "kernel_gcups_by_bucket",
            )
            if k in longread
        }
    print(json.dumps(summary))
    # A 100k accept-count regression must fail the bench loudly, not just
    # flip a JSON boolean.
    if large is not None and not large.get("accepted_ok", True):
        print("BENCH FAIL: 100k accepted count regression", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
