"""BASELINE config-3 capacity demonstration: ~1M reads per side on one
GPU (north-star eval ladder: 1k -> 100k -> ~1M-read pair).

Workload: 1M query reads x 1M db reads, 250 bp (~250 Mbp per side -- 50x
the headline bench).  90% of db reads are 2%-mutated copies of query
reads, so the accept count is a strong sanity signal at scale.  At this
scale the k=12 dictionary saturates (250M 12-mers over 4^12 buckets ~=
15 entries/bucket), which is intrinsic to the reference's design
(src/structs.h:15) -- every query k-mer drags ~15 candidates, so the
demo raises first_window to 32 so stage 1 consumes the first ~2 full
buckets per read (the true partner's seed is found there for ~95% of
copy reads at 2% mutation; see Config.first_window).

What it exercises and times (one JSON object on the last line):
  * streaming FASTA ingest     (io/fasta.py read_fasta_stream: both
    sides are ~500 MB files, past the 256 MB whole-file threshold)
  * native index build + device upload at 250M entries (~1 GB table)
  * compare in 10 query slices of 100k reads (SeqInfo.slice_reads --
    reference n_threads-split stream semantics, so each slice's first
    read starts a fresh k-mer window like a reference worker thread;
    src/alignmentFunctions.c:93-105)
  * report render for the first slice (sanity; a full 1M-read report
    is ~10x that)

Run:  python bench_config3.py     (NVIDIA GPU only; exits non-zero
elsewhere, and when fewer reads accept than expected)
"""

import json
import sys
import time

import numpy as np

N = 1_000_000
READ_LEN = 250
MATCH_FRAC = 0.9
SUB_RATE = 0.02
SLICES = 10
EXPECTED_MIN_ACCEPT = int(N * MATCH_FRAC * 0.95)  # ~95% of copies align


def synth(n, read_len, match_frac, sub_rate, seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (n, read_len), dtype=np.uint8)
    nm = int(n * match_frac)
    db = q[:nm].copy()
    mask = rng.random((nm, read_len)) < sub_rate
    db[mask] = (db[mask] + rng.integers(1, 4, int(mask.sum()), dtype=np.uint8)) % 4
    db = np.concatenate(
        [db, rng.integers(0, 4, (n - nm, read_len), dtype=np.uint8)]
    )
    return q, db[rng.permutation(n)]


def write_fasta_mat(path, mat):
    chars = np.frombuffer(b"ACGT", np.uint8)
    n, L = mat.shape
    # vectorized emission: [n, L+header] byte matrix in slabs
    with open(path, "wb") as f:
        slab = 100_000
        for lo in range(0, n, slab):
            part = mat[lo : lo + slab]
            rows = []
            for i in range(part.shape[0]):
                rows.append(b">r%d\n" % (lo + i))
                rows.append(chars[part[i]].tobytes())
                rows.append(b"\n")
            f.write(b"".join(rows))


def main():
    import tempfile
    from pathlib import Path

    import jax

    from bench import card_line
    from imsame_tpu.config import Config
    from imsame_tpu.io.fasta import read_fasta
    from imsame_tpu.pipeline import TpuEngine

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench_config3: no GPU (JAX platform {dev.platform})",
              file=sys.stderr)
        return 2
    print(card_line(), flush=True)

    out = {
        "metric": "config-3 capacity (1M x 1M 250bp reads, one GPU)",
        "n_reads": N,
        "bp_per_side": N * READ_LEN,
    }
    t_all = time.perf_counter()
    qm, dm = synth(N, READ_LEN, MATCH_FRAC, SUB_RATE, seed=99)
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        t0 = time.perf_counter()
        write_fasta_mat(td / "q.fa", qm)
        write_fasta_mat(td / "db.fa", dm)
        out["fasta_write_seconds"] = round(time.perf_counter() - t0, 2)
        out["fasta_bytes_per_side"] = (td / "q.fa").stat().st_size
        del qm, dm
        t0 = time.perf_counter()
        q = read_fasta(str(td / "q.fa"))  # streams: > 256 MB
        db = read_fasta(str(td / "db.fa"))
        out["ingest_seconds"] = round(time.perf_counter() - t0, 2)

    cfg = Config(first_window=32, first_window_auto=False)  # pinned: the
    # auto rule would pick 64 at load ~14
    t0 = time.perf_counter()
    eng = TpuEngine(db, cfg)
    out["index_seconds"] = round(time.perf_counter() - t0, 2)
    out["index_entries"] = int(eng.index.n_entries)

    accepted = 0
    nw_cells = 0
    n_cands = 0
    slice_walls = []
    report_bytes = None
    t_align0 = time.perf_counter()
    per = N // SLICES
    for s in range(SLICES):
        qs = q.slice_reads(s * per, (s + 1) * per)
        t0 = time.perf_counter()
        res = eng.compare(qs)
        slice_walls.append(round(time.perf_counter() - t0, 2))
        accepted += res.accepted
        nw_cells += res.nw_cells
        n_cands += res.n_candidates
        if s == 0:
            t0 = time.perf_counter()
            report_bytes = len(eng.render_report(qs, res))
            out["render_slice0_seconds"] = round(
                time.perf_counter() - t0, 2
            )
    out["align_seconds"] = round(time.perf_counter() - t_align0
                                 - out["render_slice0_seconds"], 2)
    out["slice_walls"] = slice_walls
    out["accepted"] = accepted
    out["accepted_ok"] = accepted >= EXPECTED_MIN_ACCEPT
    out["candidates"] = n_cands
    out["nw_cells"] = nw_cells
    out["report_bytes_slice0"] = report_bytes
    out["reads_per_s_align"] = round(N / out["align_seconds"], 1)
    out["e2e_seconds"] = round(time.perf_counter() - t_all, 2)
    out["device"] = {"platform": dev.platform, "kind": dev.device_kind}
    print(json.dumps(out))
    return 0 if out["accepted_ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
