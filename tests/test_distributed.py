"""Multi-host runtime (SURVEY.md 5.8): single-process degenerate path,
host query sharding equivalence with the reference's thread-split
semantics, stat merging identity, and a REAL multi-process run -- two
local processes through jax.distributed (CPU backend, localhost
coordinator) driving the orchestrator's --distributed stripe."""

import json
import os
import pytest
import random
import socket
import subprocess
import sys
from pathlib import Path

from imsame_tpu.config import Config
from imsame_tpu.distributed import (
    DistContext,
    allreduce_sum,
    init_distributed,
    read_offset_for_host,
    shard_query_for_host,
)
from imsame_tpu.io.fasta import parse_fasta_bytes
from imsame_tpu.pipeline import TpuEngine
from util_synth import make_pair


def test_single_process_degenerate():
    ctx = init_distributed(num_processes=1)
    assert ctx == DistContext(0, 1)
    assert not ctx.is_distributed
    assert allreduce_sum(7, ctx) == 7


def test_host_sharding_matches_thread_split(tmp_path):
    """Two host shards, even read count: the union of per-host accepted
    pairs (offset back to global read ids) equals the single-engine run
    with n_threads=2 -- host boundaries behave exactly like the
    reference's thread boundaries (src/alignmentFunctions.c:93-105)."""
    rng = random.Random(91)
    n = 40  # even: floor(n/2) thread split == ceil(n/2) host split
    qp, dp = make_pair(tmp_path, rng, n_query=n, n_db=n, read_len=150,
                       sub_rate=0.05, indel_rate=0.02)
    q = parse_fasta_bytes(qp.read_bytes())
    db = parse_fasta_bytes(dp.read_bytes())

    eng = TpuEngine(db, Config(n_threads=2))
    want = set(eng.compare(q).pairs)

    got = set()
    total = 0
    for pid in range(2):
        ctx = DistContext(pid, 2)
        qs = shard_query_for_host(q, ctx)
        off = read_offset_for_host(q.n_seqs, ctx)
        res = TpuEngine(db, Config()).compare(qs)
        got |= {(r + off, s) for r, s in res.pairs}
        total += res.accepted
    assert got == want
    assert total == len(want)


def _write_samples(d: Path, rng: random.Random, n_samples=3, n_reads=24):
    """Small related sample set so cross-sample pairs accept some reads."""
    from util_synth import mutate, random_read

    base = [random_read(rng, 120) for _ in range(n_reads)]
    d.mkdir(exist_ok=True)
    for s in range(n_samples):
        lines = []
        for i, r in enumerate(base):
            seq = mutate(rng, r, sub_rate=0.04, indel_rate=0.01) if s else r
            lines.append(f">s{s}r{i}\n{seq}\n")
        (d / f"sample{s}.fasta").write_text("".join(lines))


@pytest.mark.parametrize("nproc", [2, 4])
def test_multiprocess_distributed_sweep(tmp_path, nproc):
    """nproc REAL processes, jax.distributed over a localhost coordinator:
    the merged --distributed sweep must equal the single-process sweep
    byte-for-byte, and the allreduce_sum'd global accepted count must be
    printed identically by both processes (SURVEY.md 5.8; replaces the
    reference's sequential shell fan-out,
    bin/all_vs_all_metagenomes_IMSAME.sh:27-58)."""
    rng = random.Random(314)
    samples = tmp_path / "samples"
    _write_samples(samples, rng)

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # keep subprocess startup light: 2 virtual devices each
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    repo = Path(__file__).resolve().parent.parent
    env["PYTHONPATH"] = str(repo) + os.pathsep + env.get("PYTHONPATH", "")

    # single-process ground truth
    ref_out = tmp_path / "ref_out"
    r = subprocess.run(
        [sys.executable, "-m", "imsame_tpu.orchestrator",
         str(samples), "0.5", "0.5", "4", "fasta", str(ref_out)],
        env=env, capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    dist_out = tmp_path / "dist_out"
    procs = []
    for pid in range(nproc):
        penv = dict(env)
        penv["IMSAME_COORDINATOR"] = f"127.0.0.1:{port}"
        penv["IMSAME_NUM_PROCESSES"] = str(nproc)
        penv["IMSAME_PROCESS_ID"] = str(pid)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "imsame_tpu.orchestrator",
             str(samples), "0.5", "0.5", "4", "fasta", str(dist_out),
             "--distributed"],
            env=penv, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        ))
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err
        outs.append(out)

    # byte-identical merged sweep
    ref_files = sorted(f.name for f in ref_out.glob("*.align"))
    dist_files = sorted(f.name for f in dist_out.glob("*.align"))
    assert dist_files == ref_files and len(ref_files) == 6
    for name in ref_files:
        assert (dist_out / name).read_bytes() == (
            ref_out / name
        ).read_bytes(), name

    # the allreduced global tally is printed by BOTH processes, equal,
    # and equals the sum over the single-process sweep's stats files
    tallies = []
    for out in outs:
        for line in out.splitlines():
            if "Distributed sweep total accepted" in line:
                tallies.append(int(line.split(":")[1].split("(")[0]))
    want_total = sum(
        json.loads(p.read_text())["accepted"]
        for p in ref_out.glob("*.align.json")
    )
    assert tallies == [want_total] * nproc
    assert want_total > 0
