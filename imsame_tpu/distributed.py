"""Multi-host runtime scaffolding (SURVEY.md section 5.8).

The reference scales across samples with sequential shell invocations and
within a sample with pthreads (src/IMSAME.c:430-462); its equivalents
here:

  * process bootstrap: ``init_distributed()`` wires this process into a
    multi-host JAX job via ``jax.distributed.initialize`` (coordinator
    address + process count + process id + the local devices this
    process owns, from arguments or the IMSAME_COORDINATOR /
    IMSAME_NUM_PROCESSES / IMSAME_PROCESS_ID / IMSAME_LOCAL_DEVICE_IDS
    environment).  With one process it is a no-op, so single-process runs
    exercise the same code path (SURVEY.md section 4.3).
  * query sharding: each host streams its own contiguous stripe of query
    reads (``shard_query_for_host``); host boundaries behave exactly like
    the reference's thread boundaries (a host's first read does not
    receive the previous read's trailing k-mer base -- the same stream
    quirk Config.n_threads emulates, src/alignmentFunctions.c:93-105).
  * stat merging: ``allreduce_sum`` adds per-host accepted counts /
    DP-cell tallies across processes (a psum over hosts; identity with
    one process).

Launcher, one process per host (each process drives every card of its
host):

    IMSAME_COORDINATOR=host0:8476 IMSAME_NUM_PROCESSES=N \
    IMSAME_PROCESS_ID=$i python -m imsame_tpu.orchestrator ... --distributed

N processes on ONE host must each own one card: a process that opened
every card would reserve most of each card's memory, and the next
process would fail for want of it.  Give each its card:

    IMSAME_COORDINATOR=localhost:8476 IMSAME_NUM_PROCESSES=4 \
    IMSAME_PROCESS_ID=$i IMSAME_LOCAL_DEVICE_IDS=$i \
    python -m imsame_tpu.orchestrator ... --distributed
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

import numpy as np

from .io.fasta import SeqInfo


@dataclasses.dataclass(frozen=True)
class DistContext:
    process_id: int
    num_processes: int

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1


def local_device_ids_from_env() -> Optional[List[int]]:
    """IMSAME_LOCAL_DEVICE_IDS as a list ("0" or "0,1"); None if unset."""
    raw = os.environ.get("IMSAME_LOCAL_DEVICE_IDS", "").strip()
    if not raw:
        return None
    return [int(x) for x in raw.split(",") if x.strip()]


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> DistContext:
    """Initialize jax.distributed when num_processes > 1; no-op otherwise.

    Arguments default to the IMSAME_* environment variables so launchers
    need no code changes; a plain single-process run returns the
    degenerate context without touching jax.distributed.
    ``local_device_ids`` restricts this process to those local devices
    (None: all of them)."""
    coordinator = coordinator or os.environ.get("IMSAME_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("IMSAME_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("IMSAME_PROCESS_ID", "0"))
    if local_device_ids is None:
        local_device_ids = local_device_ids_from_env()
    if num_processes <= 1:
        return DistContext(0, 1)
    if not coordinator:
        raise ValueError(
            "multi-process run needs a coordinator address "
            "(IMSAME_COORDINATOR=host:port)"
        )
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    return DistContext(process_id, num_processes)


def shard_query_for_host(q: SeqInfo, ctx: DistContext) -> SeqInfo:
    """Contiguous read stripe for this host: reads
    [pid * ceil(n/P), (pid+1) * ceil(n/P)) -- the multi-host analog of the
    reference's per-thread read ranges (src/IMSAME.c:414,452).  Read
    indices in reports refer to the local shard; callers offset by
    ``read_offset_for_host`` when merging."""
    if not ctx.is_distributed:
        return q
    per = -(-q.n_seqs // ctx.num_processes)
    lo = min(ctx.process_id * per, q.n_seqs)
    hi = min(lo + per, q.n_seqs)
    return q.slice_reads(lo, hi)


def read_offset_for_host(n_reads: int, ctx: DistContext) -> int:
    per = -(-n_reads // ctx.num_processes)
    return min(ctx.process_id * per, n_reads)


def allreduce_sum(value: int, ctx: DistContext) -> int:
    """Sum an int across processes (identity when single-process)."""
    if not ctx.is_distributed:
        return int(value)
    from jax.experimental import multihost_utils

    gathered = multihost_utils.process_allgather(
        np.asarray([value], np.int64)
    )
    return int(np.sum(gathered))
