"""Runtime configuration for the engine.

One dataclass mirroring the reference CLI flags and their defaults
(reference: src/IMSAME.c:44-49 and init_args at src/IMSAME.c:520-578), plus
engine tunables that have no reference equivalent (batching, sharding).

The tunables' values set shapes and schedules, never results.  They were
tuned on the accelerator this engine was first built for and are kept as
they are until they are measured on the GPU.

Reference flag quirks honored here:
  * ``-igap``/``-egap`` are *negated* on parse (src/IMSAME.c:565,568): users
    pass positive penalties; the engine stores negative scores.  The
    dataclass stores the already-negative scores, like the reference's
    internal state, with defaults igap=-5, egap=-2.
  * ``--verbose`` is accepted but dead, as in the reference
    (src/IMSAME.c:32,524 -- VERBOSE_ACTIVE is never read).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Config:
    """Pipeline configuration (defaults == reference defaults)."""

    # Acceptance thresholds (reference: src/IMSAME.c:44-49).
    min_e_value: float = 1e-20
    min_coverage: float = 0.5
    min_identity: float = 0.5
    # Gap scores, stored negative (post-negation, reference internal form).
    igap: int = -5
    egap: int = -2

    # Reference thread count; kept for parity of the query-scan stream
    # boundary quirk (a thread's first read does not receive the previous
    # read's trailing base -- see oracle/engine.py).  The engine emulates
    # a given thread split; 1 gives the canonical deterministic stream.
    n_threads: int = 1

    # --- engine tunables (no reference equivalent) ---
    # Candidates gated per read in stage 1 (most reads accept their first
    # candidate, so a small first window resolves them cheaply); stage 2
    # flat-gates every remaining candidate of the unresolved tail.
    first_window: int = 8
    # Scale first_window with the dictionary's average bucket load
    # (n_entries / 4^k).  Dense databases push the true partner's seed
    # past a fixed-size window -- junk hits from ~load-deep buckets eat
    # the slots -- sending whole true-pair streams to the (much larger)
    # stage-2 gate: at 100k reads (load 1.4), F=8 resolved only 71% of
    # true pairs in stage 1 vs 99%+ at F=24 (a count, not a time; accepts
    # are F-invariant by construction).  F_eff = F * max(1, ceil(2*load)),
    # capped at 64.
    first_window_auto: bool = True
    # Fixed flat-gate chunk sizes (candidates per device call).  Chunks
    # pad up to one of these exactly: each distinct shape is one XLA
    # compile, so shapes are few and fixed.  The top size is sized for
    # ~100k-read compares (the stage-2 gate ships ~12M candidates, so a
    # handful of chunks).  Inherited; not yet measured on the GPU.
    gate_chunks: tuple = (1 << 21, 1 << 19, 1 << 16)
    # First-tier extension window (bases).  Random candidates' walks die
    # within a few mismatches, provably inside this window (the kernel
    # flags exactness); only escapees re-run at the full read window.
    # 0 disables the tier.  The value 64 is inherited and not yet
    # measured on the GPU.
    gate_window_small: int = 64
    # NW batch-shape ladders (descending; each shape is one XLA compile,
    # each chunk one dispatch -- see pipeline._nw_chunks).  The stats-only
    # accept path has no bp tensor, so its ladder tops out high enough
    # that a whole stage is usually one dispatch; the render path
    # materializes ~0.5 MB/pair of backpointers at the 256-bucket, so
    # 2048 pairs ~= 1 GB of device memory.  Inherited sizes, not yet
    # re-derived for an 80 GB card.
    nw_stats_batches: tuple = (32768, 8192, 4096, 2048, 1024, 512, 256)
    nw_render_batches: tuple = (2048, 1024, 512, 256)
    # HBM budget for one render chunk's backpointer tensor ([B, 2L, L]
    # int32 = 8*L^2 bytes/pair: ~0.5 MB at the 256 bucket but ~75 MB at
    # 3072).  The render ladder is capped per length bucket so B*8*L^2
    # stays under this; long-read chunks shrink to e.g. 24 pairs at 3072.
    nw_render_bp_budget: int = 2 << 30
    # Length buckets (reads padded up to the smallest bucket >= their len).
    length_buckets: tuple = (128, 256, 512, 1024, 2048, 3072)
    # Device-side candidate enumeration (ops/enum_gate.py): the gate
    # rebuilds the reference's candidate stream on device from the packed
    # query rows + the engine-resident bucket table, so per-candidate
    # host->device traffic disappears.  None = off: on the accelerator
    # the engine was first built for, the enumeration's scattered gathers
    # cost more than the host-built candidate upload they replace; not
    # yet measured on the GPU.  The path is kept bit-equal and tested.
    # Applies only single-device with the packed index format and padded
    # query rows <= gate_enum_max_rows.
    gate_enum: Optional[bool] = None
    gate_enum_max_rows: int = 1 << 17
    # Device mesh (data, dict) for the production engine (SURVEY.md 2a):
    # "auto" = use every visible device on the data axis when the batch
    # shapes divide evenly (single-device otherwise); None = single-device;
    # (n_data, n_dict) = explicit.  The dict axis shards the sorted-index
    # payload by row range (capacity, not speed -- see parallel/sharded.py).
    mesh_shape: object = "auto"
    # Dispatch the render-NW + chain prefix for wave-1 winners INSIDE
    # compare (they are final under first-accept-wins), so their chains
    # compute while the host judges waves 2/3; render_report then only
    # fetches.  Single-device path only.  Default OFF: the post-wave-3
    # judge window is short, so the dispatch mostly moves wall time from
    # the render phase into align (and the sweep path already overlaps
    # whole renders with the next compare on a worker thread).  ON can
    # pay when compare is followed by long host work before
    # render_report.  Not yet measured on the GPU.
    render_overlap: bool = False
    # When set, each compare() is wrapped in a jax.profiler trace written
    # here (open with TensorBoard / xprof; SURVEY.md 5.1).
    profile_dir: Optional[str] = None

    def validate(self) -> None:
        if self.min_e_value < 0:
            raise ValueError("min_e_value must be >= 0")
        if not (0 < self.min_coverage):
            raise ValueError("min_coverage must be > 0")
        if not (0 < self.min_identity):
            raise ValueError("min_identity must be > 0")
        if self.n_threads < 1:
            raise ValueError("n_threads must be >= 1")
        if any(c % 32 for c in self.gate_chunks):
            raise ValueError("gate_chunks must be multiples of 32")


DEFAULT_CONFIG = Config()
