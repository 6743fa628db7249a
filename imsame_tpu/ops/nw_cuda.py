"""The accept-gate stats aligner as a CUDA kernel, called through jax.ffi.

ops/cuda/nw_stats.cu computes what ops/nw.py nw_stats_batch computes --
bit for bit -- with one warp per pair and the whole wavefront state in
registers (the file's header gives the layout).  nw_stats_batch stays
the plain reference and the CPU path.

The library is compiled from the source with ``nvcc`` on first use, into
the checkout's build directory (imsame_tpu/_build.py), and registered
as an FFI target for the CUDA platform.  A CUDA kernel has no interpret
mode: the CPU tests cover the wrapper (shapes, scratch sizing, backend
choice); chip_smoke.py checks the kernel against nw_stats_batch and the
oracle on the card.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional

import jax
import jax.numpy as jnp

from .._build import build_library
from .nw import NWStatsResult

SRC = Path(__file__).resolve().parent / "cuda" / "nw_stats.cu"
TARGET = "imsame_nw_stats"
SCRATCH_ROWS = 7  # int32 rows per pair handed from one band to the next

_registered = False


def find_nvcc() -> Optional[str]:
    """nvcc on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    return cand if os.path.exists(cand) else None


def nvcc_command(nvcc: str, out: str) -> List[str]:
    return [
        nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-I", jax.ffi.include_dir(), "-o", out, str(SRC),
    ]


def load() -> None:
    """Build (on first use) and register the kernel; raises when either
    fails, so a GPU run never silently falls back to the plain path."""
    global _registered
    if _registered:
        return
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): cannot "
            f"build {SRC.name}"
        )
    try:
        so = build_library(
            "nw_stats", SRC, lambda out: nvcc_command(nvcc, out)
        )
    except subprocess.CalledProcessError as e:
        raise RuntimeError(
            f"nvcc failed on {SRC.name}:\n{e.stderr.decode(errors='replace')}"
        ) from e
    lib = ctypes.CDLL(str(so))
    jax.ffi.register_ffi_target(
        TARGET, jax.ffi.pycapsule(lib.ImsameNwStats), platform="CUDA"
    )
    _registered = True


def rows_per_lane(L: int) -> int:
    """DP rows each of a warp's 32 lanes owns (the band is 32 of them):
    one band up to L = 512, bands of 512 rows beyond."""
    R = 16 if L >= 512 else L // 32
    if R not in (4, 8, 16) or L % (32 * R):
        raise ValueError(f"length bucket {L} is not 128, 256 or k*512")
    return R


def scratch_len(B: int, L: int) -> int:
    """int32 words of band-boundary scratch the kernel needs."""
    return B * SCRATCH_ROWS * L if L > 32 * rows_per_lane(L) else 1


def nw_stats_batch_cuda(
    X: jax.Array,  # [B, L] uint8 codes, padded
    Y: jax.Array,  # [B, L] uint8 codes, padded
    xlen: jax.Array,  # [B] int32 db-read lengths
    ylen: jax.Array,  # [B] int32 query-read lengths
    igap,
    egap,
    *,
    max_len: int,
) -> NWStatsResult:
    """nw_stats_batch on the GPU (same arguments, same results)."""
    load()
    B, L = X.shape
    assert L == max_len
    out, _ = jax.ffi.ffi_call(
        TARGET,
        (
            jax.ShapeDtypeStruct((4, B), jnp.int32),
            jax.ShapeDtypeStruct((scratch_len(B, L),), jnp.int32),
        ),
    )(
        X.astype(jnp.uint8), Y.astype(jnp.uint8),
        xlen.astype(jnp.int32), ylen.astype(jnp.int32),
        jnp.asarray(igap, jnp.int32), jnp.asarray(egap, jnp.int32),
    )
    w = out[3]
    return NWStatsResult(
        best_score=out[0], best_i=out[1], best_j=out[2],
        length=w & 0xFFFF, identities=w >> 16,
    )
