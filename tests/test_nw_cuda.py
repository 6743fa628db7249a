"""The GPU stats kernel (ops/cuda/nw_stats.cu via ops/nw_cuda.py).

A CUDA kernel has no interpret mode, so on the CPU these tests cover what
surrounds it: the band layout per length bucket, the scratch sizing, the
FFI call's operand and result shapes (lowered for CUDA without a GPU),
the backend choice in ops/resolve.py and its refusal to fall back, and
the padding of pair chunks.  The kernel's own arithmetic is checked
against nw_stats_batch and the oracle by the ``gpu`` tests below and by
chip_smoke.py on the card."""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from imsame_tpu.config import Config
from imsame_tpu.ops import nw_cuda
from imsame_tpu.ops.extend_packed import pack_read_rows
from imsame_tpu.ops.nw import nw_stats_batch
from imsame_tpu.ops.resolve import nw_stats_rows, select_stats_kernel

BUCKETS = Config().length_buckets


@pytest.mark.parametrize("L", BUCKETS)
def test_band_layout_covers_bucket(L):
    R = nw_cuda.rows_per_lane(L)
    band = 32 * R
    assert R in (4, 8, 16)
    assert L % band == 0  # whole bands: no lane reads past the row
    assert band == min(L, 512)


@pytest.mark.parametrize("L", [64, 100, 384, 640])
def test_band_layout_rejects_other_lengths(L):
    with pytest.raises(ValueError):
        nw_cuda.rows_per_lane(L)


def test_scratch_only_for_multi_band():
    assert nw_cuda.scratch_len(8192, 256) == 1
    assert nw_cuda.scratch_len(8192, 512) == 1
    assert nw_cuda.scratch_len(16, 1024) == 16 * nw_cuda.SCRATCH_ROWS * 1024
    assert nw_cuda.scratch_len(3, 3072) == 3 * nw_cuda.SCRATCH_ROWS * 3072


@pytest.mark.parametrize("L", BUCKETS)
def test_ffi_call_shapes_lowered_for_cuda(monkeypatch, L):
    monkeypatch.setattr(nw_cuda, "load", lambda: None)
    B = 24
    f = jax.jit(functools.partial(nw_cuda.nw_stats_batch_cuda, max_len=L))
    codes = jax.ShapeDtypeStruct((B, L), jnp.uint8)
    lens = jax.ShapeDtypeStruct((B,), jnp.int32)
    gap = jax.ShapeDtypeStruct((), jnp.int32)
    text = f.trace(codes, codes, lens, lens, gap, gap).lower(
        lowering_platforms=("cuda",)
    ).as_text()
    calls = [ln for ln in text.splitlines() if "custom_call" in ln]
    assert len(calls) == 1 and f"@{nw_cuda.TARGET}(" in calls[0]
    sig = re.search(r"\) -> \((.*)\)$", calls[0].strip()).group(1)
    scratch = nw_cuda.scratch_len(B, L)
    assert sig == f"tensor<4x{B}xi32>, tensor<{scratch}xi32>"
    assert f"(tensor<{B}x{L}xui8>, tensor<{B}x{L}xui8>, tensor<{B}xi32>" in (
        calls[0]
    )


def test_cpu_backend_uses_plain_path():
    assert select_stats_kernel("cpu") is nw_stats_batch


def test_gpu_backend_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(nw_cuda, "_registered", False)
    monkeypatch.setattr(nw_cuda, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        select_stats_kernel("gpu")


def test_nvcc_command_targets_hopper():
    cmd = nw_cuda.nvcc_command("nvcc", "out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[cmd.index("-I") + 1] == jax.ffi.include_dir()
    assert cmd[-1] == str(nw_cuda.SRC) and nw_cuda.SRC.exists()


def test_padded_chunk_leaves_real_pairs_unchanged():
    """The engine pads a pair chunk up to its ladder size with pair
    (0, 0); the stats of the real pairs must not depend on the padding."""
    rng = np.random.default_rng(4)
    L, n_reads, n_real = 128, 12, 5
    lens = rng.integers(40, L + 1, n_reads)
    codes = rng.integers(0, 4, int(lens.sum()), dtype=np.uint8)
    start = np.concatenate(([0], np.cumsum(lens)[:-1]))
    rows = jnp.asarray(pack_read_rows(codes, start, lens, L))
    qlen = jnp.asarray(lens.astype(np.int32))
    rs = rng.integers(0, n_reads, (2, n_real)).astype(np.int32)
    padded = np.zeros((2, 16), np.int32)
    padded[:, :n_real] = rs
    want = nw_stats_rows(rows, rows, jnp.asarray(rs), qlen, qlen, -5, -2,
                         max_len=L)
    got = nw_stats_rows(rows, rows, jnp.asarray(padded), qlen, qlen, -5, -2,
                        max_len=L)
    np.testing.assert_array_equal(
        np.asarray(got)[:, :n_real], np.asarray(want)
    )


def _mixed_pairs(rng, B, L):
    """Mutated copies (some with a shifted suffix) and random pairs, with
    the edge lengths 2, L-1 and L."""
    xlen = rng.integers(2, L + 1, B).astype(np.int32)
    ylen = rng.integers(2, L + 1, B).astype(np.int32)
    X = rng.integers(0, 4, (B, L)).astype(np.uint8)
    Y = rng.integers(0, 4, (B, L)).astype(np.uint8)
    h = B // 2
    ylen[:h] = xlen[:h]
    Y[:h] = X[:h]
    mut = rng.random((h, L)) < 0.06
    Y[:h][mut] = (Y[:h][mut] + rng.integers(1, 4, int(mut.sum()))) % 4
    for b in range(0, h, 3):
        cut = int(rng.integers(1, max(2, xlen[b] - 1)))
        Y[b, cut:] = np.roll(Y[b, cut:], int(rng.integers(1, 4)))
    xlen[-1] = ylen[-1] = L
    xlen[-2] = 2
    ylen[-3] = 2
    xlen[-4] = ylen[-4] = L - 1
    return X, Y, xlen, ylen


@pytest.mark.gpu
@pytest.mark.parametrize("L", BUCKETS)
def test_kernel_matches_plain_path(on_gpu, L):
    rng = np.random.default_rng(L)
    args = [jnp.asarray(a) for a in _mixed_pairs(rng, 64, L)]
    want = nw_stats_batch(*args, -5, -2, max_len=L)
    got = nw_cuda.nw_stats_batch_cuda(*args, -5, -2, max_len=L)
    for f in want._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(got, f)), np.asarray(getattr(want, f)), f
        )
