"""ctypes loader for the native host runtime (native/host.c).

Compiles host.c with the system gcc on first import, into the checkout's
build directory under a name keyed by a hash of the source and the
command (imsame_tpu/_build.py), and exposes typed wrappers.  Everything
degrades gracefully: if no compiler is available the module exports
``lib = None`` and callers fall back to their numpy paths -- the results
are bit-identical either way (tests/test_native.py).

The extension deliberately avoids pybind11/numpy C API: plain C symbols +
ctypes keeps the build a single gcc invocation with zero Python build-time
dependencies.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

from .._build import build_library

SRC = Path(__file__).resolve().parent / "host.c"

i8 = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
i32 = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
u32 = np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS")
i64 = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")


def gcc_command(out: str) -> list:
    return [
        "gcc", "-O3", "-shared", "-fPIC", "-fvisibility=hidden",
        str(SRC), "-o", out, "-lpthread",
    ]


def _load():
    try:
        lib = ctypes.CDLL(str(build_library("host", SRC, gcc_command)))
    except (OSError, subprocess.SubprocessError):
        return None

    lib.imsame_index_build.restype = ctypes.c_int64
    lib.imsame_index_build.argtypes = [
        i8, i8, i64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int32, i32, u32, ctypes.c_int32, i32, i32,
    ]

    lib.imsame_parse_fasta.restype = ctypes.c_int64
    lib.imsame_parse_fasta.argtypes = [
        i8, ctypes.c_int64, i8, i8, i8, i64, i64,
        ctypes.POINTER(ctypes.c_int64),
    ]

    lib.imsame_kmer_stream.restype = None
    lib.imsame_kmer_stream.argtypes = [
        i8, i64, i64, ctypes.c_int64, ctypes.c_int32, i32, i64, i32, i32, i64,
        ctypes.c_int32,
    ]

    lib.imsame_build_flat.restype = ctypes.c_int64
    lib.imsame_build_flat.argtypes = [
        i64, i64, i64, ctypes.c_int64, i64, i64, i64, i32, i32, i64, i64,
        ctypes.c_int32, i32, i32, i32,
    ]

    lib.imsame_seg_encode.restype = ctypes.c_int64
    lib.imsame_seg_encode.argtypes = [
        i32, i32, i32, ctypes.c_int64, ctypes.c_int64, i32, i32, i32,
    ]

    lib.imsame_render_blocks.restype = ctypes.c_int32
    lib.imsame_render_blocks.argtypes = [
        i32, ctypes.c_int64, i32, i32, i32, i8, i64, i8, i64,
        ctypes.c_int64, i8, i64, i64, i32,
    ]
    return lib


lib = None if os.environ.get("IMSAME_NO_NATIVE") else _load()


def build_index_arrays(codes, fresh, start, k: int, packable: bool):
    """Parallel counting-sort index build (pthreads over input ranges).
    Returns (bucket_start, packed, pos, sid) sorted by (key asc, pos desc),
    or None if the native lib is unavailable.  In the packable regime
    (n_seqs < 2^20 and read lengths < 4096) only the (sid << 12 | doff)
    device-payload words are scattered -- the bandwidth bottleneck of the
    build -- and pos/sid come back None (KmerIndex derives them lazily);
    otherwise packed is None and pos/sid are filled."""
    if lib is None:
        return None
    n = len(codes)
    nb = 4**k
    bucket_start = np.empty(nb + 1, np.int32)
    codes = np.ascontiguousarray(codes, np.uint8)
    fresh_u8 = np.ascontiguousarray(fresh, np.uint8)
    start = np.ascontiguousarray(start, np.int64)
    cap = max(n, 1)
    dummy_u32 = np.empty(1, np.uint32)
    dummy_i32 = np.empty(1, np.int32)
    if packable:
        packed = np.empty(cap, np.uint32)
        pos = sid = None
        args = (packed, 1, dummy_i32, dummy_i32)
    else:
        packed = None
        pos = np.empty(cap, np.int32)
        sid = np.empty(cap, np.int32)
        args = (dummy_u32, 0, pos, sid)
    total = lib.imsame_index_build(
        codes, fresh_u8, start, len(start), n, k, nb,
        os.cpu_count() or 1, bucket_start, *args,
    )
    if total < 0:  # allocation failure in C; numpy fallback
        return None
    t = int(total)
    if packable:
        return bucket_start, packed[:t], None, None
    return bucket_start, None, pos[:t], sid[:t]


def parse_fasta_arrays(data: bytes, lut):
    """Single-pass FASTA ingest.  Returns (codes, fresh, start, hdr_se,
    n_reads) with start[r] == -1 for base-less reads (caller back-fills),
    or None if the native lib is unavailable."""
    if lib is None:
        return None
    raw = np.frombuffer(data, np.uint8)
    n = len(raw)
    cap_reads = max(data.count(b">"), 1)  # upper bound: every '>' byte
    codes = np.empty(max(n, 1), np.uint8)
    fresh = np.empty(max(n, 1), np.uint8)
    start = np.empty(cap_reads, np.int64)
    hdr_se = np.empty(2 * cap_reads, np.int64)
    n_reads = ctypes.c_int64(0)
    m = lib.imsame_parse_fasta(
        raw, n, np.ascontiguousarray(lut, np.uint8),
        codes, fresh, start, hdr_se, ctypes.byref(n_reads),
    )
    nr = int(n_reads.value)
    return codes[:m], fresh[:m], start[:nr], hdr_se[: 2 * nr], nr


def kmer_stream_arrays(codes, qlo, n_kmers, k: int, bucket_start):
    """Fused per-slot stream tables.  Returns (kp, lo, cnt, Ccum) or None."""
    if lib is None:
        return None
    total = int(n_kmers.sum())
    kp = np.empty(total, np.int64)
    lo = np.empty(total, np.int32)
    cnt = np.empty(total, np.int32)
    Ccum = np.empty(total + 1, np.int64)
    lib.imsame_kmer_stream(
        np.ascontiguousarray(codes, np.uint8),
        np.ascontiguousarray(qlo, np.int64),
        np.ascontiguousarray(n_kmers, np.int64),
        len(qlo), k,
        bucket_start, kp, lo, cnt, Ccum,
        os.cpu_count() or 1,
    )
    return kp, lo, cnt, Ccum


def render_blocks(
    chains, n_steps, xlen, ylen, xchars, xoff, ychars, yoff, out_off,
    total_out,
):
    """Batched record-block rendering (backtrack + 60-col emission +
    identity count).  Returns (out_bytes, out_len, identities) or None."""
    if lib is None:
        return None
    P = len(n_steps)
    out = np.empty(total_out, np.uint8)
    out_len = np.empty(P, np.int64)
    identities = np.empty(P, np.int32)
    rc = lib.imsame_render_blocks(
        np.ascontiguousarray(chains, np.int32), chains.shape[1],
        np.ascontiguousarray(n_steps, np.int32),
        np.ascontiguousarray(xlen, np.int32),
        np.ascontiguousarray(ylen, np.int32),
        np.ascontiguousarray(xchars, np.uint8),
        np.ascontiguousarray(xoff, np.int64),
        np.ascontiguousarray(ychars, np.uint8),
        np.ascontiguousarray(yoff, np.int64),
        P, out, np.ascontiguousarray(out_off, np.int64), out_len, identities,
    )
    if rc != 0:
        return None
    return out, out_len, identities


def build_flat_arrays(
    read_ids, from_rank, to_rank, K_off, C_off, kp, lo, cnt, Ccum, q_start,
    k: int, out_size: int,
):
    """Flat candidate expansion.  Returns (rids, hits, qoffs) or None."""
    if lib is None:
        return None
    rids = np.empty(out_size, np.int32)
    hits = np.empty(out_size, np.int32)
    qoffs = np.empty(out_size, np.int32)
    n = lib.imsame_build_flat(
        np.ascontiguousarray(read_ids, np.int64),
        np.ascontiguousarray(from_rank, np.int64),
        np.ascontiguousarray(to_rank, np.int64),
        len(read_ids),
        K_off, C_off, kp, lo, cnt, Ccum,
        np.ascontiguousarray(q_start, np.int64), k,
        rids, hits, qoffs,
    )
    assert n == out_size, (n, out_size)
    return rids, hits, qoffs


def seg_encode(rids, qoffs, hits, size: int, seg_cap: int):
    """Native single-pass segment encoding (host.c imsame_seg_encode);
    returns (cand[size], rtab[seg_cap], rbase[seg_cap]) int32 arrays or
    None when unavailable / segment overflow (callers fall back)."""
    if lib is None:
        return None
    n = len(rids)
    cand = np.zeros(size, np.int32)
    rtab = np.zeros(seg_cap, np.int32)
    rbase = np.zeros(seg_cap, np.int32)
    nseg = lib.imsame_seg_encode(
        np.ascontiguousarray(rids, np.int32),
        np.ascontiguousarray(qoffs, np.int32),
        np.ascontiguousarray(hits, np.int32),
        n, seg_cap, cand, rtab, rbase,
    )
    if nseg < 0:
        return None
    return cand, rtab, rbase, int(nseg)
