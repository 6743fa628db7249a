import random
from pathlib import Path

import numpy as np
import pytest

from imsame_tpu.io.fasta import (
    parse_fasta_bytes,
    read_fasta,
    revcomp_fasta,
    revcomp_fasta_bytes,
    valid_db_kmer_starts,
)
from util_synth import reference_binaries, write_fasta

import subprocess


def test_basic_parse():
    data = b">r0\nACGT\n>r1\nacgtACGT\n"
    si = parse_fasta_bytes(data)
    assert si.n_seqs == 2
    assert si.total_len == 12
    np.testing.assert_array_equal(si.start, [0, 4])
    np.testing.assert_array_equal(si.codes[:4], [0, 1, 2, 3])
    np.testing.assert_array_equal(si.codes[4:8], [0, 1, 2, 3])
    assert si.headers == [b"r0", b"r1"]


def test_non_acgt_dropped_and_resets():
    # N is dropped from the concatenated array but resets the k-mer window.
    data = b">x\nACGTN\nACGT\n"
    si = parse_fasta_bytes(data)
    assert si.total_len == 8
    # fresh at read start and at the base right after the N
    np.testing.assert_array_equal(
        si.fresh, [True, False, False, False, True, False, False, False]
    )
    # newline does NOT reset: the two lines of the second read join.
    data2 = b">x\nACGTACG\nTACGTA\n"
    si2 = parse_fasta_bytes(data2)
    assert si2.total_len == 13
    assert si2.fresh.sum() == 1  # only the read start
    starts = valid_db_kmer_starts(si2, k=12)
    np.testing.assert_array_equal(starts, [0, 1])


def test_kmer_starts_respect_resets():
    data = b">x\n" + b"A" * 12 + b"N" + b"C" * 12 + b"\n"
    si = parse_fasta_bytes(data)
    starts = valid_db_kmer_starts(si, k=12)
    np.testing.assert_array_equal(starts, [0, 12])  # no window spans the N


def test_multiline_and_case():
    data = b">x\nacg\ntAC\ngt\n"
    si = parse_fasta_bytes(data)
    assert si.total_len == 8
    np.testing.assert_array_equal(si.codes, [0, 1, 2, 3, 0, 1, 2, 3])


def test_empty_and_headerless_prefix():
    si = parse_fasta_bytes(b"junk\nACGT\n>only\nGGCC\n")
    # bases before the first '>' are dropped
    assert si.n_seqs == 1
    assert si.total_len == 4


def test_revcomp_matches_reference(tmp_path: Path):
    ref = reference_binaries()
    if ref is None:
        pytest.skip("reference binaries unavailable")
    _, revcomp_bin = ref
    rng = random.Random(3)
    reads = [
        "".join(rng.choice("ACGTacgtN") for _ in range(rng.randrange(30, 90)))
        for _ in range(7)
    ]
    fa = tmp_path / "in.fa"
    write_fasta(fa, reads, line_len=25)
    ref_out = tmp_path / "ref.fa"
    subprocess.run([str(revcomp_bin), str(fa), str(ref_out)], check=True)
    ours = revcomp_fasta_bytes(fa.read_bytes())
    assert ours == ref_out.read_bytes()


def test_revcomp_roundtrip_file(tmp_path: Path):
    fa = tmp_path / "a.fa"
    fa.write_bytes(b">h1 desc\nACGTU\n>h2\nggcc\n")
    out = tmp_path / "b.fa"
    revcomp_fasta(str(fa), str(out))
    txt = out.read_bytes()
    # reverse file order; revcomp; U->A
    assert txt == b">h2\nggcc\n>h1 desc\nAACGT\n"


def test_native_parse_matches_numpy():
    """The native single-pass parser must agree with the numpy fallback on
    tricky inputs: multi-line reads, lowercase, invalid chars (window
    resets), empty reads, '>' mid-line, missing trailing newline."""
    import numpy as np

    from imsame_tpu import native
    from imsame_tpu.io.fasta import _parse_fasta_bytes_np, parse_fasta_bytes

    if native.lib is None:
        import pytest

        pytest.skip("native host library unavailable")

    cases = [
        b">r0\nACGTacgt\nGGTT\n>r1\nNNACGT\n>empty\n>r2\nAC>GT\nTTTT",
        b">a\n" + b"ACGT" * 2000 + b"\n>b\n" + b"acgtNNNNacgt" * 300,
        b"junk before\n>x\nACGT\n\n>y no newline at eof\nTTTT",
        b">only header, no seq",
        b"",
        b">m\n" + b"AC\n" * 500 + b">n\nG",
    ]
    from imsame_tpu.io.fasta import _CODE_LUT

    for data in cases:
        a = _parse_fasta_bytes_np(data)
        big = data
        res = native.parse_fasta_arrays(big, _CODE_LUT)
        assert res is not None
        codes, fresh_u8, start, hdr_se, n_reads = res
        m = len(codes)
        if len(start) and (start < 0).any():
            t = np.where(start < 0, np.int64(m), start)
            start = np.minimum.accumulate(t[::-1])[::-1]
        np.testing.assert_array_equal(codes, a.codes)
        np.testing.assert_array_equal(fresh_u8.astype(bool), a.fresh)
        np.testing.assert_array_equal(start, a.start)
        headers = [
            big[int(hdr_se[2 * i]) : int(hdr_se[2 * i + 1])]
            for i in range(n_reads)
        ]
        assert headers == a.headers


# --- streaming parser (reference streams via a 50 MB READBUF buffer,
# src/commonFunctions.c:15-23) ---

def _adversarial_fasta(rng):
    """FASTA bytes packed with boundary hazards: multi-line reads, dropped
    chars at line starts/ends, empty reads, headers back-to-back, lowercase,
    no trailing newline."""
    parts = []
    for i in range(rng.randrange(30, 60)):
        parts.append(f">r{i} desc\n".encode())
        kind = rng.randrange(6)
        if kind == 0:
            continue  # base-less read
        n_lines = rng.randrange(1, 5)
        for _ in range(n_lines):
            line = "".join(
                rng.choice("ACGTacgtNnX-")
                for _ in range(rng.randrange(0, 90))
            )
            parts.append(line.encode() + b"\n")
    data = b"".join(parts)
    if rng.random() < 0.5:
        data = data.rstrip(b"\n")  # unterminated final line
    return data


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("chunk", [7, 64, 1024])
def test_stream_parse_matches_whole_file(tmp_path, seed, chunk):
    import random

    from imsame_tpu.io.fasta import read_fasta_stream

    rng = random.Random(seed)
    data = _adversarial_fasta(rng)
    p = tmp_path / "s.fa"
    p.write_bytes(data)
    whole = parse_fasta_bytes(data)
    stream = read_fasta_stream(str(p), chunk_bytes=chunk)
    np.testing.assert_array_equal(stream.codes, whole.codes)
    np.testing.assert_array_equal(stream.start, whole.start)
    np.testing.assert_array_equal(stream.fresh, whole.fresh)
    assert stream.headers == whole.headers
