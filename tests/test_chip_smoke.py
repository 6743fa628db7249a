"""chip_smoke.py's contract where there is no GPU: it refuses to run and
prints no result, and its result line has the agreed shape."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import jax

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def _run(script: Path, cwd: Path):
    env = {"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
           "HOME": str(cwd)}
    return subprocess.run(
        [sys.executable, str(script)], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_refuses_cpu_backend(tmp_path):
    r = _run(ROOT / "chip_smoke.py", tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_fails_alone_in_a_directory(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(tmp_path / "chip_smoke.py", tmp_path)
    assert r.returncode != 0
    assert r.stdout.strip() == "" or '"ok"' not in r.stdout


def test_result_line_format():
    line = chip_smoke.result_line(jax.devices()[:1])
    got = json.loads(line)
    d = jax.devices()[0]
    assert got == {
        "ok": True,
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": 1},
    }
    assert "\n" not in line


def test_report_records_keyed_by_read():
    report = (b"(3, 7) : 95% 100% 250\n $$$$$$$ \nACGT\n"
              b"(5, 1) : 90% 99% 248\n $$$$$$$ \nTTGA\n")
    recs = chip_smoke._records(report, offset=10)
    assert sorted(recs) == [13, 15]
    assert recs[13].startswith(b"(13, 7) : 95%")
    assert recs[15].endswith(b"TTGA\n")
