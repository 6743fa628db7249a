"""Where the package keeps what it builds at run time: compiled libraries
in the checkout's .build directory keyed by a source hash, and the
persistent compilation cache."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from imsame_tpu import _build, native
from imsame_tpu.distributed import local_device_ids_from_env

ROOT = Path(__file__).resolve().parent.parent


def _cache_dir_in_fresh_process(env_value):
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    r = subprocess.run(
        [sys.executable, "-c",
         "import imsame_tpu, jax; print(jax.config.jax_compilation_cache_dir)"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
        check=True,
    )
    return r.stdout.strip()


def test_compile_cache_fixed_in_checkout_by_default():
    assert _cache_dir_in_fresh_process(None) == str(ROOT / ".jax_cache")


def test_compile_cache_follows_environment(tmp_path):
    assert _cache_dir_in_fresh_process(str(tmp_path)) == str(tmp_path)


def test_library_path_keyed_by_source_and_command(tmp_path):
    src = tmp_path / "a.c"
    src.write_text("int f(void) { return 1; }\n")
    cmd = ["cc", "-O2"]
    p1 = _build.library_path("a", src, cmd)
    assert p1.parent == _build.BUILD_DIR
    assert _build.library_path("a", src, cmd) == p1
    assert _build.library_path("a", src, cmd + ["-g"]) != p1
    src.write_text("int f(void) { return 2; }\n")
    assert _build.library_path("a", src, cmd) != p1


def test_build_library_builds_once(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "a.src"
    src.write_text("payload")
    calls = []

    def cmd_for(out):
        calls.append(out)
        return [sys.executable, "-c",
                f"import shutil; shutil.copy({str(src)!r}, {out!r})"]

    p = _build.build_library("a", src, cmd_for)
    assert p.read_text() == "payload" and p.parent == tmp_path / "build"
    n = len(calls)
    assert _build.build_library("a", src, cmd_for) == p
    assert len(calls) == n + 1  # the path is computed, nothing is rebuilt
    assert [f.name for f in p.parent.iterdir()] == [p.name]  # no temp left


def test_native_library_loaded_from_build_dir():
    if native.lib is None:
        pytest.skip("no C compiler: the numpy fallbacks run instead")
    path = Path(native.lib._name)
    assert path.parent == _build.BUILD_DIR
    assert path == _build.library_path("host", native.SRC,
                                       native.gcc_command("<out>"))
    assert not list((ROOT / "imsame_tpu" / "native").glob("*.so"))


@pytest.mark.parametrize(
    "value,want", [(None, None), ("2", [2]), ("0,3", [0, 3])]
)
def test_local_device_ids_from_environment(monkeypatch, value, want):
    if value is None:
        monkeypatch.delenv("IMSAME_LOCAL_DEVICE_IDS", raising=False)
    else:
        monkeypatch.setenv("IMSAME_LOCAL_DEVICE_IDS", value)
    assert local_device_ids_from_env() == want
