"""Build directory for the compiled parts of the package.

Shared libraries are built from the sources in the tree into
``<checkout>/.build`` (listed in .gitignore), one file per content hash
of the source and the compiler command: a checkout never loads a binary
that was built from other sources, and editing a source just builds a
new file next to the old one.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path
from typing import Callable, List

CHECKOUT = Path(__file__).resolve().parent.parent
BUILD_DIR = CHECKOUT / ".build"


def library_path(name: str, src: Path, cmd: List[str]) -> Path:
    """Where the library built from ``src`` by ``cmd`` lives."""
    h = hashlib.sha256(src.read_bytes())
    h.update("\0".join(cmd).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_library(
    name: str, src: Path, cmd_for: Callable[[str], List[str]],
    timeout: float = 600,
) -> Path:
    """Return the library built from ``src``, building it first if needed.

    ``cmd_for(out)`` is the compiler command writing to ``out``.  The
    build writes a temporary file and renames it into place, so processes
    that build at the same time do not see a partial library.  Raises
    OSError or subprocess.CalledProcessError when the build fails."""
    path = library_path(name, src, cmd_for("<out>"))
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(
            cmd_for(str(tmp)), check=True, capture_output=True,
            timeout=timeout,
        )
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    return path
