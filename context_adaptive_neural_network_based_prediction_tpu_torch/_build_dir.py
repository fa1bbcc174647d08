"""The port's build directory for the libraries it compiles at first use.

Libraries go to `_build/` inside the package (listed in `.gitignore`), one
file per hash of the sources and the compile command, so an unchanged tree
does not rebuild.  A build writes a temporary file and renames it into
place, so processes that build at the same time do not see a half-written
library.  `seconds` records how long each build of this process took, and
`output` what its compiler printed (for nvcc, the `-Xptxas -v` register
and spill counts).
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import time

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
seconds: dict[str, float] = {}
output: dict[str, str] = {}


def built() -> dict:
    """{name: seconds} of every build this process ran (none where every
    library was already in the build directory)."""
    return dict(seconds)


def build_once(name: str, sources, command) -> str:
    """Returns the path of library `name` built from `sources`.

    `command(out_path)` gives the compiler's argv.  Raises RuntimeError,
    with the compiler's output, if the build fails."""
    h = hashlib.sha256()
    for path in sources:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(command("OUT")).encode())
    out = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(command(tmp), capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {name} failed ({proc.returncode}): "
                f"{' '.join(proc.args)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    seconds[name] = time.perf_counter() - t0
    output[name] = proc.stdout + proc.stderr
    return out
