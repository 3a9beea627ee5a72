"""gaml_tpu's native host library, built safely under concurrency.

``gaml_tpu.native.get_lib()`` compiles ``libgaml_native.so`` in place the
first time a process asks for it, and remembers a failed load for the
life of the process.  Where several processes start at once (test
workers, the CLI's subprocesses), one of them can load the file while
another is still writing it, and that process loses the library for good.

``load_native()`` builds the same source with the same g++ command into
the port's own build directory instead: under a file lock, into a
temporary file that is then renamed into place, under a name derived from
the source and command, so a loader never sees a partial file.  It then
points ``gaml_tpu.native`` at that copy and loads it there, so every
caller of ``get_lib()`` in the process gets it.  Nothing runs at import.
"""
from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess

import gaml_tpu.native as native

from .ops.build import BUILD_DIR

GXX = ("g++", "-O3", "-march=native", "-funroll-loops", "-fopenmp",
       "-std=c++17", "-shared", "-fPIC")


def _build(so: str) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(so):
            # get_lib() rebuilds in place a library older than its source
            if os.path.getmtime(so) < os.path.getmtime(native._SRC):
                os.utime(so)
            return True
        tmp = f"{so}.{os.getpid()}.tmp"
        for cmd in (GXX, tuple(c for c in GXX if c != "-fopenmp")):
            try:
                subprocess.run([*cmd, "-o", tmp, native._SRC], check=True,
                               capture_output=True)
            except (subprocess.CalledProcessError, OSError):
                continue
            os.replace(tmp, so)
            return True
        return False


def load_native():
    """The loaded native library (``gaml_tpu.native.get_lib()``), built
    into the port's build directory first; None where it cannot be built
    or where GAML_TPU_NO_NATIVE=1."""
    with native._lock:
        if native._lib is not None:
            return native._lib
    if os.environ.get("GAML_TPU_NO_NATIVE") == "1":
        return None
    h = hashlib.sha1(" ".join(GXX).encode())
    with open(native._SRC, "rb") as f:
        h.update(f.read())
    so = os.path.join(BUILD_DIR, f"libgaml_native_{h.hexdigest()[:16]}.so")
    if not _build(so):
        return None
    with native._lock:
        if native._lib is None:
            native._SO = so
            native._tried = False
    return native.get_lib()
