"""Build the port's CUDA sources with nvcc on first use; load with ctypes.

The sources in ``gaml_tpu_torch/csrc`` compile, one nvcc process each and
all at once, into objects linked into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds).
The library lands in ``gaml_tpu_torch/_build`` under a name derived from
the sources' content, so an edited source rebuilds and concurrent
processes share one finished build.  Nothing here runs at import time.

``launch`` is the one call of a kernel entry point ``gaml_<name>``;
``check_tiles`` holds a wrapper's constants to its source's on first use.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("band_dp.cu", "banded_forward.cu", "candgen.cu", "rescore.cu",
           "seeds.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
_tiles_checked = set()  # sources whose constants check_tiles has held
# what the last load() did: library path, build seconds (0.0 when an
# existing build was reused) and the compiler's output (-Xptxas -v)
build_info = {"path": None, "seconds": None, "log": ""}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels build where the CUDA toolkit is")


def _library_path(srcs) -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libgaml_torch_{h.hexdigest()[:16]}.so")


def _compile(srcs, so: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in srcs]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, s]
            for s, o in zip(srcs, objs)]
    cmds.append([nvcc, "-shared", "-o", f"{tmp}.so", *objs])
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds[:-1]]
    log = []
    try:
        for cmd, proc in zip(cmds, procs):
            out, _ = proc.communicate()
            log.append(out)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{out}")
        proc = subprocess.run(cmds[-1], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(f"{tmp}.so", so)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    build_info["seconds"] = time.perf_counter() - t0
    build_info["log"] = "".join(log)


def load():
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        srcs = [os.path.join(CSRC, s) for s in SOURCES]
        so = _library_path(srcs)
        build_info["seconds"] = 0.0
        if not os.path.exists(so):
            _compile(srcs, so)
        lib = ctypes.CDLL(so)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gaml_swar_cost.argtypes = [p, p, p, p, i, i, p, p]
        lib.gaml_swar_cost.restype = i
        lib.gaml_swar_cost_accept.argtypes = [p, p, p, p, i, i, p, p, p]
        lib.gaml_swar_cost_accept.restype = i
        lib.gaml_dp_rows_exact.argtypes = [p, p, p, p, i, i, p, p, p]
        lib.gaml_dp_rows_exact.restype = i
        lib.gaml_extend_exact.argtypes = [p] * 9 + [i, i, i] + [p] * 4
        lib.gaml_extend_exact.restype = i
        lib.gaml_extend_exact_staged.argtypes = [p] * 12 + [i, i] + [p] * 4
        lib.gaml_extend_exact_staged.restype = i
        lib.gaml_exact_scratch.argtypes = [i, i]
        lib.gaml_exact_scratch.restype = i
        lib.gaml_banded_forward.argtypes = [p, i, i, p, p, i, p, i, p, p, p,
                                            p, i, i, ctypes.c_float,
                                            ctypes.c_float, p, p]
        lib.gaml_banded_forward.restype = i
        ll = ctypes.c_longlong
        lib.gaml_candgen_ws_words.argtypes = [i]
        lib.gaml_candgen_ws_words.restype = ll
        lib.gaml_candgen_scratch_bytes.argtypes = [i, i]
        lib.gaml_candgen_scratch_bytes.restype = ll
        lib.gaml_candgen_runs.argtypes = [p, p, p, i, i, i, p, p, p, i, p, p,
                                          p]
        lib.gaml_candgen_runs.restype = i
        lib.gaml_candgen_sort.argtypes = [p, i, p, p, p] + [i] * 4 + [p] * 3
        lib.gaml_candgen_sort.restype = i
        d = ctypes.c_double
        lib.gaml_rescore_dedup_sums.argtypes = [p] * 7 + [ll, ll, d, d] + \
            [p] * 5
        lib.gaml_rescore_dedup_sums.restype = i
        lib.gaml_rescore_reduce.argtypes = [p, p, ll, i, p, d, d, d] + [p] * 5
        lib.gaml_rescore_reduce.restype = i
        lib.gaml_seeds_index.argtypes = [p, p, p, i, i, i] + [p] * 9
        lib.gaml_seeds_index.restype = i
        lib.gaml_seeds_count.argtypes = [p, ll, p, p, p, i, ll] + [p] * 8
        lib.gaml_seeds_count.restype = i
        lib.gaml_seeds_expand.argtypes = [p, i, ll] + [p] * 5 + [ll, p, p, p]
        lib.gaml_seeds_expand.restype = i
        build_info["path"] = so
        _lib = lib
        return lib


def check_tiles(source: str, tiles: dict) -> None:
    """Raise unless each ``gaml_<name>()`` of the library returns
    ``tiles[name]``: the constants a wrapper shares with csrc/``source``.
    Runs once a source."""
    if source in _tiles_checked:
        return
    lib = load()
    got = {}
    for name in tiles:
        getter = getattr(lib, "gaml_" + name)
        getter.argtypes, getter.restype = [], ctypes.c_int
        got[name] = getter()
    if got != tiles:
        raise RuntimeError(f"csrc/{source}'s tiles differ from the "
                           f"wrapper's")
    _tiles_checked.add(source)


def launch(name: str, device, *args) -> None:
    """Call the kernel entry point ``gaml_<name>`` with ``args`` on
    ``device``'s current CUDA stream: a tensor passes as its data pointer,
    None as a null pointer, the rest as they are (the argtypes load()
    declares convert them).  Raises RuntimeError on a CUDA error."""
    import torch

    entry = getattr(load(), "gaml_" + name)
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
             for a in args]
    here = device.index is None or device.index == torch.cuda.current_device()
    with contextlib.nullcontext() if here else torch.cuda.device(device):
        err = entry(*cargs, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
