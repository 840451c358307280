"""Build and load the port's CUDA kernels (``hidenn_fem_tpu_torch/csrc``).

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for sm_90a into its own
shared library with a plain C interface, loaded with ctypes.  The sources
are compiled in parallel, one ``nvcc`` each, at first use.  Every library
name carries one hash of all sources and headers (``*.cu``, ``*.cuh``),
so an edit to any of them rebuilds them all.  The libraries go to
``csrc/build/`` (gitignored).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["build_kernels", "library", "raise_on"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = _CSRC / "build"


def _nvcc() -> str:
    """nvcc from PATH, else from $CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME): the port's "
                       "kernels are built from source with the CUDA toolkit")


def _tag() -> str:
    h = hashlib.sha256()
    for p in sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_kernels() -> dict:
    """Compile every ``csrc/*.cu`` for sm_90a unless its library of the
    current sources is built already.

    Returns {"libraries": {stem: path}, "seconds", "log"} (log: the nvcc
    and ptxas output of each build, with the registers and spills of
    every kernel).  Raises with nvcc's output if any build fails."""
    tag = _tag()
    outs = {p.stem: _BUILD_DIR / f"lib{p.stem}_{tag}.so"
            for p in sorted(_CSRC.glob("*.cu"))}
    todo = {stem: out for stem, out in outs.items() if not out.exists()}
    result = {"libraries": {k: str(v) for k, v in outs.items()},
              "seconds": 0.0, "log": "cached" if not todo else ""}
    if not todo:
        return result
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for stem, out in todo.items():
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-I", str(_CSRC), "-o", str(tmp),
               str(_CSRC / f"{stem}.cu")]
        procs[stem] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for stem, (cmd, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        result["log"] += f"== {stem}.cu\n{log}"
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{log}")
        else:
            os.replace(tmp, todo[stem])
    if failed:
        raise RuntimeError("\n".join(failed))
    result["seconds"] = time.perf_counter() - t0
    return result


@functools.lru_cache(maxsize=None)
def library(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu`` (built on first use)."""
    lib = ctypes.CDLL(build_kernels()["libraries"][stem])
    lib.hdnn_error_string.argtypes = [ctypes.c_int]
    lib.hdnn_error_string.restype = ctypes.c_char_p
    return lib


def raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.hdnn_error_string(err).decode()}")
