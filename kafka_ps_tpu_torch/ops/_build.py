"""Build step for the package's CUDA kernels.

Each source under `ops/csrc/` compiles with nvcc into a shared library
with a plain C interface, loaded with ctypes.  Builds happen at the
first CUDA call, never at import, into `kafka_ps_tpu_torch/_build/`
(listed in .gitignore); a library's file name carries a hash of its
source, of every header of `ops/csrc/` it includes (`#include "..."`,
followed through the headers' own includes) and of the flags, so an
edited source or header rebuilds and an unchanged one is reused.  A
failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "ops", "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# --split-compile=0: nvcc's and ptxas's optimizations run on as many
# threads as the host has CPUs
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0", "-Xptxas", "--split-compile=0")

_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)
_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# nvcc's output (ptxas register/shared-memory report) per source
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "kafka_ps_tpu_torch are built on first use with "
                       "the CUDA toolkit's nvcc")


def _closure(name: str) -> list[str]:
    """`name` and the files of CSRC it includes, directly or through
    another header, each once, in the order first met (a quoted include
    found elsewhere, such as a toolkit header, is left out)."""
    seen, todo = [], [name]
    while todo:
        n = todo.pop(0)
        if n in seen or not os.path.isfile(os.path.join(CSRC, n)):
            continue
        seen.append(n)
        with open(os.path.join(CSRC, n), "rb") as f:
            todo += [m.decode() for m in _INCLUDE.findall(f.read())]
    return seen


def _target(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC, name)
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for n in _closure(name):
        with open(os.path.join(CSRC, n), "rb") as f:
            digest.update(n.encode() + b"\0" + f.read())
    stem = os.path.splitext(name)[0]
    return src, os.path.join(BUILD_DIR,
                             f"lib{stem}-{digest.hexdigest()[:16]}.so")


def build(names: list[str]) -> None:
    """Compile every named source that has no current library, one nvcc
    process per source, all started together.  Raises on any failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in names:
        src, out = _target(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)    # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_target(name)[1])
            _libs[name] = lib
        return lib


def sources() -> list[str]:
    return sorted(n for n in os.listdir(CSRC) if n.endswith(".cu"))
