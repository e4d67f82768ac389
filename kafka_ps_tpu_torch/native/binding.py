"""ctypes binding for the native CSV parser (counterpart of
kafka_ps_tpu/native/binding.py).

`csvparse.cpp` is compiled at first use with g++ into
`kafka_ps_tpu_torch/_build/libkpscsv-<hash>.so`, the hash taken over the
source and the flags, so an edited source rebuilds and an unchanged one
is reused.  Several processes may load the parser at once (test
workers, a producer per run): the build holds an `fcntl` lock on a file
in the build directory, compiles to a temporary name and `os.replace`s
it into place, so no process ever loads half a library.

Without a C++ compiler on PATH (and no library built yet)
`is_available()` is False and data/stream.py parses in Python.  With a
compiler present a failed build raises with g++'s output: nothing turns
the parser off quietly.
"""

from __future__ import annotations

import ctypes
import dataclasses
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "csvparse.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lock = threading.Lock()
_lib = None


class _ParsedCsv(ctypes.Structure):
    _fields_ = [
        ("num_rows", ctypes.c_long),
        ("nnz", ctypes.c_long),
        ("num_features", ctypes.c_long),
        ("row_offsets", ctypes.POINTER(ctypes.c_long)),
        ("keys", ctypes.POINTER(ctypes.c_int)),
        ("vals", ctypes.POINTER(ctypes.c_float)),
        ("labels", ctypes.POINTER(ctypes.c_int)),
    ]


def library_path() -> str:
    """Where the library of the current source and flags lives (in
    BUILD_DIR as it is set at the call)."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0")
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libkpscsv-{digest.hexdigest()[:16]}.so")


def _build(cxx: str, out: str) -> None:
    """Compile the source into `out` under a cross-process lock; a
    process that waited on the lock finds the library built and
    returns."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "libkpscsv.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):
            return
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(
                f"native CSV parser build failed: {cxx} exited "
                f"{proc.returncode}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)   # atomic: a reader never sees half a file


def _load():
    """The loaded library, built first if needed; None without a C++
    compiler and without a built library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not os.path.exists(out):
            cxx = shutil.which("g++")
            if cxx is None:
                return None
            _build(cxx, out)
        lib = ctypes.CDLL(out)
        lib.kps_parse_csv.restype = ctypes.POINTER(_ParsedCsv)
        lib.kps_parse_csv.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.kps_free.restype = None
        lib.kps_free.argtypes = [ctypes.POINTER(_ParsedCsv)]
        _lib = lib
        return _lib


def is_available() -> bool:
    """True when the parser is loaded (building it if needed); False
    without a C++ compiler.  Raises if the build fails."""
    return _load() is not None


@dataclasses.dataclass(frozen=True)
class NativeCsv:
    """CSR view of a parsed CSV: row i's nonzeros are
    keys[row_offsets[i]:row_offsets[i+1]] (zero features dropped);
    labels[i] is the last column."""

    row_offsets: np.ndarray   # [num_rows + 1] int64
    keys: np.ndarray          # [nnz] int32
    vals: np.ndarray          # [nnz] float32
    labels: np.ndarray        # [num_rows] int32
    num_features: int

    @property
    def num_rows(self) -> int:
        return len(self.labels)

    def row(self, i: int) -> tuple[dict[int, float], int]:
        """Row i as (sparse features, label), Python ints and floats (a
        float32 value widened exactly)."""
        lo, hi = self.row_offsets[i], self.row_offsets[i + 1]
        return (dict(zip(self.keys[lo:hi].tolist(),
                         self.vals[lo:hi].tolist())),
                int(self.labels[i]))

    def to_dense(self) -> tuple[np.ndarray, np.ndarray]:
        x = np.zeros((self.num_rows, self.num_features), np.float32)
        rows = np.repeat(np.arange(self.num_rows),
                         np.diff(self.row_offsets))
        x[rows, self.keys] = self.vals
        return x, self.labels.copy()


def parse_csv(path: str, has_header: bool = True) -> NativeCsv:
    """One-pass native parse; raises RuntimeError if the parser is
    unavailable or the file is malformed (callers gate on
    is_available() and fall back to the Python parser)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native CSV parser unavailable (no C++ compiler)")
    p = lib.kps_parse_csv(path.encode(), 1 if has_header else 0)
    if not p:
        raise RuntimeError(f"native parse failed for {path}")
    try:
        c = p.contents
        n, nnz = c.num_rows, c.nnz
        out = NativeCsv(
            row_offsets=np.ctypeslib.as_array(c.row_offsets,
                                              (n + 1,)).copy(),
            keys=np.ctypeslib.as_array(c.keys, (max(nnz, 1),))[:nnz].copy(),
            vals=np.ctypeslib.as_array(c.vals, (max(nnz, 1),))[:nnz].copy(),
            labels=np.ctypeslib.as_array(c.labels,
                                         (max(n, 1),))[:n].copy(),
            num_features=int(c.num_features),
        )
    finally:
        lib.kps_free(p)
    return out
