"""ctypes bindings for the native IO runtime (port of base_tpu.io.native).

The C++ source is the port's own copy, `basetpu_io.cpp` beside this
module.  On first use it is compiled with g++ (`-O3 -std=c++17 -fPIC
-shared -lpthread`) into `base_tpu_torch/_build/` (git-ignored) under a name
keyed on a hash of the source and the flags, as ops/build.py keys the CUDA
library, and loaded with ctypes.  Exposes:
  parse_table(path) -> (np.ndarray [rows, cols] float64, header | None)
  AsyncWriter(path) -> non-blocking append-only line writer
Falls back to pure-numpy implementations when the library cannot be
built, so the framework never hard-requires the native component;
`native_available()` says whether the library runs.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "basetpu_io.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
_lib = None
_lib_lock = threading.Lock()


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libbtt_io_{h.hexdigest()[:16]}.so"


def _build() -> Path:
    """Compile the source unless its library exists; raise on failure."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++, c++) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        so = Path(tmp) / out.name
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(so), str(SOURCE),
                        "-lpthread"], check=True, capture_output=True,
                       timeout=120)
        os.replace(so, out)  # atomic: a concurrent build sees all or none
    return out


def _load() -> ctypes.CDLL | None:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, RuntimeError, subprocess.SubprocessError):
            return None
        lib.basetpu_parse_table.restype = ctypes.c_void_p
        lib.basetpu_parse_table.argtypes = [ctypes.c_char_p]
        lib.basetpu_table_rows.restype = ctypes.c_int64
        lib.basetpu_table_rows.argtypes = [ctypes.c_void_p]
        lib.basetpu_table_cols.restype = ctypes.c_int64
        lib.basetpu_table_cols.argtypes = [ctypes.c_void_p]
        lib.basetpu_table_header.restype = ctypes.c_char_p
        lib.basetpu_table_header.argtypes = [ctypes.c_void_p]
        lib.basetpu_table_copy.restype = None
        lib.basetpu_table_copy.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)
        ]
        lib.basetpu_table_free.restype = None
        lib.basetpu_table_free.argtypes = [ctypes.c_void_p]
        lib.basetpu_writer_open.restype = ctypes.c_void_p
        lib.basetpu_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.basetpu_writer_write.restype = None
        lib.basetpu_writer_write.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64
        ]
        lib.basetpu_writer_pending.restype = ctypes.c_int64
        lib.basetpu_writer_pending.argtypes = [ctypes.c_void_p]
        lib.basetpu_writer_close.restype = None
        lib.basetpu_writer_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def parse_table(path: str) -> tuple[np.ndarray, str | None]:
    """Parse a whitespace numeric table (optional header line / '#'
    comments).  Native fast path; numpy fallback."""
    lib = _load()
    if lib is None:
        return _parse_table_py(path)
    handle = lib.basetpu_parse_table(str(path).encode())
    if not handle:
        raise ValueError(f"failed to parse table: {path}")
    try:
        rows = lib.basetpu_table_rows(handle)
        cols = lib.basetpu_table_cols(handle)
        out = np.empty((rows, cols), np.float64)
        if rows and cols:
            lib.basetpu_table_copy(
                handle,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            )
        hdr = lib.basetpu_table_header(handle)
        header = hdr.decode().strip() if hdr else None
        return out, header
    finally:
        lib.basetpu_table_free(handle)


def _parse_table_py(path: str) -> tuple[np.ndarray, str | None]:
    header = None
    rows = []
    with open(path) as f:
        for line in f:
            s = line.strip()
            if not s or s.startswith("#"):
                continue
            try:
                rows.append([float(x) for x in s.split()])
            except ValueError:
                if header is None and not rows:
                    header = s
                else:
                    raise
    return np.asarray(rows, np.float64), header


class AsyncWriter:
    """Non-blocking append-only line writer (native thread when
    available, direct writes otherwise)."""

    def __init__(self, path: str, append: bool = False):
        self._lib = _load()
        self._handle = None
        self._fh = None
        if self._lib is not None:
            self._handle = self._lib.basetpu_writer_open(
                str(path).encode(), 1 if append else 0
            )
        if not self._handle:
            self._lib = None
            self._fh = open(path, "ab" if append else "wb")

    def write(self, line: str) -> None:
        data = line.encode()
        if self._lib is not None:
            self._lib.basetpu_writer_write(self._handle, data, len(data))
        else:
            self._fh.write(data)

    def pending(self) -> int:
        if self._lib is not None:
            return int(self._lib.basetpu_writer_pending(self._handle))
        return 0

    def close(self) -> None:
        if self._lib is not None and self._handle:
            self._lib.basetpu_writer_close(self._handle)
            self._handle = None
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
