"""ctypes bindings for the native gravsink runtime library.

Builds ``libgravsink.so`` on first use (g++, no external deps) and exposes:

* :class:`SampleSink` — double-buffered background writer for the
  reference-format ``model.dat`` / ``misfit.dat`` sample streams, so the
  device sampling loop never blocks on disk IO;
* :func:`read_matrix` — fast whitespace-float matrix loader for the
  posterior-statistics pass (np.loadtxt replacement).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "native", "gravsink.cpp")
_LIB_PATH = os.path.join(_HERE, "native", "libgravsink.so")
_lock = threading.Lock()
_lib = None


def _build(out_path=_LIB_PATH):
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", _SRC,
           "-o", out_path, "-lpthread"]
    subprocess.run(cmd, check=True, capture_output=True)


def get_lib():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if (not os.path.exists(_LIB_PATH)
                or os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC)):
            _build()
        lib = ctypes.CDLL(_LIB_PATH)
        lib.gravsink_open.restype = ctypes.c_void_p
        lib.gravsink_open.argtypes = [ctypes.c_char_p]
        lib.gravsink_append.restype = None
        lib.gravsink_append.argtypes = [
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
        ]
        lib.gravsink_flush.restype = None
        lib.gravsink_flush.argtypes = [ctypes.c_void_p]
        lib.gravsink_close.restype = None
        lib.gravsink_close.argtypes = [ctypes.c_void_p]
        lib.gravsink_count_matrix.restype = ctypes.c_int64
        lib.gravsink_count_matrix.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64)]
        lib.gravsink_read_matrix.restype = ctypes.c_int64
        lib.gravsink_read_matrix.argtypes = [
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_int64, ctypes.c_int64]
        _lib = lib
        return _lib


class SampleSink:
    """Background-threaded append writer (reference file format,
    inversion/hmc.py:241-249)."""

    def __init__(self, folder):
        self.folder = folder
        os.makedirs(folder, exist_ok=True)
        self._lib = get_lib()
        self._handle = self._lib.gravsink_open(folder.encode())
        if not self._handle:
            raise OSError(f"gravsink_open failed for {folder}")

    def append(self, model, misfit_row):
        model = np.ascontiguousarray(model, dtype=np.float64)
        misfit_row = np.ascontiguousarray(misfit_row, dtype=np.float64)
        self._lib.gravsink_append(self._handle, model, model.size,
                                  misfit_row, misfit_row.size)

    def flush(self):
        self._lib.gravsink_flush(self._handle)

    def close(self):
        if self._handle:
            self._lib.gravsink_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def read_matrix(path):
    """Load a whitespace-delimited float matrix (model.dat/misfit.dat)."""
    lib = get_lib()
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    if lib.gravsink_count_matrix(path.encode(), ctypes.byref(rows),
                                 ctypes.byref(cols)) != 0:
        raise OSError(f"cannot open {path}")
    r, c = rows.value, cols.value
    if r == 0 or c == 0:
        return np.zeros((0, 0))
    out = np.empty(r * c, dtype=np.float64)
    n = lib.gravsink_read_matrix(path.encode(), out, r, c)
    if n != r * c:
        raise ValueError(f"{path}: parsed {n} values, expected {r}x{c}")
    return out.reshape(r, c)
