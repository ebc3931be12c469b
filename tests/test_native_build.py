"""The native runtime libraries build from their tracked sources.

No binary is tracked: each is compiled with g++ at first use on the host
that runs it. These tests build each into a temporary directory and load
the result.
"""
import ctypes

import numpy as np

from gravinv3dhmc.runtime import sink, tessglq


def test_tessglq_builds_from_source(tmp_path):
    out = str(tmp_path / "libtessglq.so")
    tessglq._build(out)
    lib = ctypes.CDLL(out)
    for sym in ("tessglq_kernel_matrix", "tessglq_kernel_pairs",
                "tessglq_subdiv_count", "tessglq_subdiv_fill"):
        assert hasattr(lib, sym), sym
    lib.tessglq_num_threads.restype = ctypes.c_int
    assert lib.tessglq_num_threads() >= 1


def test_gravsink_builds_from_source(tmp_path):
    out = str(tmp_path / "libgravsink.so")
    sink._build(out)
    lib = ctypes.CDLL(out)
    lib.gravsink_open.restype = ctypes.c_void_p
    lib.gravsink_open.argtypes = [ctypes.c_char_p]
    lib.gravsink_append.restype = None
    dptr = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.gravsink_append.argtypes = [ctypes.c_void_p, dptr, ctypes.c_int64,
                                    dptr, ctypes.c_int64]
    lib.gravsink_close.restype = None
    lib.gravsink_close.argtypes = [ctypes.c_void_p]
    folder = tmp_path / "chain0"
    h = lib.gravsink_open(str(folder).encode())
    assert h
    model = np.arange(3, dtype=np.float64)
    row = np.ones(7, dtype=np.float64)
    lib.gravsink_append(h, model, model.size, row, row.size)
    lib.gravsink_close(h)
    written = np.loadtxt(folder / "model.dat", ndmin=2)
    np.testing.assert_allclose(written, model[None, :])
