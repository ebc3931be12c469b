"""The trace reduction of tools/trace_chunk.py on hand-made events."""
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

import trace_chunk  # noqa: E402


def test_split_busy_idle_and_gemm_share():
    events = [
        ("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n", 0, 100),
        ("loop_add_fusion", 50, 150),          # overlaps the first
        ("cutlass_80_tensorop_s1688gemm", 200, 260),
        ("input_reduce_fusion", 300, 340),
    ]
    sp = trace_chunk.split(events)
    assert sp["window_ns"] == 340
    assert sp["busy_ns"] == 150 + 60 + 40
    assert sp["kernel_ns"] == 100 + 100 + 60 + 40
    assert sp["gemm_ns"] == 160
    assert sp["per_kernel_ns"]["loop_add_fusion"] == 100


def test_split_rejects_an_empty_trace():
    with pytest.raises(ValueError):
        trace_chunk.split([])
