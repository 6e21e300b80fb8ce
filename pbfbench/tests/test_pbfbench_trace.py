"""The trace arithmetic and the per-layer readers on a synthetic trace."""

import json

import pytest

from pbfbench import harness, trace


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _trace(tmp_path):
    events = [
        _ev("user_annotation", trace.WINDOW, 100.0, 100.0),  # window 100-200
        _ev("kernel", "void window_kernel<(Pass)0, 2>(Launch)", 90.0, 20.0),
        _ev("kernel", "void window_kernel<(Pass)0, 2>(Launch)", 110.0, 20.0),
        _ev("kernel", "void at::native::fill(float)", 120.0, 20.0),
        _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 150.0, 10.0),
        _ev("kernel", "void project_tc_kernel<1, 1>(Launch)", 170.0, 10.0),
        _ev("kernel", "void sort_kernel()", 195.0, 10.0),
        _ev("cuda_runtime", "cudaStreamSynchronize", 140.0, 12.0),
        _ev("cpu_op", "aten::copy_", 139.0, 30.0),
        _ev("cpu_op", "aten::zeros", 181.0, 12.0),
        _ev("gpu_user_annotation", trace.WINDOW, 100.0, 100.0),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return path


def test_busy_idle_and_gaps(tmp_path):
    w = trace.window(trace.load(_trace(tmp_path)))
    assert (w.start, w.end) == (100.0, 200.0)
    # the kernel that starts before the window does not count
    assert len(w.device) == 5
    assert trace.busy_intervals(w) == [(110.0, 140.0), (150.0, 160.0),
                                       (170.0, 180.0), (195.0, 200.0)]
    assert trace.busy_us(w) == 55.0
    assert trace.gaps(w) == [(100.0, 110.0), (140.0, 150.0), (160.0, 170.0),
                             (180.0, 195.0)]
    assert trace.host_labels(w, trace.gaps(w)) == [
        "host idle", "cudaStreamSynchronize", "aten::copy_", "aten::zeros"]
    assert trace.top_gaps(w)[0] == ["aten::zeros", pytest.approx(15e-6)]
    assert trace.top_device_ops(w)[0][0].startswith("window_kernel<")
    assert trace.window([_ev("kernel", "k", 0.0, 1.0)]) is None


def test_the_readers_on_the_trace(tmp_path):
    w = trace.window(trace.load(_trace(tmp_path)))
    t = harness.Traced(w, calls=2, steps=4)
    t.pairs_per_step = 1e6
    ctx = harness.Context(n=1000, iters=3, trace=t, window_s=3e-4,
                          calls_ms=[0.07] * 4, card="NVIDIA H100 80GB HBM3")
    read = {name: harness.reader(name)(ctx) for name in (
        "device_idle_pct", "host_gap_ms_per_frame", "kernels_per_step",
        "small_kernel_ms_per_step", "pair_roofline", "step_mfu")}
    assert read["device_idle_pct"] == pytest.approx(45.0)
    # 75 us a frame on the host clock, 55 / 2 us of it busy
    assert read["host_gap_ms_per_frame"] == pytest.approx(75e-3 - 27.5e-3)
    assert read["kernels_per_step"] == 4 / 4
    # the fill and the sort, each whole: 20 + 10 us
    assert read["small_kernel_ms_per_step"] == pytest.approx(30e-3 / 4)
    least = 1e6 * 3 * 36 / 67e12
    assert read["pair_roofline"] == pytest.approx(100 * least * 4 / 30e-6)
    assert read["step_mfu"] == pytest.approx(100 * least * 4 / 100e-6)


def test_the_readers_find_nothing_without_a_trace():
    ctx = harness.Context(n=1000, iters=3, trace=None, window_s=0.0,
                          calls_ms=[], card="cpu")
    for name in ("device_idle_pct", "host_gap_ms_per_frame",
                 "kernels_per_step", "small_kernel_ms_per_step",
                 "pair_roofline", "step_mfu"):
        assert harness.reader(name)(ctx) is None
