"""The rank cell's per-layer readers on a synthetic trace of two ranks, each
a hand-written Chrome trace read as a run's process reads the ranks'."""

import json

import pytest

from pbfbench import harness, trace, work

RANK_METRICS = ("nccl_ms_per_step", "balance_min_over_mean",
                "rank_pair_roofline", "rank_step_mfu",
                "rank_kernels_per_step", "rank_device_idle_pct")
PAIRS = 1e6   # pairs within h a step, as the census counts them
STEPS = 2


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


RANK_EVENTS = [
    [   # rank 0: window 100-200 us
        _ev("user_annotation", trace.WINDOW, 100.0, 100.0),
        _ev("kernel", "void window_kernel<(Pass)0, 2>(Launch)", 110.0, 20.0),
        _ev("kernel", "void project_tc_kernel<1, 1>(Launch)", 130.0, 10.0),
        _ev("kernel", "ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgs)",
            150.0, 20.0),
        _ev("kernel", "void at::native::fill(float)", 170.0, 5.0),
        _ev("cuda_runtime", "cudaGraphLaunch", 140.0, 8.0),
    ],
    [   # rank 1: window 0-100 us
        _ev("user_annotation", trace.WINDOW, 0.0, 100.0),
        _ev("kernel", "void window_kernel<(Pass)2, 2>(Launch)", 10.0, 40.0),
        _ev("kernel", "ncclDevKernel_SendRecv(ncclDevKernelArgs)", 60.0, 10.0),
        _ev("kernel", "void sort_kernel()", 80.0, 10.0),
        _ev("kernel", "void window_kernel<(Pass)0, 2>(Launch)", 95.0, 10.0),
    ],
]


def _ctx(tmp_path, events=RANK_EVENTS):
    ranks = []
    for r, evs in enumerate(events):
        path = tmp_path / f"rank{r}.json"
        path.write_text(json.dumps({"traceEvents": evs}))
        t = harness.Traced(trace.window(trace.load(path)), 1, STEPS)
        t.pairs_per_step = PAIRS
        ranks.append(t)
    return harness.Context(n=1000, iters=3, trace=None, ranks=ranks,
                           card="NVIDIA H100 80GB HBM3", window_s=0.0,
                           calls_ms=[])


def test_the_rank_readers_on_two_ranks(tmp_path):
    read = {m: harness.reader(m)(_ctx(tmp_path)) for m in RANK_METRICS}
    # NCCL: 20 us on rank 0, 10 us on rank 1, over 2 steps each
    assert read["nccl_ms_per_step"] == pytest.approx((10e-3 + 5e-3) / 2)
    # pair kernels a step: rank 0 (20 + 10) / 2 us, rank 1 (40 + 10) / 2:
    # the kernel that starts at 95 us counts whole, as the single card's
    # readers count it
    pair = [15e-6, 25e-6]
    assert read["balance_min_over_mean"] == pytest.approx(15 / 20)
    peak = work.peaks("NVIDIA H100 80GB HBM3")
    least = PAIRS * 3 * 36 / (2 * peak["fp32_flop_per_s"])
    assert read["rank_pair_roofline"] == pytest.approx(
        100 * least / (sum(pair) / 2))
    # the wall a step: 100 us / 2 steps on both
    assert read["rank_step_mfu"] == pytest.approx(100 * least / 50e-6)
    assert read["rank_kernels_per_step"] == pytest.approx((4 / 2 + 4 / 2) / 2)
    # busy: rank 0 110-140 and 150-175 (55 of 100 us); rank 1 10-50, 60-70,
    # 80-90 and 95-100 (clipped at the window's end: 65)
    assert read["rank_device_idle_pct"] == pytest.approx((45 + 35) / 2)


def test_the_rank_readers_find_nothing_without_ranks(tmp_path):
    single = harness.Context(n=1000, iters=3, trace=None, window_s=0.0,
                             calls_ms=[], card="NVIDIA H100 80GB HBM3")
    no_device = _ctx(tmp_path, [[e for e in evs if e["cat"] != "kernel"]
                                for evs in RANK_EVENTS])
    for m in RANK_METRICS:
        assert harness.reader(m)(single) is None
        assert harness.reader(m)(no_device) is None, m


def test_the_single_card_readers_find_nothing_in_a_rank_run(tmp_path):
    ctx = _ctx(tmp_path)
    for m in ("pair_roofline", "step_mfu", "kernels_per_step",
              "device_idle_pct", "small_kernel_ms_per_step"):
        assert harness.reader(m)(ctx) is None
