"""Device timing on the card.

Kernel launches return before the device finishes, so a host clock alone
measures the enqueue: `fence` waits for the device, `cuda_ms` times work
with CUDA events recorded on the current stream, and `profile_kernels`
reads from a torch.profiler trace how busy the device was.
"""

from __future__ import annotations

import json
import statistics
from pathlib import Path

import torch


def fence(device: torch.device | str) -> None:
    """Wait until every queued kernel on `device` has finished."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def cuda_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Median milliseconds of `fn()` on the current CUDA stream, each rep
    bracketed by its own pair of events."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


# the annotation that opens the window a profile reads
WINDOW = "profiled window"


def profile_kernels(fn, trace: str | Path, before=None) -> dict:
    """Run `fn()` under torch.profiler (CPU and CUDA activity), fenced,
    write the Chrome trace to `trace`, and return what it says of the
    card's kernels (`kernel_busy`) from the start of `fn`. `before()`, when
    given, runs first under the running profiler and outside that window:
    a barrier there lines several ranks up after each has started its
    profiler, so that no rank reads another's late start as its own wait."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        if before is not None:
            before()
        with torch.profiler.record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace))
    return kernel_busy(trace)


def kernel_busy(trace: str | Path) -> dict:
    """The kernels of a Chrome trace: their count, the sum of their
    durations (`kernel_ms`), the span from the first one's start to the
    last one's end, the device's busy time in it (the kernels' intervals
    merged) and its share of the span, and (count, ms) by kernel name,
    longest first. Where the trace holds the host's WINDOW annotation,
    only the kernels that start after it opened count. Without kernels in
    the trace every time is None."""
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    opened = [e["ts"] for e in events if e.get("name") == WINDOW
              and not str(e.get("cat", "")).startswith("gpu")]
    if opened:
        kern = [e for e in kern if e["ts"] >= min(opened)]
    if not kern:
        return {"kernels": 0, "kernel_ms": None, "span_ms": None,
                "busy_ms": None, "busy_share": None, "by_name": []}
    iv = sorted((e["ts"], e["ts"] + e["dur"]) for e in kern)
    busy, cur_s, cur_e = 0.0, iv[0][0], iv[0][1]
    for s, e in iv[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = max(e for _, e in iv) - iv[0][0]
    by: dict[str, list] = {}
    for e in kern:
        by.setdefault(e["name"], [0, 0.0])
        by[e["name"]][0] += 1
        by[e["name"]][1] += e["dur"] / 1e3
    return {"kernels": len(kern),
            "kernel_ms": sum(e["dur"] for e in kern) / 1e3,
            "span_ms": span / 1e3, "busy_ms": busy / 1e3,
            "busy_share": busy / span if span > 0 else None,
            "by_name": sorted(((k, c, ms) for k, (c, ms) in by.items()),
                              key=lambda r: -r[2])}
