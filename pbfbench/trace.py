"""Arithmetic on a torch.profiler Chrome trace of the benchmark's window.

The window is the host annotation WINDOW that the benchmark opens before the
traced calls and closes after their final synchronize, so its span holds
every moment the device could have worked for those calls. Device activity
is every kernel, copy and memset; their intervals are merged (the busy time),
clipped to the window, and the rest of the window is idle. Each idle gap is
labelled with what the host was doing in it: the host event that overlaps
the gap most, the shortest one on a tie.
"""

from __future__ import annotations

import heapq
import json
import re
from pathlib import Path
from typing import NamedTuple

WINDOW = "pbfbench window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")
NAME_CHARS = 120


class Op(NamedTuple):
    cat: str
    name: str
    start: float   # microseconds
    end: float


class Window(NamedTuple):
    start: float
    end: float
    device: list[Op]   # device activity that starts inside the window
    host: list[Op]     # host events that overlap it, the window excluded

    @property
    def span_us(self) -> float:
        return self.end - self.start


def load(path: str | Path) -> list[dict]:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def window(events: list[dict]) -> Window | None:
    """The traced window, or None if the trace has no WINDOW annotation."""
    marks = [e for e in events if e.get("name") == WINDOW
             and e.get("cat") == "user_annotation" and "dur" in e]
    if not marks:
        return None
    start = min(float(e["ts"]) for e in marks)
    end = max(float(e["ts"]) + float(e["dur"]) for e in marks)
    device, host = [], []
    for e in events:
        if "dur" not in e or e.get("ph") != "X":
            continue
        op = Op(e.get("cat", ""), e.get("name", ""), float(e["ts"]),
                float(e["ts"]) + float(e["dur"]))
        if op.cat in DEVICE_CATS and start <= op.start < end:
            device.append(op)
        elif op.cat in HOST_CATS and op.name != WINDOW \
                and op.start < end and op.end > start:
            host.append(op)
    return Window(start, end, device, host)


def busy_intervals(w: Window) -> list[tuple[float, float]]:
    """The device's activity merged into disjoint intervals, clipped to the
    window."""
    iv = sorted((op.start, min(op.end, w.end)) for op in w.device)
    merged: list[list[float]] = []
    for s, e in iv:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_us(w: Window) -> float:
    return sum(e - s for s, e in busy_intervals(w))


def gaps(w: Window) -> list[tuple[float, float]]:
    """The window's idle intervals, in time order."""
    out, at = [], w.start
    for s, e in busy_intervals(w):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if w.end > at:
        out.append((at, w.end))
    return out


def host_labels(w: Window, spans: list[tuple[float, float]]) -> list[str]:
    """What the host was doing in each of `spans` (disjoint, in time
    order): the host event that overlaps the span most, the shortest on a
    tie, or "host idle". One sweep over the host events by start time, with
    those still open in a heap by end time."""
    ops = sorted(w.host, key=lambda op: op.start)
    open_ops: list[tuple[float, int]] = []
    labels, k = [], 0
    for a, b in spans:
        while k < len(ops) and ops[k].start < b:
            heapq.heappush(open_ops, (ops[k].end, k))
            k += 1
        while open_ops and open_ops[0][0] <= a:
            heapq.heappop(open_ops)
        best, key = "host idle", (0.0, 0.0)
        for _, i in open_ops:
            op = ops[i]
            overlap = min(op.end, b) - max(op.start, a)
            if overlap > 0 and (overlap, op.start - op.end) > key:
                best, key = op.name, (overlap, op.start - op.end)
        labels.append(best)
    return labels


def kernels(w: Window) -> list[Op]:
    return [op for op in w.device if op.cat == "kernel"]


def matching(ops: list[Op], patterns: tuple[str, ...]) -> list[Op]:
    rx = re.compile("|".join(patterns))
    return [op for op in ops if rx.search(op.name)]


def short_name(name: str) -> str:
    """A kernel's demangled name without its return type, cut to
    NAME_CHARS characters."""
    name = name.removeprefix("void ")
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS] + "..."


def top_device_ops(w: Window, count: int = 10) -> list[list]:
    """[[name, seconds], ...]: device time by operation name, most first
    (names shortened once summed)."""
    by: dict[str, float] = {}
    for op in w.device:
        by[op.name] = by.get(op.name, 0.0) + (op.end - op.start) / 1e6
    return [[short_name(k), v] for k, v in
            sorted(by.items(), key=lambda kv: -kv[1])[:count]]


def top_gaps(w: Window, count: int = 10) -> list[list]:
    """[[host label, seconds], ...]: the window's idle time by what the host
    was doing, most first."""
    by: dict[str, float] = {}
    spans = gaps(w)
    for g, label in zip(spans, host_labels(w, spans)):
        by[label] = by.get(label, 0.0) + (g[1] - g[0]) / 1e6
    return [[k, v] for k, v in
            sorted(by.items(), key=lambda kv: -kv[1])[:count]]
