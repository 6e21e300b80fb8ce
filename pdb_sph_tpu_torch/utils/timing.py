"""Device timing on the card, and the program's own trace marks.

Kernel launches return before the device finishes, so a host clock alone
measures the enqueue: `fence` waits for the device, `cuda_ms` times work
with CUDA events recorded on the current stream, and `profile_kernels`
reads from a torch.profiler trace how busy the device was.

A captured step records no host ranges when it replays, so its stages are
mapped at capture: `stage_map()` is the context that `core.step.CapturedStep`
enters around its capture, and `mark_stage(name)`, the step's default
`mark`, records there how many device-op nodes (kernels, memsets, memcpys)
the graph holds when the stage `name` ends. The result, one `Stage` per
range of node ordinals, is kept in a registry (`last_stage_map`) that
outlives the graph. A replay runs the nodes in capture order, so a trace's
device ops of one replay fall into the stages by their order.

`CounterSession` scopes the program's cumulative device counters
(`core.step.Stepper.counters`) to a torch.profiler session: the rollout
clones them when it first sees a session recording and again at its first
call after the session ended, and `last_session()` gives the difference
with the steps of those calls, and the mean host time of the rollout's
untraced calls before the session (the profiler's own cost per op would
swamp a traced call's). `spans(recording())` is the rollout's span: a
`record_function` while a session records, else one shared do-nothing
context.
"""

from __future__ import annotations

import contextlib
import ctypes
import itertools
import json
import statistics
import weakref
from pathlib import Path
from typing import Callable, NamedTuple

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


def recording() -> bool:
    """Whether a torch.profiler session is recording (one C++ check)."""
    return torch._C._autograd._profiler_enabled()


# ---------------------------------------------------------------------------
# the stage map of a captured step
# ---------------------------------------------------------------------------

class Stage(NamedTuple):
    """One stage of a captured step: the graph's device-op nodes with
    ordinals first .. first + count - 1, in capture order."""

    name: str
    first: int
    count: int


def stage_ranges(marks: list[tuple[str, int]]) -> list[Stage]:
    """[(stage name, device-op nodes in the graph when it ended)], in
    capture order -> the stages' node ranges. A stage that added no node
    is kept, with count 0."""
    out, at = [], 0
    for name, total in marks:
        if total < at:
            raise ValueError(f"node count fell from {at} to {total} at "
                             f"{name!r}")
        out.append(Stage(name, at, total - at))
        at = total
    return out


def graph_node_counts(graph: int | None = None, kernels=None
                      ) -> tuple[int, ...]:
    """(kernel, memset, memcpy, other) nodes of the CUDA graph `graph` (a
    `cudaGraph_t` as an int, e.g. `CUDAGraph.raw_cuda_graph()`), or when
    None of the graph that the current stream is capturing. Adds no node.
    `kernels` is the loaded kernel library (default: load it)."""
    if kernels is None:
        from .cuda_build import load_kernels

        kernels = load_kernels()
    counts = (ctypes.c_longlong * 4)()
    code = kernels.lib.pbf_graph_node_counts(
        torch.cuda.current_stream().cuda_stream, graph, counts)
    kernels.check(code, "pbf_graph_node_counts")
    return tuple(counts)


def device_nodes(counts: tuple[int, ...]) -> int:
    """The nodes of `graph_node_counts` that run as one device op each in a
    trace: kernels, memsets and memcpys."""
    return sum(counts[:3])


# what pbf_graph_node_counts returns for a stream that is not capturing
_NOT_CAPTURING = 906  # cudaErrorStreamCaptureImplicit


def _capture_counter() -> Callable[[], int]:
    """The device-op nodes of the graph under capture, as a function; the
    kernel library is loaded, and its query tried on the current stream,
    here, before any capture starts, so that neither can fail inside one."""
    from .cuda_build import load_kernels

    kernels = load_kernels()
    counts = (ctypes.c_longlong * 4)()
    code = kernels.lib.pbf_graph_node_counts(
        torch.cuda.current_stream().cuda_stream, None, counts)
    if code != _NOT_CAPTURING:
        kernels.check(code, "pbf_graph_node_counts before a capture")
    return lambda: device_nodes(graph_node_counts(kernels=kernels))


class _StageRecorder:
    def __init__(self, count: Callable[[], int]):
        self.count = count
        self.marks: list[tuple[str, int]] = []


# the stage map under way, if any (stage_map)
_recorder: _StageRecorder | None = None
# the stage map of the newest capture that named stages
_last_map: list[Stage] | None = None


@contextlib.contextmanager
def stage_map(count: Callable[[], int] | None = None):
    """Record the stages that `mark_stage` names inside this context into
    the yielded list, and, if any were named, as the `last_stage_map`.
    `count()` gives the device-op nodes of the graph under capture
    (default: `graph_node_counts` of the capturing stream, whose library is
    loaded and tried on entry); it is called only at a mark."""
    global _recorder, _last_map
    outer = _recorder
    _recorder = _StageRecorder(count or _capture_counter())
    stages: list[Stage] = []
    try:
        yield stages
        stages.extend(stage_ranges(_recorder.marks))
        if stages:
            _last_map = list(stages)
    finally:
        _recorder = outer


def mark_stage(name: str) -> None:
    """The end of stage `name`, recorded while a stream captures inside
    `stage_map()`; anywhere else it does nothing (one check)."""
    if _recorder is not None and torch.cuda.is_current_stream_capturing():
        _recorder.marks.append((name, _recorder.count()))


def last_stage_map() -> list[Stage] | None:
    """The stage map of the newest capture that named stages, or None. It
    outlives the graph (CapturedStep.release)."""
    return None if _last_map is None else list(_last_map)


# ---------------------------------------------------------------------------
# spans and counters scoped to a profiler session
# ---------------------------------------------------------------------------

_NO_SPAN = contextlib.nullcontext()


def no_span(_name: str) -> contextlib.nullcontext:
    """A span that records nothing: the shared do-nothing context."""
    return _NO_SPAN


def spans(recording: bool) -> Callable:
    """`torch.profiler.record_function` while a session records, else
    `no_span`."""
    return torch.profiler.record_function if recording else no_span


class CounterSession:
    """The cumulative device counters `counters` ({name: 0-dim int64
    tensor}) over the calls that a torch.profiler session records, and the
    host time of the calls before it. The owner calls `observe(recording(),
    steps)` once a call, before the call's work: at the first call that
    sees a session it clones the counters (one small device copy each), at
    the first call after the session ended it clones them again (or
    `last_session()` does, read after the session). Between those calls it
    only adds `steps` on the host. `time_call(seconds)` adds an untraced
    call's host time, which the session reports for the calls since the
    session before it."""

    def __init__(self, counters: dict[str, torch.Tensor]):
        self.counters = counters
        self.start: dict[str, torch.Tensor] | None = None
        self.steps = 0
        # untraced calls timed since the last session opened, their seconds
        self.host = (0, 0.0)
        self.before = (0, 0.0)

    def time_call(self, seconds: float) -> None:
        self.host = (self.host[0] + 1, self.host[1] + seconds)

    def observe(self, recording: bool, steps: int) -> None:
        if recording and self.start is None:
            self.start = _snapshot(self.counters)
            self.steps = 0
            self.before, self.host = self.host, (0, 0.0)
            self.opened = next(_opened)
            _open.add(self)
        elif not recording and self.start is not None:
            self.close()
        if recording:
            self.steps += steps

    def close(self) -> None:
        global _last
        if self.start is None:
            return
        # a session closed late (read after another rollout's) is not
        # the last one
        if _last is None or self.opened > _last[0]:
            _last = (self.opened, self.steps, self.start,
                     _snapshot(self.counters), self.before)
        self.start = None
        _open.discard(self)


def _snapshot(counters: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {k: v.clone() for k, v in counters.items()}


# the sessions that live rollouts opened and have not closed, and the
# order in which sessions opened
_open: weakref.WeakSet[CounterSession] = weakref.WeakSet()
_opened = itertools.count()
# the session opened last of those closed: (its order, steps, counters at
# its start, counters at its end, (untraced calls timed before it, their
# host seconds))
_last: tuple[int, int, dict, dict, tuple[int, float]] | None = None


def last_session() -> dict | None:
    """On the host, over the calls of the profiler session that opened last
    of those a rollout recorded and closed: {"steps": steps, name: each counter's increase,
    "untraced_calls": the untraced calls timed between the session before
    it (or the rollout's start) and this one, a capture's call left out,
    "untraced_call_ms": their mean host ms, or None}; None if no session
    has ended. A session whose profiler has stopped is closed here."""
    if not recording():
        for s in list(_open):
            s.close()
    if _last is None:
        return None
    _, steps, start, end, (calls, seconds) = _last
    return {"steps": steps, **{k: int(end[k] - start[k]) for k in end},
            "untraced_calls": calls,
            "untraced_call_ms": 1e3 * seconds / calls if calls else None}


# ---------------------------------------------------------------------------
# profiler traces
# ---------------------------------------------------------------------------

# the annotation that opens the window a profile reads
WINDOW = "profiled window"


def profile_kernels(fn, trace: str | Path, before=None) -> dict:
    """Run `fn()` under torch.profiler (CPU and CUDA activity), fenced,
    write the Chrome trace to `trace`, and return what it says of the
    card's kernels (`kernel_busy`) over the WINDOW annotation around `fn`.
    `before()`, when given, runs first under the running profiler and
    outside that window: a barrier there lines several ranks up after each
    has started its profiler, so that no rank reads another's late start as
    its own wait."""
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
    durations (`kernel_ms`), the span they are held against, the device's
    busy time in it (the kernels' intervals merged, clipped to the span)
    and its share of the span, and (count, ms) by kernel name, longest
    first. The span is the host's WINDOW annotation, from its opening to
    its close after the closing synchronize, and only the kernels that
    start inside it count; a trace without it is held against the span of
    all its events. Without kernels in the span every time is None."""
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    timed = [e for e in events if "dur" in e and "ts" in e]
    marks = [e for e in timed if e.get("name") == WINDOW
             and not str(e.get("cat", "")).startswith("gpu")]
    spans = marks or timed
    lo = min((e["ts"] for e in spans), default=0.0)
    hi = max((e["ts"] + e["dur"] for e in spans), default=0.0)
    kern = [e for e in timed if e.get("cat") == "kernel"
            and lo <= e["ts"] < hi]
    if not kern:
        return {"kernels": 0, "kernel_ms": None, "span_ms": None,
                "busy_ms": None, "busy_share": None, "by_name": []}
    iv = sorted((e["ts"], min(e["ts"] + e["dur"], hi)) for e in kern)
    busy, cur_s, cur_e = 0.0, iv[0][0], iv[0][1]
    for s, e in iv[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = hi - lo
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
