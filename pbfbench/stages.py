"""The program's own stage map, spans and counters, read against the trace.

The program records, at the capture of its step (`pdb_sph_tpu_torch.utils.
timing.last_stage_map()`), which range of the graph's device-op nodes each
stage of the step owns, in capture order; a replay runs them in that order.
In the trace of the traced segment, every device op of one replay (kernel,
memcpy, memset) carries the correlation id of its `cudaGraphLaunch`, so the
ops group by replay, and the k-th op of a replay by start time is the k-th
node of the map. The ops are matched by correlation alone, not by the
window, whose host clock the device's timestamps may lag. The readers take
a number only where that holds:

- the window's host made as many graph launches as the traced steps;
- no replay has more ops than the map's nodes, and at least COMPLETE of
  them have exactly as many (a replay short of ops, whose records the
  profiler dropped, is left out of the means);
- every pair kernel (pair_roofline.PATTERNS) of those falls in a `density`
  or `project` range.

Otherwise `stage_ms` returns None and the readers report nothing. A stage's
time in a replay is its own ops' busy time, their intervals merged: what
the stage's kernels, copies and memsets occupy the device, with no gap
counted. The rest of the replay's span is its gaps: the graph's own launch
gaps between nodes, and under the profiler the device's waits for the host
to submit the graph (CUPTI slows the launch of an 80k step to ~0.5 ms, and
the device stalls inside the replay, at a place that moves from run to
run). The stages and the gaps tile the replay.

The counters over the profiler session (`timing.last_session()`), and the
host time of the program's untraced calls before it, are read here too.
Against a program without them, every function returns None.
"""

from __future__ import annotations

import re
from pathlib import Path

from pbfbench import trace
from pbfbench.metrics.pair_roofline import PATTERNS

TRACES = Path(__file__).resolve().parents[1] / "build" / "pbfbench"
LAUNCH = "cudaGraphLaunch"
SOLVE = ("density", "project")
# the least share of the traced replays whose ops are all in the trace
COMPLETE = 0.9
# the metrics' stages: the stage names of the program's map they sum
GROUPS = {"predict": ("predict+cell_ids",), "sort": ("sort+gather",),
          "plan": ("plan",), "finalize": ("finalize", "epilogue")}

# the events of the last trace read, by its window's start
_cache: dict = {}


def _timing():
    """The program's timing module, or None where the program has no stage
    map or session counters (an older checkout)."""
    try:
        from pdb_sph_tpu_torch.utils import timing
    except ImportError:
        return None
    if not hasattr(timing, "last_stage_map"):
        return None
    return timing


def events(ctx) -> list[dict] | None:
    """The events of the trace that the harness wrote for this run: the
    newest `build/pbfbench/trace_*.json` whose window opens at the traced
    window's start."""
    t = ctx.trace
    if t is None or t.window is None:
        return None
    start = t.window.start
    if _cache.get("start") == start:
        return _cache["events"]
    paths = sorted(TRACES.glob("trace_*.json"),
                   key=lambda p: p.stat().st_mtime, reverse=True)
    for path in paths:
        evs = trace.load(path)
        w = trace.window(evs)
        if w is not None and w.start == start:
            _cache.update(start=start, events=evs)
            return evs
    return None


def _in_window(e: dict, w) -> bool:
    return "dur" in e and w.start <= float(e["ts"]) < w.end


def replays(evs: list[dict], w) -> list[list[dict]]:
    """The device ops of each graph launch that the window's host made, by
    start time, in launch order."""
    launches = sorted((e for e in evs if e.get("name") == LAUNCH
                       and e.get("cat") == "cuda_runtime"
                       and _in_window(e, w)), key=lambda e: float(e["ts"]))
    groups = {e["args"]["correlation"]: [] for e in launches}
    for e in evs:
        if e.get("cat") in trace.DEVICE_CATS and "dur" in e:
            c = e.get("args", {}).get("correlation")
            if c in groups:
                groups[c].append(e)
    return [sorted(groups[e["args"]["correlation"]],
                   key=lambda op: float(op["ts"])) for e in launches]


def busy_us(ops: list[dict]) -> float:
    """Microseconds that `ops` occupy the device, their intervals merged."""
    busy, reach = 0.0, None
    for a, b in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in ops):
        if reach is None or a > reach:
            busy += b - a
            reach = b
        elif b > reach:
            busy += b - reach
            reach = b
    return busy


def stage_times(ops: list[dict], stages) -> list[float] | None:
    """Microseconds of busy time of each stage (name, first, count) in one
    replay's ops, which are exactly the map's nodes; None unless every pair
    kernel lies in a solve stage."""
    pair = re.compile("|".join(PATTERNS))
    for s in stages:
        if s.name in SOLVE:
            continue
        for e in ops[s.first:s.first + s.count]:
            if e.get("cat") == "kernel" and pair.search(e.get("name", "")):
                return None
    return [busy_us(ops[s.first:s.first + s.count]) for s in stages]


def stage_ms(ctx) -> dict | None:
    """{stage: device busy ms a step}, the names of the program's map
    summed by name, with "replay", the mean replay span, "gaps", the
    replay's time outside every op, and "replays", the complete replays the
    means are taken over; or None (see the module)."""
    timing = _timing()
    t = ctx.trace
    if timing is None or t is None or t.window is None or not t.steps:
        return None
    stages = timing.last_stage_map()
    evs = events(ctx)
    if not stages or evs is None:
        return None
    groups = replays(evs, t.window)
    nodes = sum(s.count for s in stages)
    complete = [ops for ops in groups if len(ops) == nodes]
    if len(groups) != t.steps or len(complete) < COMPLETE * t.steps \
            or any(len(ops) > nodes for ops in groups):
        return None
    sums: dict[str, float] = {}
    replay = gaps = 0.0
    for ops in complete:
        times = stage_times(ops, stages)
        if times is None:
            return None
        for s, us in zip(stages, times):
            sums[s.name] = sums.get(s.name, 0.0) + us
        span = (max(float(e["ts"]) + float(e["dur"]) for e in ops)
                - float(ops[0]["ts"]))
        replay += span
        gaps += span - busy_us(ops)
    k = len(complete)
    out = {name: v / 1e3 / k for name, v in sums.items()}
    out.update(replay=replay / 1e3 / k, gaps=gaps / 1e3 / k, replays=k)
    return out


def group_ms(ctx, group: str) -> float | None:
    """Device ms a step of one of GROUPS, or None."""
    ms = stage_ms(ctx)
    if ms is None or not all(name in ms for name in GROUPS[group]):
        return None
    return sum(ms[name] for name in GROUPS[group])


def session(ctx) -> dict | None:
    """The program's counters over the traced segment's calls, or None if
    they cover other steps than the segment's."""
    timing = _timing()
    t = ctx.trace
    if timing is None or t is None or not t.steps:
        return None
    s = timing.last_session()
    if s is None or s.get("steps") != t.steps:
        return None
    return s


def rollout_host_ms(ctx) -> float | None:
    """The program's mean host ms of a `Rollout` call over the untraced
    window (its own clock, `timing.last_session()`), or None unless it
    timed exactly the window's calls."""
    s = session(ctx)
    if s is None or s.get("untraced_calls") != len(ctx.calls_ms):
        return None
    return s.get("untraced_call_ms")
