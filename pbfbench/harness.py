"""One run of one benchmark cell: set-up, the measured window, the check.

Everything that belongs to a cell is found by name from BENCHMARK.json:
the configuration's file (`configs/<config>.json`: the solver's constants,
the spawn, the backend, the kernel geometry, the reference beside it), the
traffic mix (`traffic/<traffic>.json`, read by `drive` below, the one
generator), the limits of the check (`limits/<workload>.json`) and a reader
for each metric (`metrics/<metric>.py`). A cell, a mix or a metric is added
with new files and entries; this file does not change for it.

Every mix replays one fixed segment: `segment_steps` steps from the spawn
that the benchmark makes from the seed, in calls of `steps_per_call` steps
through the program's `Rollout`, each call followed by the read back of
what `read_back` names ("counters": the step counters; "positions": every
particle's position, as a viewer reads each frame). The state then returns
to the spawn, so every segment, run and commit does the same work; a faster
commit gets no credit for reaching a cheaper phase of the flow.

The check, after the window: the program's segment is driven again from the
spawn through the same `Rollout` (its captured graph), stopping at phases
drawn from the seed, and the plain reference (`reference/<name>.py`) takes
one step from each of those states of the program; the step the program
took from it is compared with the reference's. The re-driven segment's end
state must equal every segment's end state of the window bit for bit, which
ties the compared steps to what the window produced.

A cell whose configuration has a `parallel` entry runs on ranks, one card
each: `run` hands it to `ranks.run`, which measures and checks it the same
way from the compact tier's state (pbfbench/ranks.py).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import random
import sys
import time
import types
from pathlib import Path
from typing import Callable

import torch

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
OUT = ROOT / "build" / "pbfbench"

# modules that may not be loaded in a run's process: the JAX package and
# JAX itself, compared by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "pdb_sph_tpu")
# the census of pairs within h: states at this many equal steps of the
# traced segment, both ends included
CENSUS_POINTS = 11
# a particle outside [-margin, wall + margin]^3 has left the box
BOX_MARGIN = 0.25
# a per-layer metric named so, with no reader of its own, is the mean over
# the ranks of the metric named by the rest (`reader`)
RANK_PREFIX = "rank_"


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# the manifest and the files it names
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    manifest: dict

    @property
    def name(self) -> str:
        return self.workload["name"]


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of BENCHMARK.json with its configuration, mix and
    limits, each read from its own file."""
    m = manifest(root)
    cells = {w["name"]: w for w in m["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    entry = {c["name"]: c for c in m["configs"]}[w["config"]]
    return Cell(
        workload=w,
        config=json.loads((root / entry["file"]).read_text()),
        traffic=json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                           .read_text()),
        limits=json.loads((HERE / "limits" / f"{name}.json").read_text()),
        manifest=m)


def metrics_of(cell: Cell, kind: str) -> list[dict]:
    """The manifest's metrics of `kind` ("end_to_end" or "per_layer") that
    this cell reports."""
    return [e for e in cell.manifest[kind]
            if cell.name in e.get("workloads", [cell.name])]


def reader(name: str) -> Callable:
    """`read(ctx)` of metrics/<name>.py, where a quantity split by the cells
    that report it (`pair_roofline.frames`) is read by the reader of its
    name before the first dot. A `rank_<name>` with no reader of its own is
    the mean over the ranks of `<name>` read on each rank's trace."""
    name = name.split(".", 1)[0]
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists() and name.startswith(RANK_PREFIX):
        return _rank_mean(reader(name[len(RANK_PREFIX):]))
    spec = importlib.util.spec_from_file_location(f"pbfbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _rank_mean(read: Callable) -> Callable:
    """`read` on a context of each rank's trace (ctx.ranks), averaged over
    the ranks; None where it reads nothing on any rank."""
    def mean(ctx):
        ranks = getattr(ctx, "ranks", None) or []
        values = [read(Context(**{**vars(ctx), "trace": t})) for t in ranks]
        if not values or any(v is None for v in values):
            return None
        return sum(values) / len(values)
    return mean


def jax_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


# ---------------------------------------------------------------------------
# inputs and the program
# ---------------------------------------------------------------------------

def spawn(config: dict, seed: int, device: torch.device):
    """(x, v, ids, step) of the configuration's spawn from `seed`: n points
    drawn on `device` from the seed's own generator, at rest, uniform in
    the `spawn` entry's shape, given in units of the wall:

    - "box": `lo` and `hi` corners; one draw of n x 3 uniforms.
    - "ball": `centre` (3 numbers) and `radius`, the blowup scene's recipe
      (pdb_sph_tpu_torch/models/scenes.py `blowup`): a direction from a
      normalised standard normal 3-vector, a distance R u^(1/3) (uniform in
      volume), the point (centre + direction distance) wall.

    Any other shape raises. The rank path (ranks.py) spawns through here,
    so a cell on ranks takes either shape too."""
    s, n, wall = config["spawn"], config["n"], config["wall"]
    gen = torch.Generator(device=device).manual_seed(seed)
    if s["shape"] == "ball":
        centre = torch.tensor(s["centre"], dtype=torch.float32, device=device)
        d = torch.randn((n, 3), generator=gen, device=device)
        d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
        u = torch.rand((n, 1), generator=gen, device=device)
        x = (centre + d * (s["radius"] * u ** (1.0 / 3.0))) * wall
    elif s["shape"] == "box":
        lo = torch.tensor(s["lo"], dtype=torch.float32, device=device)
        hi = torch.tensor(s["hi"], dtype=torch.float32, device=device)
        u = torch.rand((n, 3), generator=gen, device=device)
        x = (lo + u * (hi - lo)) * wall
    else:
        raise ValueError(f"unknown spawn shape {s['shape']!r}")
    return (x.float().contiguous(), torch.zeros_like(x, dtype=torch.float32),
            torch.arange(n, dtype=torch.int32, device=device),
            torch.zeros((), dtype=torch.int32, device=device))


def sim_config(config: dict, geometry: dict | None = None):
    """The program's SimConfig with every field from the configuration's
    file (none from defaults or the environment); `geometry` replaces
    fields of the file's kernel geometry (the control's switches)."""
    from pdb_sph_tpu_torch.config import SimConfig
    from pdb_sph_tpu_torch.geometry import KernelGeometry

    fields = [f.name for f in dataclasses.fields(SimConfig) if f.name != "geom"]
    missing = [f for f in fields if f not in config]
    if missing:
        raise ValueError(f"configuration lacks {missing}")
    geom = KernelGeometry(**{**config["geometry"], **(geometry or {})})
    cfg = SimConfig(**{f: config[f] for f in fields}, geom=geom)
    cfg.validate()
    return cfg


class Program:
    """The system under test: the port's `Rollout`, its only entry here."""

    def __init__(self, config: dict, steps_per_call: int,
                 device: torch.device, geometry: dict | None = None):
        from pdb_sph_tpu_torch.core.step import make_rollout
        from pdb_sph_tpu_torch.state import SimState

        self.state_type = SimState
        self.cfg = sim_config(config, geometry)
        self.rollout = make_rollout(self.cfg, config["backend"],
                                    unroll_steps=steps_per_call,
                                    with_stats=True, device=device)

    def __call__(self, state, steps: int | None = None):
        """(next state as (x, v, ids, step), counters (3,) int32)."""
        out, stats = self.rollout(self.state_type(*state), steps)
        return tuple(out), stats

    def release(self) -> None:
        if self.rollout.captured is not None:
            self.rollout.captured.release()
        self.rollout = None


# ---------------------------------------------------------------------------
# the traffic: one generator for every mix
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Traffic:
    segment_steps: int
    steps_per_call: int
    read_back: tuple
    check_phases: int
    gap_from: int

    @classmethod
    def of(cls, mix: dict, **overrides) -> "Traffic":
        t = cls(mix["segment_steps"], mix["steps_per_call"],
                tuple(mix["read_back"]), mix["check_phases"],
                mix["gap_from"])
        t = dataclasses.replace(t, **overrides)
        if t.segment_steps % t.steps_per_call:
            raise ValueError("segment_steps must be a multiple of "
                             "steps_per_call")
        if not set(t.read_back) <= {"counters", "positions"}:
            raise ValueError(f"unknown read_back {t.read_back}")
        return t

    @property
    def calls(self) -> int:
        return self.segment_steps // self.steps_per_call


class Host:
    """Where the read back lands: page-locked buffers on a card's host."""

    def __init__(self, n: int, traffic: Traffic, device: torch.device):
        pin = device.type == "cuda"
        self.x = (torch.empty((n, 3), dtype=torch.float32, pin_memory=pin)
                  if "positions" in traffic.read_back else None)
        self.stats = torch.empty((3,), dtype=torch.int32, pin_memory=pin)
        self.sync = (torch.cuda.current_stream(device).synchronize
                     if device.type == "cuda" else (lambda: None))


def drive(program: Program, start, traffic: Traffic, host: Host,
          calls_ms: list, failed: list):
    """One segment from `start`: each call's latency (ms, from its issue
    until what it reads back is on the host) goes to `calls_ms`, and whether
    its counters show an overflow or a non-finite state to `failed`.
    Returns the segment's end state."""
    state = start
    for _ in range(traffic.calls):
        t0 = time.perf_counter()
        state, stats = program(state, traffic.steps_per_call)
        if host.x is not None:
            host.x.copy_(state[0], non_blocking=True)
        host.stats.copy_(stats, non_blocking=True)
        host.sync()
        calls_ms.append(1e3 * (time.perf_counter() - t0))
        failed.append(bool(host.stats.any()))
    return state


# ---------------------------------------------------------------------------
# the check
# ---------------------------------------------------------------------------

def check_phases(traffic: Traffic, seed: int) -> list[int]:
    """The segment's first and last step and check_phases - 2 more drawn
    from the seed."""
    last = traffic.segment_steps - 1
    rng = random.Random(seed)
    inner = list(range(1, last))
    drawn = rng.sample(inner, min(len(inner), max(0, traffic.check_phases - 2)))
    return sorted({0, last, *drawn})


def redrive(program: Program, start, traffic: Traffic, phases: list[int],
            census_at: list[int], keep: Callable = lambda state: state):
    """Drive the segment again from `start`, stopping at each phase j of
    `phases` to take one step alone: returns ([(j, state j, state j + 1,
    counters of that step)], {k: positions at step k for k in census_at},
    the end state). The states compared and counted are `keep(state)`
    (the rank path: collected; None on a rank that keeps nothing)."""
    steps, census, state, at = [], {}, start, 0
    for stop in sorted(set(phases) | set(census_at) | {traffic.segment_steps}):
        if stop > at:
            state, _ = program(state, stop - at)
            at = stop
        if stop in census_at:
            kept = keep(state)
            if kept is not None:
                census[stop] = kept[0].clone()
        if stop in phases:
            nxt, stats = program(state, 1)
            steps.append((stop, keep(state), keep(nxt), stats))
            state, at = nxt, stop + 1
    return steps, census, state


def _by_id(values: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(values)
    out[ids.long()] = values
    return out


def _is_permutation(ids: torch.Tensor) -> bool:
    n = ids.numel()
    return bool(torch.equal(torch.sort(ids.long()).values,
                            torch.arange(n, device=ids.device)))


def compare(config: dict, steps: list, gap_from: int) -> dict:
    """The numbers compared, over the program's steps, each against the
    reference's step from the same state, particle by particle (by id):

    - x_gap_median, v_gap_median: the median particle's position and
      velocity gap, the largest over the steps. Every particle is compared
      at every step, so a program that computes in a lower precision moves
      them by orders of magnitude.
    - x_gap, v_gap: the widest position and velocity gap at the steps from
      phase `gap_from` on, which a fault in a few particles moves (a wrong
      bounce off a wall moves only v_gap), over the particles that were
      not at a wall when it was tested (the reference's `at_wall`: there a
      rounding decides a bounce, which reverses and damps the velocity and
      moves the particle by up to 70 % of the step's motion). In the first
      steps from the spawn the flow is violent enough that a pair outside
      the 27 cells around a particle's predicted cell comes within h during
      the solve; whether a program counts it is its own choice (the port's
      windows reach further than the reference's cells), so the widest gap
      there measures that choice and not the program's arithmetic.
    - order_mismatch: slots whose particle differs from the reference's
      cell sort.
    - counter_mismatch: steps whose counters differ from the reference's
      [0, 0, non-finite]."""
    ref_mod = importlib.import_module(
        f"pbfbench.reference.{config['reference']}")
    x_median = v_median = x_gap = v_gap = 0.0
    order = counters = 0
    for phase, s, nxt, stats in steps:
        ref = ref_mod.step(config, s[0], s[1], s[2])
        order += int((nxt[2].long() != ref["ids"].long()).sum())
        counters += int(stats.tolist() != [0, 0, int(ref["nonfinite"])])
        if not _is_permutation(nxt[2]):
            x_median = v_median = x_gap = v_gap = math.inf
            continue
        gx = _gaps(_by_id(nxt[0], nxt[2]), _by_id(ref["x"], ref["ids"]))
        gv = _gaps(_by_id(nxt[1], nxt[2]), _by_id(ref["v"], ref["ids"]))
        x_median = max(x_median, float(gx.median()))
        v_median = max(v_median, float(gv.median()))
        if phase >= gap_from:
            away = ~_by_id(ref["at_wall"], ref["ids"])
            if away.any():
                x_gap = max(x_gap, float(gx[away].max()))
                v_gap = max(v_gap, float(gv[away].max()))
    return {"x_gap_median": x_median, "x_gap": x_gap,
            "v_gap_median": v_median, "v_gap": v_gap,
            "order_mismatch": order, "counter_mismatch": counters}


def _gaps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Each particle's largest coordinate gap; a NaN reads as infinite."""
    g = (a - b).abs().amax(dim=1)
    return torch.nan_to_num(g, nan=math.inf)


def _same(a, b) -> bool:
    return all(torch.equal(s, t) for s, t in zip(a, b))


def _out_of_box(state, wall: float) -> bool:
    x = state[0]
    return bool(((x < -BOX_MARGIN) | (x > wall + BOX_MARGIN)).any()
                or not torch.isfinite(x).all())


def program_side(program: Program, start, mix: Traffic, seed: int,
                 ends: list, host: Host, census_at: list[int]):
    """The program's side of the check, before the program is released:
    re-drive its segment from `start` (`redrive`, at the phases drawn from
    `seed`). Returns (the steps to compare, the census positions, the
    numbers that need no reference: end states of the window's segments
    (`ends`, the last one last) that differ from the re-driven end, and
    positions read back that differ from the last end state)."""
    phases = check_phases(mix, seed)
    steps, census_x, redriven = redrive(program, start, mix, phases,
                                        census_at)
    numbers = {"replay_mismatch": sum(not _same(e, redriven) for e in ends)}
    if host.x is not None:
        numbers["readback_mismatch"] = int(
            (host.x.to(ends[-1][0].device) != ends[-1][0]).sum())
    return steps, census_x, numbers


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

# What the metric readers read (metrics/<name>.py: `read(ctx)`, which
# returns None where it finds nothing to read)
Context = types.SimpleNamespace


def _card(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def _power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", t_start: float | None = None,
        config: dict | None = None, traffic: dict | None = None) -> dict:
    """One run of `workload`: returns the result line as a dict.

    `config` and `traffic` replace fields of the cell's files: the tests'
    small sizes; a benchmark run passes neither."""
    t_start = time.perf_counter() if t_start is None else t_start
    t_enter = time.perf_counter()
    cell = find_cell(workload)
    conf = {**cell.config, **(config or {})}
    mix = Traffic.of(cell.traffic, **(traffic or {}))
    if "parallel" in conf:
        from pbfbench import ranks

        return ranks.run(workload, seed, seconds, trace, device=device,
                         t_start=t_start, config=config, traffic=traffic)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    # set-up: the inputs, the program, one call of one step untimed with
    # its read back (it builds or loads the kernels, fixes the persistent
    # grids, captures the graph; later calls replay that graph)
    start = spawn(conf, seed, dev)
    program = Program(conf, mix.steps_per_call, dev)
    host = Host(conf["n"], mix, dev)
    t_program = time.perf_counter()
    drive(program, start, dataclasses.replace(mix, segment_steps=1,
                                               steps_per_call=1), host, [], [])
    host.sync()
    setup_s = time.perf_counter() - t_start

    # the window: whole segments until `seconds` have passed; with trace,
    # one more segment under the profiler (last: CUPTI slows the host's
    # launches of the segments that follow it). Of the segments' end states
    # only the first and the latest are kept, so that what the benchmark
    # holds does not grow with the window
    gc.collect()
    calls_ms, failed, ends = [], [], {}
    traced = None
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds or not ends:
        end = drive(program, start, mix, host, calls_ms, failed)
        ends.setdefault("first", end)
        ends["last"] = end
    window_s = time.perf_counter() - t0
    untraced_calls = len(calls_ms)
    if trace:
        traced, ends["last"] = _traced_segment(program, start, mix, host,
                                               calls_ms, failed, workload)
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)

    # the check: the program's side, its release, then the reference's
    t1 = time.perf_counter()
    every = mix.segment_steps / (CENSUS_POINTS - 1)
    census_at = ([round(k * every) for k in range(CENSUS_POINTS)]
                 if trace else [])
    kept = [ends["first"], ends["last"]]
    steps, census_x, numbers = program_side(program, start, mix, seed, kept,
                                            host, census_at)
    program.release()
    del program
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t2 = time.perf_counter()
    numbers = {**compare(conf, steps, mix.gap_from), **numbers}
    log(f"{workload} seed {seed}: set-up {setup_s:.3f} s (imports and the "
        f"look for a card {t_enter - t_start:.3f}, inputs and program "
        f"{t_program - t_enter:.3f}, first call "
        f"{setup_s - (t_program - t_start):.3f}), window "
        f"{window_s:.3f} s, re-drive {t2 - t1:.3f} s, reference "
        f"{time.perf_counter() - t2:.3f} s")
    checks = {k: {"value": numbers[k], "limit": cell.limits[k]["limit"]}
              for k in numbers}
    correct = bool(steps) and all(c["value"] <= c["limit"]
                                  for c in checks.values())
    # failed calls: counters, and a kept end state out of the box
    for end, call in zip(kept, (mix.calls - 1, len(calls_ms) - 1)):
        if _out_of_box(end, conf["wall"]):
            failed[call] = True
    if traced is not None:
        traced.pairs_per_step = _census_mean(census_x, conf["h"])

    ctx = Context(n=conf["n"], iters=conf["solver_iters"],
                  steps=untraced_calls * mix.steps_per_call,
                  window_s=window_s, calls_ms=calls_ms[:untraced_calls],
                  setup_s=setup_s, trace=traced, card=_card(dev))
    return result_line(cell, ctx, correct, len(calls_ms), sum(failed),
                       [memory_peak], [] if traced is None else [traced],
                       checks)


def result_line(cell: Cell, ctx, correct: bool, attempted: int, failed: int,
                memory_peaks: list[int], traced: list, checks: dict) -> dict:
    """The run's result line: the cell's metrics read from `ctx`, per-layer
    where the run was traced (`traced`, one summary a card), and the
    device: `memory_peaks` one a card, the busy and traced seconds the mean
    over the cards, the breakdown the first card's."""
    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for e in metrics_of(cell, kind):
        value = reader(e["name"])(ctx)
        if value is not None:
            metrics[e["name"]] = {"value": value, "unit": e["unit"]}

    cuda = ctx.card != "cpu"
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": ctx.card, "count": len(memory_peaks),
                         "memory_peak_bytes": max(memory_peaks)}}
    if traced:
        result["device"]["busy_s"] = sum(t.busy_s for t in traced) / len(
            traced)
        result["device"]["window_s"] = sum(t.window_s for t in traced) / len(
            traced)
        result["breakdown"] = traced[0].breakdown
        log(f"card: {_power_limit()}")
    result["checks"] = checks
    return result


def _census_mean(census_x: dict, h: float) -> float:
    """Pairs within h a step over the segment: the trapezoid rule over the
    census states, which lie at equal steps from its start to its end."""
    from pbfbench.work import pairs_within

    counts = [pairs_within(census_x[k], h) for k in sorted(census_x)]
    if len(counts) == 1:
        return float(counts[0])
    return (sum(counts) - 0.5 * (counts[0] + counts[-1])) / (len(counts) - 1)


def _traced_segment(program, start, mix, host, calls_ms, failed,
                    name: str, line_up: Callable = lambda: None):
    """One segment of the window under torch.profiler, its trace in
    build/pbfbench/trace_<name>.json; `line_up` runs under the running
    profiler before the segment (the rank path: a collective that starts
    the ranks together). Returns (its summary for the readers, the end
    state)."""
    from pbfbench import trace as tr

    # the host's activity marks the window and labels the idle gaps; the
    # device's slows each graph launch of a frame (~0.7 ms at 80k), which
    # tracing the device alone does not avoid
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    first = len(calls_ms)
    with torch.profiler.profile(activities=acts) as prof:
        line_up()
        with torch.profiler.record_function(tr.WINDOW):
            end = drive(program, start, mix, host, calls_ms, failed)
            host.sync()
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / f"trace_{name}.json"
    prof.export_chrome_trace(str(path))
    w = tr.window(tr.load(path))
    calls = len(calls_ms) - first
    return Traced(w, calls, calls * mix.steps_per_call), end


class Traced:
    """The traced segment as the readers see it."""

    def __init__(self, w, calls: int, steps: int):
        from pbfbench import trace as tr

        self.window = w
        self.calls = calls
        self.steps = steps
        self.pairs_per_step = None
        if w is None:
            self.window_s = self.busy_s = 0.0
            self.breakdown = {"device_ops": [], "idle_gaps": []}
        else:
            self.window_s = w.span_us / 1e6
            self.busy_s = tr.busy_us(w) / 1e6
            self.breakdown = {"device_ops": tr.top_device_ops(w),
                              "idle_gaps": tr.top_gaps(w)}
