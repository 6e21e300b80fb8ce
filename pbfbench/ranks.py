"""The rank path of the harness: one run of a cell whose configuration has a
`parallel` entry, on that many ranks, one card each.

`harness.run` hands such a cell here. The run's own process starts the ranks
through the program's launcher (`parallel/launch.py` `run`: one process a
rank, NCCL between cards, gloo on the CPU), waits for them and prints the
result line from what they leave in the run's temporary directory. Each rank:

- set-up, untimed: the benchmark's seeded spawn (`harness.spawn`, the same on
  every rank, which checks it), the spawn tier (`ParallelConfig.create` at
  the file's `spawn_tier` settings, `distribute`) driven `retier_at` steps
  through one `ShardedRollout` call, then the move to the compact tier as the
  runner makes it (`collect`, `ParallelConfig.compact` at the file's
  `compact_tier` settings, `distribute`), and the compact tier's
  `ShardedRollout` with one call of one step (its capture);
- the window: whole segments from that one compact state (a `ShardedRollout`
  never writes the caller's state), each call's counters on the host, and at
  the end of each segment one collective that carries rank 0's verdict on
  the time, so that a segment ends on rank 0's clock only once every rank
  has its counters; with trace, one more segment under torch.profiler, its
  trace in `build/pbfbench/trace_<cell>.rank<r>.json`;
- the check: the segment driven again, stopping at the phases drawn from the
  seed; at each, the state (`collect`, in id order) and the sharded step from
  it, collected; rank 0 hands both to the plain reference
  (`harness.compare`), once every rank has released the program. The
  re-driven end must equal the window's first and last segment ends bit for
  bit on every rank (`replay_mismatch`); a collected state that is not the
  ids 0..n-1 once each is not compared and counts in `id_mismatch`. The
  program's rows are in slab order, so the single card's `order_mismatch`
  (slots against the reference's cell sort) does not apply.

A call fails when its counters show a migration, merge, ghost or plan
overflow, a particle lost or out of the box, or a value that is not finite.
A rank that raises or stalls fails the run: `launch.run` raises, stops every
rank, and the run prints no result.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import os
import pickle
import tempfile
import time

import torch

from pbfbench import harness

# the ranks' limit a run (an item): a stall or a deadline ends the run with
# no result
RANKS_TIMEOUT_S = 300.0
# the single card's comparison of slots against the reference's cell sort,
# which rows in slab order do not follow
NOT_COMPARED = ("order_mismatch",)


@dataclasses.dataclass
class Item:
    """One run of the ranks' process: the seed, the kernel geometry's
    replaced fields (the control's switches) and a fault planted after the
    set-up (`module:function`, the tests' faults; None in a benchmark
    run)."""

    seed: int
    geometry: dict | None = None
    fault: str | None = None


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", t_start: float | None = None,
        config: dict | None = None, traffic: dict | None = None) -> dict:
    """One run of `workload` on its ranks: the result line as a dict, as
    `harness.run` returns it."""
    t_start = time.perf_counter() if t_start is None else t_start
    return run_items(workload, [Item(seed)], seconds, trace,
                     device=device, t_start=t_start, config=config,
                     traffic=traffic)[0][0]


def run_items(workload: str, items: list[Item], seconds: float,
              trace: bool, *, device: str = "cuda",
              t_start: float | None = None, config: dict | None = None,
              traffic: dict | None = None) -> list[tuple[dict, dict]]:
    """(the result line, what rank 0 left) of each item, run one after
    another by one set of ranks. The first item's set-up counts from
    `t_start`, a later one's from its own start."""
    from pdb_sph_tpu_torch.parallel import launch

    t_start = time.perf_counter() if t_start is None else t_start
    cell = harness.find_cell(workload)
    conf = {**cell.config, **(config or {})}
    mix = harness.Traffic.of(cell.traffic, **(traffic or {}))
    if mix.read_back != ("counters",):
        raise ValueError(f"the rank path reads back counters only, not "
                         f"{mix.read_back}")
    # one card a rank on the configuration's backend, or gloo on the CPU
    d, comm = conf["parallel"]["ranks"], conf["parallel"]["comm"]
    devices = [f"cuda:{r}" for r in range(d)]
    if torch.device(device).type != "cuda":
        devices, comm = ["cpu"] * d, "gloo"
    job = {"workload": workload, "conf": conf, "mix": mix, "items": items,
           "seconds": seconds, "trace": trace, "t_start": t_start,
           "t_launch": time.perf_counter()}
    with tempfile.TemporaryDirectory(prefix="pbfbench_ranks_") as workdir:
        launch.run(_rank, d, devices, comm, RANKS_TIMEOUT_S * len(items),
                   workdir, args=(job,))
        return [_result(cell, conf, mix, workdir, k, d, trace)
                for k in range(len(items))]


# ---------------------------------------------------------------------------
# a rank
# ---------------------------------------------------------------------------

class Program:
    """The system under test on a rank: the port's `ShardedRollout`, called
    as `harness.Program` is, so that `harness.drive` drives it: (state,
    steps) -> (the rank's next state, counters (3,) int32 on the card).
    The counters, the same on every rank, take the single card's form, which
    `harness.compare` holds against the reference's [0, 0, non-finite]:
    [every rank's migration, merge, ghost and plan overflows and the
    particles lost, the particles out of the box, whether a value is not
    finite]."""

    def __init__(self, cfg, pcfg, group, backend: str, steps_per_call: int,
                 device: torch.device, n: int):
        from pdb_sph_tpu_torch.parallel import sharded

        self.rollout = sharded.make_sharded_rollout(
            cfg, pcfg, group, backend, steps_per_call, device)
        self.n = n

    def __call__(self, state, steps: int | None = None):
        state, stats, diag = self.rollout(state, steps)
        lost = (stats[:, 0].sum() - self.n).abs()
        counters = torch.stack([stats[:, 1:].sum() + lost,
                                diag[:, 1].sum().long(),
                                (diag[:, 2] > 0).any().long()])
        return state, counters.int()

    def release(self) -> None:
        self.rollout.release()
        self.rollout = None


def _flag(group, device, value: bool) -> bool:
    """Rank 0's `value`, on every rank once every rank has called this:
    one all_gather, read back to the host."""
    t = torch.tensor([int(value)], dtype=torch.int32, device=device)
    return bool(group.all_gather(t)[0, 0].item())


def _same_spawn(group, device, x: torch.Tensor) -> None:
    """Raise unless every rank made the same spawn."""
    mine = torch.stack([x.double().sum(), (x.double() ** 2).sum()])
    every = group.all_gather(mine.to(device)).cpu()
    if not bool((every == every[0]).all()):
        raise RuntimeError(f"the ranks made different spawns: {every}")


def _settled(group, device, conf: dict, cfg, spawn_state, log):
    """The set-up up to the window: the spawn tier from the spawn,
    `retier_at` steps, then the compact tier's state, distributed.
    Returns (the compact tier's ParallelConfig, the rank's state)."""
    from pdb_sph_tpu_torch.parallel import sharded

    par, d = conf["parallel"], group.size
    pcfg = sharded.ParallelConfig.create(cfg, d, state=spawn_state,
                                         **par["spawn_tier"])
    sst = sharded.distribute(cfg, pcfg, spawn_state, group, device)
    spawn_tier = Program(cfg, pcfg, group, conf["backend"], par["retier_at"],
                         device, conf["n"])
    sst, counters = spawn_tier(sst)
    if counters.any():
        raise RuntimeError(f"the spawn tier failed in its {par['retier_at']} "
                           f"steps: counters {counters.tolist()}")
    spawn_tier.release()
    del spawn_tier
    st = sharded.collect(sst, group)
    del sst
    pcfg = sharded.ParallelConfig.compact(cfg, d, state=st, prior=pcfg,
                                          **par["compact_tier"])
    start = sharded.distribute(cfg, pcfg, st, group, device)
    log(f"compact tier at step {par['retier_at']}: capacity "
        f"{pcfg.capacity}, ghost {pcfg.ghost_capacity}, migration "
        f"{pcfg.mig_capacity}")
    return pcfg, start


def _plant(fault: str | None, rank: int):
    """Plant `fault` (`module:function`, which takes the rank and returns
    an undo) in this rank's process; returns the undo."""
    if fault is None:
        return lambda: None
    mod, name = fault.split(":")
    return getattr(importlib.import_module(mod), name)(rank)


def _rank(group, device: torch.device, workdir: str, job: dict) -> None:
    if device.type == "cuda":
        torch.set_num_threads(1)
    for k, item in enumerate(job["items"]):
        now = time.perf_counter()
        starts = (job["t_start"], job["t_launch"]) if k == 0 else (now, now)
        out = _item(group, device, job, item, *starts, workdir, k)
        with open(os.path.join(workdir, f"rank{group.rank}.{k}.json"),
                  "w") as f:
            json.dump(out, f)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    found = harness.jax_modules()
    if found:
        raise RuntimeError(f"loaded in rank {group.rank}'s process: {found}")


def _item(group, device: torch.device, job: dict, item: Item,
          t_start: float, t_launch: float, workdir: str, k: int) -> dict:
    """One run on this rank: set-up (from `t_start`; the ranks started at
    `t_launch`), window, traced segment, check. Returns what the run's
    process reads of this rank."""
    from pdb_sph_tpu_torch.parallel import launch
    from pdb_sph_tpu_torch.state import SimState

    conf, mix, rank, n = job["conf"], job["mix"], group.rank, job["conf"]["n"]

    def log(msg):
        launch.note(workdir, rank, msg)
        if rank == 0:
            harness.log(f"{job['workload']} seed {item.seed}: {msg}")

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t_enter = time.perf_counter()
    cfg = harness.sim_config(conf, item.geometry)
    spawn_state = SimState(*harness.spawn(conf, item.seed, device))
    _same_spawn(group, device, spawn_state.x)
    pcfg, start = _settled(group, device, conf, cfg, spawn_state, log)
    del spawn_state
    program = Program(cfg, pcfg, group, conf["backend"], mix.steps_per_call,
                      device, n)
    host = harness.Host(n, mix, device)
    t_tiers = time.perf_counter()
    harness.drive(program, start, dataclasses.replace(
        mix, segment_steps=1, steps_per_call=1), host, [], [])
    undo = _plant(item.fault, rank)

    # the window: whole segments, all ranks starting together
    gc.collect()
    _flag(group, device, False)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    calls_ms, failed, ends, segments = [], [], {}, 0
    while True:
        end = harness.drive(program, start, mix, host, calls_ms, failed)
        ends.setdefault("first", end)
        ends["last"] = end
        segments += 1
        if _flag(group, device, time.perf_counter() - t0 >= job["seconds"]):
            break
    window_s = time.perf_counter() - t0
    untraced_calls = len(calls_ms)
    traced_file = None
    if job["trace"]:
        traced, ends["last"] = harness._traced_segment(
            program, start, mix, host, calls_ms, failed,
            f"{job['workload']}.rank{rank}",
            lambda: _flag(group, device, False))
        traced_file = os.path.join(workdir, f"traced{rank}.{k}.pkl")
        with open(traced_file, "wb") as f:
            pickle.dump(traced, f)
        del traced
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)

    # the check: the program's side on every rank, then its release, then
    # the reference on rank 0
    t1 = time.perf_counter()
    phases = harness.check_phases(mix, item.seed)
    every = mix.segment_steps / (harness.CENSUS_POINTS - 1)
    census_at = ([round(i * every) for i in range(harness.CENSUS_POINTS)]
                 if job["trace"] else [])
    steps, census_x, redriven = harness.redrive(
        program, start, mix, phases, census_at,
        lambda state: _collected(state, group))
    kept = [ends["first"], ends["last"]]
    differ = torch.tensor([int(not harness._same(e, redriven)) for e in kept],
                          dtype=torch.int32, device=device)
    replay = int(group.all_gather(differ).any(dim=0).sum())
    undo()
    program.release()
    del program, start, ends, kept, redriven, end
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t2 = time.perf_counter()
    out = {"rank": rank, "segments": segments, "window_s": window_s,
           "setup_s": setup_s, "calls_ms": calls_ms,
           "untraced_calls": untraced_calls, "failed": failed,
           "memory_peak": memory_peak, "traced_file": traced_file,
           "card": harness._card(device), "phases": phases,
           "seed": item.seed, "control": item.geometry is not None}
    if rank == 0:
        numbers = compare(conf, steps, mix.gap_from, n)
        numbers["replay_mismatch"] = replay
        out["numbers"] = numbers
        out["program_s"] = t2 - t_enter
        out["reference_s"] = time.perf_counter() - t2
        out["pairs_per_step"] = (harness._census_mean(census_x, conf["h"])
                                 if census_x else None)
        log(f"set-up {setup_s:.3f} s (this process's start "
            f"{t_launch - t_start:.3f}, the ranks' start "
            f"{t_enter - t_launch:.3f}, spawn and tiers "
            f"{t_tiers - t_enter:.3f}, first call "
            f"{t0 - t_tiers:.3f}), window {window_s:.3f} s, re-drive "
            f"{t2 - t1:.3f} s, reference {out['reference_s']:.3f} s, "
            f"census {time.perf_counter() - t2 - out['reference_s']:.3f} s")
    return out


def _collected(sst, group):
    """The rank's state collected (`sharded.collect`, id order) as (x, v,
    ids) on rank 0, None on the others."""
    from pdb_sph_tpu_torch.parallel import sharded

    st = sharded.collect(sst, group)
    return tuple(st[:3]) if group.rank == 0 else None


def _whole(state, n: int) -> bool:
    ids = state[2]
    return ids.numel() == n and bool(torch.equal(
        ids.long(), torch.arange(n, device=ids.device)))


def compare(conf: dict, steps: list, gap_from: int, n: int) -> dict:
    """`harness.compare` over the compared steps whose collected states
    hold every id once, without the numbers that do not apply; the others
    count in id_mismatch."""
    whole = [s for s in steps if _whole(s[1], n) and _whole(s[2], n)]
    numbers = harness.compare(conf, whole, gap_from)
    for k in NOT_COMPARED:
        numbers.pop(k)
    numbers["id_mismatch"] = len(steps) - len(whole)
    if not whole:
        numbers = {k: float("inf") for k in numbers}
    return numbers


# ---------------------------------------------------------------------------
# the result line, in the run's process
# ---------------------------------------------------------------------------

def _result(cell, conf: dict, mix: harness.Traffic, workdir: str, k: int,
            d: int, trace: bool) -> tuple[dict, dict]:
    """(the result line of item k, what rank 0 left of it) from the ranks'
    files in `workdir`."""
    parts = []
    for r in range(d):
        with open(os.path.join(workdir, f"rank{r}.{k}.json")) as f:
            parts.append(json.load(f))
    head = parts[0]
    checks = {name: {"value": v, "limit": cell.limits[name]["limit"]}
              for name, v in head["numbers"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    traced = []
    for p in parts if trace else []:
        with open(p["traced_file"], "rb") as f:
            t = pickle.load(f)
        t.pairs_per_step = head["pairs_per_step"]
        traced.append(t)
    untraced = head["untraced_calls"]
    ctx = harness.Context(
        n=conf["n"], iters=conf["solver_iters"],
        steps=head["segments"] * mix.segment_steps,
        window_s=head["window_s"], calls_ms=head["calls_ms"][:untraced],
        setup_s=head["setup_s"], trace=None, ranks=traced,
        card=head["card"])
    result = harness.result_line(
        cell, ctx, correct, len(head["calls_ms"]), sum(head["failed"]),
        [p["memory_peak"] for p in parts], traced, checks)
    return result, head


def readings(workload: str, seeds, geometry: dict | None, device: str,
             config: dict | None = None, traffic: dict | None = None):
    """control.readings for a cell on ranks: one segment a seed (a window
    of one segment) and the check, every seed on one set of ranks."""
    items = [Item(s, geometry) for s in seeds]
    for r, head in run_items(workload, items, 0.0, False, device=device,
                             config=config, traffic=traffic):
        yield {"workload": workload, "seed": head["seed"],
               "control": head["control"], "phases": head["phases"],
               "numbers": head["numbers"], "program_s": head["program_s"],
               "reference_s": head["reference_s"], "correct": r["correct"],
               "failed": r["failed"]}
