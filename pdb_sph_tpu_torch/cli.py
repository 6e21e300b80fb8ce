"""Headless simulation runner of the port: `pdb_sph_tpu/cli.py` on
PyTorch, its single-device path (`:29-196`, `:427-554`) and its mesh path
(`_main_mesh`, `:199-424`).

Same flags, JSONL records, frames, checkpoints and aborts as the JAX
runner; a JAX command line (and a JAX checkpoint) carries across. What
differs: `--backend` takes the port's names (`auto`/`window`/`cell`/
`dense`), and `--device` (default `cuda`) names where the state lives. A
CUDA request without a card exits non-zero; it never moves to the CPU.

`--devices N` runs the sharded decomposition (`parallel/sharded.py`): one
rank in-process (its fast path), or N ranks, one process each
(`parallel/launch.py`), NCCL with one card a rank or gloo on the CPU;
rank 0 does all the I/O. `--fake-devices N`, JAX's mesh without chips, is
`--device cpu --devices N`. A rank that fails, or stalls for
`parallel.launch.STALL_S` seconds, fails the run. `--retier-at N` moves
the run to the compact tier at the first chunk boundary at or past step
N; ghost or plan/table overflow there falls back to a spawn tier made from
the current state, with a warning and a `tier_fallback` record. JAX's tier
flags carry across: `--retier-maxlanes` and the TPU kernels' keys of
`--retier-geom` (`cc_d`, `nbuf`, ...) are dropped, and an `own` without a
kernel runs the port's default, each with a note on stderr.

Examples:
    python -m pdb_sph_tpu_torch.cli --scene dam_break --n 80000 --steps 600
    python -m pdb_sph_tpu_torch.cli --scene blowup --render-every 10 --out frames/
    python -m pdb_sph_tpu_torch.cli --resume ckpt.npz --steps 100
    python -m pdb_sph_tpu_torch.cli --device cpu --n 2048 --steps 20
    python -m pdb_sph_tpu_torch.cli --fake-devices 2 --n 2048 --steps 20
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch

from . import interop
from .config import SCENES, SimConfig, blowup_config, default_config
from .core.step import BACKENDS, diagnostics_fn, make_rollout, resolve_backend
from .geometry import KernelGeometry
from .io import checkpoint, frames
from .models.scenes import spawn
from .parallel import launch, sharded
from .utils.logging import MetricsLogger
from .utils.platform import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pdb_sph_tpu_torch",
        description="Position Based Fluids on PyTorch and one CUDA card",
    )
    p.add_argument("--scene", choices=SCENES, default="standard")
    p.add_argument("--n", type=int, default=80_000,
                   help="particle count (reference default 80k, main.cpp:41)")
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--dt", type=float, default=0.0086)
    p.add_argument("--iters", type=int, default=3,
                   help="constraint solver iterations (reference: 3)")
    p.add_argument("--cell-size", type=float, default=0.2)
    p.add_argument("--grid-width", type=int, default=40)
    p.add_argument("--wall", type=float, default=0.0,
                   help="box upper bound (reference: 2.0, "
                        "src/FluidSimulator.cu:358). Scaled runs keep rest "
                        "density with wall = 2*(n/80k)^(1/3). 0 = reference "
                        "box")
    p.add_argument("--cell-capacity", type=int, default=0,
                   help="cell-table slots per cell of the cell backend "
                        "(0 = scene default)")
    p.add_argument("--max-occ", type=int, default=0,
                   help="cell-table rows of the cell backend (0 = derived "
                        "from n)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--backend", choices=BACKENDS, default="auto",
                   help="window: the CUDA window kernels (plain torch on "
                        "the CPU); cell: the cell table (plain torch; its "
                        "drops are table_overflow); dense: the all-pairs "
                        "oracle (no --devices); auto = window")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the state (cuda, cuda:N or cpu); "
                        "a CUDA request without a card fails")
    p.add_argument("--devices", type=int, default=0,
                   help="run the sharded decomposition (parallel/"
                        "sharded.py) on N ranks: 1 in-process, N > 1 one "
                        "process a rank (one card each with --device cuda, "
                        "which needs N cards); 0 = the single-device path")
    p.add_argument("--fake-devices", type=int, default=0,
                   help="JAX's N-device CPU mesh: here --device cpu "
                        "--devices N, so a JAX command line carries across")
    p.add_argument("--chunk", type=int, default=20,
                   help="steps per Rollout call; its stats are read back "
                        "once per chunk")
    p.add_argument("--retier-at", type=int, default=0,
                   help="with --devices: at absolute simulation step N "
                        "(the first chunk boundary >= N), re-size the "
                        "per-rank buffers from the current state "
                        "(ParallelConfig.compact) and continue; ghost or "
                        "plan/table overflow on that tier falls back to the "
                        "spawn tier, any other overflow aborts rc=2. "
                        "0 disables")
    p.add_argument("--retier-maxlanes", type=int, default=0,
                   help="JAX's lane budget at the re-tier; the port's "
                        "window plan has exact ranges and no lane budget, "
                        "so the value is dropped with a note")
    p.add_argument("--retier-geom", type=str, default="",
                   help="with --retier-at: comma-separated KernelGeometry "
                        "overrides of the port (own, seg, mxu_sum, "
                        "mxu_rd2, mxu_proj) for the compact tier, e.g. "
                        "'own=128,seg=1024'; the spawn tier keeps the run's "
                        "geometry. JAX's TPU-only keys (cc_d, cc_p, nbuf, "
                        "gb, maxlanes, chains_d, chains_p, ncopies) are "
                        "dropped and an own without a kernel runs the "
                        "port's default, each with a note")
    p.add_argument("--allow-overflow", action="store_true",
                   help="downgrade the neighbor-structure and exchange "
                        "overflow abort (rc=2) to a warning")
    p.add_argument("--metrics", type=str, default=None,
                   help="JSONL metrics path (default: stdout)")
    p.add_argument("--metrics-every", type=int, default=20,
                   help="steps between diagnostic records; 0 disables")
    p.add_argument("--render-every", type=int, default=0,
                   help="steps between PNG frames; 0 disables rendering")
    p.add_argument("--out", type=str, default="frames",
                   help="directory for rendered frames")
    p.add_argument("--gif", type=str, default=None,
                   help="also assemble rendered frames into an animated GIF")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--eye", type=float, nargs=3, default=None,
                   metavar=("X", "Y", "Z"),
                   help="camera position (reference spawns at -1.80 1.48 "
                        "-2.04, src/main.cpp:34)")
    p.add_argument("--target", type=float, nargs=3, default=None,
                   metavar=("X", "Y", "Z"), help="camera look-at point")
    p.add_argument("--fov", type=float, default=None,
                   help="vertical field of view in degrees (default 45)")
    p.add_argument("--orbit", type=float, default=0.0,
                   help="degrees of camera yaw around the look-at point per "
                        "rendered frame")
    p.add_argument("--profile", type=str, default=None,
                   help="write a torch.profiler trace (trace.json, Chrome "
                        "trace format) to this directory")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="checkpoint file to write")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="steps between checkpoints; 0 = only at the end")
    p.add_argument("--resume", type=str, default=None,
                   help="resume from a checkpoint of either package "
                        "(overrides scene/n)")
    return p


def config_from_args(args) -> SimConfig:
    make = blowup_config if args.scene == "blowup" else default_config
    overrides = dict(
        n=args.n,
        dt=args.dt,
        solver_iters=args.iters,
        cell_size=args.cell_size,
        grid_width=args.grid_width,
    )
    if args.wall:
        overrides["wall"] = args.wall
    if args.cell_capacity:
        overrides["cell_capacity"] = args.cell_capacity
    if args.max_occ:
        overrides["max_occupied_cells"] = args.max_occ
    return make(**overrides)


def _make_writer(args):
    render_kwargs = {}
    if args.eye is not None:
        render_kwargs["eye"] = tuple(args.eye)
    if args.target is not None:
        render_kwargs["target"] = tuple(args.target)
    if args.fov is not None:
        render_kwargs["fov"] = args.fov
    return frames.FrameWriter(args.out, args.width, args.height,
                              gif_path=args.gif, orbit_deg=args.orbit,
                              **render_kwargs)


def _pick_chunk(args) -> int:
    """Largest chunk (steps per Rollout call) that still honors every exact
    cadence: the gcd of the requested chunk and each active cadence.
    Coprime cadences (e.g. 7) force chunk=1, and the reduction is logged."""
    chunk = max(1, min(args.chunk, args.steps))
    for gate in (args.metrics_every, args.render_every, args.checkpoint_every):
        if gate:
            chunk = math.gcd(chunk, gate)
    if chunk < min(args.chunk, max(args.steps, 1)):
        print(f"note: chunk reduced {args.chunk} -> {chunk} to honor "
              "metrics/render/checkpoint cadences (larger divisible "
              "cadences amortize the per-call latency better)",
              file=sys.stderr)
    return chunk


def _start_profiler(device: torch.device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def _stop_profiler(prof, directory: str) -> None:
    prof.stop()
    os.makedirs(directory, exist_ok=True)
    prof.export_chrome_trace(os.path.join(directory, "trace.json"))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.fake_devices:
        args.device = "cpu"
        args.devices = args.devices or args.fake_devices
    if args.gif and not args.render_every:
        print("error: --gif requires --render-every (no frames are rendered)",
              file=sys.stderr)
        return 2
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.devices:
        return _main_mesh(args, device)
    if args.retier_at:
        print("warning: --retier-at applies only to the sharded path "
              "(--devices N); ignored", file=sys.stderr)

    cfg, state = _load(args, device)

    with MetricsLogger(args.metrics) as log:
        return _run(args, cfg, state, device, log)


def _load(args, device):
    """(config, state): the checkpoint's, or the scene's spawn."""
    if args.resume:
        return checkpoint.load(args.resume, device)
    cfg = config_from_args(args)
    return cfg, spawn(cfg, args.scene, args.seed, device=device)


def _run(args, cfg: SimConfig, state, device: torch.device,
         log: MetricsLogger) -> int:
    chunk = _pick_chunk(args)
    rollout = make_rollout(cfg, args.backend, chunk, with_stats=True,
                           device=device)
    writer = _make_writer(args) if args.render_every else None
    if writer:
        writer.submit(int(state.step), state.x)
    log.log(event="start", scene=args.scene, n=cfg.n, steps=args.steps,
            backend=args.backend, dt=cfg.dt, iters=cfg.solver_iters,
            device=str(device))

    prof = _start_profiler(device) if args.profile else None
    done = 0
    # the window plans' candidate pairs, read at each record's fence
    counter = (rollout.stepper.counters["plan_candidates"]
               if rollout.stepper.backend == "window" else None)
    counted = (0, 0)  # (steps the stepper took, candidate pairs) so far
    t_start = time.perf_counter()
    try:
        while done < args.steps:
            # the final partial chunk runs fewer steps on the same rollout
            this_chunk = min(chunk, args.steps - done)
            t0 = time.perf_counter()
            state, stats = rollout(state, this_chunk)
            ovf = stats.tolist()  # device -> host: the chunk's fence
            dt_wall = time.perf_counter() - t0
            done += this_chunk
            step_no = int(state.step)

            record = {
                "event": "progress", "step": step_no,
                "steps_per_sec": this_chunk / dt_wall,
                "particle_steps_per_sec": this_chunk * cfg.n / dt_wall,
                # summed over every step of the chunk, so nan_detected does
                # not depend on the metrics cadence
                "n_overflow": ovf[0],
                "plan_overflow": ovf[1],
                "nan_detected": ovf[2] > 0,
            }
            if counter is not None:
                # the chunk's fence has drained the stream: a copy, no wait;
                # a capture's warm-up step counts in both
                now = (rollout.stepped, int(counter))
                record["plan_candidates_per_step"] = (
                    (now[1] - counted[1]) / (now[0] - counted[0]))
                counted = now
            if args.metrics_every and done % args.metrics_every == 0:
                d = diagnostics_fn(cfg, state, rollout.stepper.scratch)
                record.update(
                    mean_density=float(d.mean_density),
                    max_density_err=float(d.max_density_err),
                    max_speed=float(d.max_speed),
                    n_escaped=int(d.n_escaped),
                )
            log.log(**record)
            if record["nan_detected"]:
                print("FATAL: non-finite state detected; aborting",
                      file=sys.stderr)
                return 2
            if ovf[0] + ovf[1]:
                msg = (f"overflow table={ovf[0]} plan={ovf[1]} in the chunk "
                       f"ending at step {step_no}")
                if not args.allow_overflow:
                    print(f"FATAL: {msg}; the neighbor structure truncated "
                          "particles (physics silently softened) — pass "
                          "--allow-overflow to continue; aborting",
                          file=sys.stderr)
                    return 2
                print(f"warning: {msg}; continuing under --allow-overflow",
                      file=sys.stderr)

            if writer and done % args.render_every == 0:
                writer.submit(step_no, state.x)
            if (args.checkpoint and args.checkpoint_every
                    and done % args.checkpoint_every == 0):
                checkpoint.save(args.checkpoint, cfg, state)
    finally:
        if prof is not None:
            _stop_profiler(prof, args.profile)
        if writer:
            writer.close()

    wall = time.perf_counter() - t_start
    if args.checkpoint:
        checkpoint.save(args.checkpoint, cfg, state)
    log.log(event="done", steps=done, wall_seconds=wall,
            steps_per_sec=done / wall,
            particle_steps_per_sec=done * cfg.n / wall,
            frames=writer.frames_written if writer else 0)
    return 0


# ---------------------------------------------------------------------------
# the sharded path (`--devices N`)
# ---------------------------------------------------------------------------

def _parse_geom(spec: str) -> dict:
    """--retier-geom 'key=int,...' -> KernelGeometry overrides, under the
    rule interop.config_from_fields applies to a JAX config: a key of JAX's
    TPU-only geometry (interop.TPU_GEOM_FIELDS) is dropped and an `own` the
    kernels lack becomes the port's default, each with a note on stderr.
    Raises ValueError on a key neither package has, a value that is not an
    integer, or a geometry the port refuses."""
    fields = {f.name: f.default for f in dataclasses.fields(KernelGeometry)}
    out = {}
    for kv in filter(None, spec.split(",")):
        k, _, v = kv.partition("=")
        k = k.strip()
        if k not in fields and k not in interop.TPU_GEOM_FIELDS:
            raise ValueError(f"{k!r} is a field of neither package's "
                             f"KernelGeometry (the port's: "
                             f"{', '.join(fields)})")
        try:
            val = int(v)
        except ValueError:
            raise ValueError(f"entry {kv!r} is not KEY=INT") from None
        if k in interop.TPU_GEOM_FIELDS:
            print(f"note: --retier-geom {k}={val}: the TPU kernels' knob "
                  "has no counterpart in the port; dropped", file=sys.stderr)
            continue
        if k == "own":
            val = interop.port_own(val)
        out[k] = bool(val) if isinstance(fields[k], bool) else val
    dataclasses.replace(KernelGeometry(), **out).validate()
    return out


def _main_mesh(args, device: torch.device) -> int:
    """Check the sharded run's options, then run it: one rank in-process,
    or one process a rank through parallel/launch.py. Returns rank 0's
    exit code, or 1 if a rank failed."""
    if args.backend == "dense":
        print("error: --backend dense has no sharded decomposition; use "
              "window or cell", file=sys.stderr)
        return 2
    if args.retier_maxlanes:
        print(f"note: --retier-maxlanes {args.retier_maxlanes}: the port's "
              "window plan has exact ranges and no lane budget to tighten; "
              "dropped", file=sys.stderr)
    try:
        geom_overrides = _parse_geom(args.retier_geom)
    except ValueError as e:
        print(f"error: bad --retier-geom: {e}", file=sys.stderr)
        return 2
    D = args.devices
    if device.type == "cuda" and torch.cuda.device_count() < D:
        print(f"error: --devices {D} on cuda needs {D} cards, "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    cfg, state = _load(args, "cpu")
    chunk = _pick_chunk(args)
    if args.retier_at:
        start = int(state.step)
        last_check = start + args.steps - (args.steps % chunk or chunk)
        if args.retier_at > last_check:
            print(f"warning: --retier-at {args.retier_at} is past the last "
                  f"re-tier check (step {last_check}, chunk-boundary "
                  "granularity); the re-tier will never fire",
                  file=sys.stderr)
    job = (args, resolve_backend(args.backend), cfg,
           interop.state_to_numpy(state), chunk, geom_overrides)
    if D == 1:
        return _mesh_run(None, device, *job)
    devices = ([f"cuda:{r}" for r in range(D)] if device.type == "cuda"
               else ["cpu"] * D)
    with tempfile.TemporaryDirectory(prefix="pbf_mesh_") as workdir:
        try:
            launch.run(_mesh_rank, D, devices, workdir=workdir, args=job)
        except launch.RankFailure as e:
            print(f"FATAL: {e}", file=sys.stderr)
            return 1
        with open(os.path.join(workdir, "rc")) as f:
            return int(f.read())


def _mesh_rank(group, device, workdir, *job) -> None:
    """A rank of the sharded runner; rank 0 leaves the exit code."""
    rc = _mesh_run(group, device, *job)
    if group.rank == 0:
        with open(os.path.join(workdir, "rc"), "w") as f:
            f.write(str(rc))


def _mesh_run(group, device, args, backend: str, cfg: SimConfig, arrays,
              chunk: int, geom_overrides: dict) -> int:
    """The sharded runner on one rank (`_main_mesh` of the JAX runner):
    every rank steps its slab and takes part in each collective; rank 0
    writes the metrics, frames, GIF and checkpoint. Every decision reads
    gathered stats, so all ranks take it together."""
    lead = group is None or group.rank == 0
    with MetricsLogger(args.metrics if lead else os.devnull) as log:
        return _mesh_loop(group, device, args, backend, cfg, arrays, chunk,
                          geom_overrides, lead, log)


def _mesh_loop(group, device, args, backend: str, cfg: SimConfig, arrays,
               chunk: int, geom_overrides: dict, lead: bool,
               log: MetricsLogger) -> int:
    D = args.devices
    state = interop.state_from_numpy(*arrays, "cpu")
    start_step = int(state.step)
    retier_cfg = (dataclasses.replace(cfg, geom=dataclasses.replace(
        cfg.geom, **geom_overrides)) if geom_overrides else cfg)

    def say(msg: str) -> None:
        if lead:
            print(msg, file=sys.stderr)

    pcfg = sharded.ParallelConfig.create(cfg, D, state=state)
    cfg_active = cfg
    sst = sharded.distribute(cfg, pcfg, state, group, device)
    # a tier's rollout (its stepper, scratch and, on a card, its graph) and
    # diagnostics, built at the tier's first chunk
    rollout = density_diag = None
    done = 0

    def collected():
        st = sharded.collect(sst, group)
        return st._replace(step=torch.tensor(start_step + done,
                                             dtype=torch.int32))

    def rebuild(new_pcfg, st, new_cfg):
        """Move to another tier: the old tier's graph, buffers and scratch
        are freed before the new tier allocates its own."""
        nonlocal pcfg, cfg_active, rollout, density_diag, sst
        if rollout is not None:
            rollout.release()
        rollout = density_diag = sst = None
        pcfg, cfg_active = new_pcfg, new_cfg
        sst = sharded.distribute(cfg_active, pcfg, st, group, device)

    def tier_record(event, old, **extra):
        return dict(event=event, step=start_step + done, **extra,
                    capacity=[old.capacity, pcfg.capacity],
                    ghost_capacity=[old.ghost_capacity, pcfg.ghost_capacity],
                    mig_capacity=[old.mig_capacity, pcfg.mig_capacity])

    writer = _make_writer(args) if lead and args.render_every else None
    if writer:
        writer.submit(start_step, state.x)
    log.log(event="start", scene=args.scene, n=cfg.n, steps=args.steps,
            backend=backend, dt=cfg.dt, iters=cfg.solver_iters, devices=D,
            device=str(device))
    tier, retiered = "spawn", False
    t_start = time.perf_counter()
    try:
        while done < args.steps:
            if (args.retier_at and not retiered
                    and start_step + done >= args.retier_at):
                st, old = collected(), pcfg
                rebuild(sharded.ParallelConfig.compact(cfg, D, state=st,
                                                       prior=pcfg),
                        st, retier_cfg)
                retiered, tier = True, "compact"
                log.log(**tier_record("retier", old,
                                      geom=[dataclasses.asdict(cfg.geom),
                                            dataclasses.asdict(
                                                cfg_active.geom)]))
            if rollout is None:
                rollout, density_diag = sharded.tier_programs(
                    cfg_active, pcfg, group, backend, chunk, device)
            # the final partial chunk runs fewer steps on the same rollout
            this_chunk = min(chunk, args.steps - done)
            t0 = time.perf_counter()
            sst, stats, sdiag = rollout(sst, this_chunk)
            stats, sdiag = stats.cpu().numpy(), sdiag.cpu().numpy()
            dt_wall = time.perf_counter() - t0
            done += this_chunk
            step_no = start_step + done

            act = stats[:, 0]
            overflows = stats[:, 1:].sum(axis=0).tolist()
            record = {
                "event": "progress", "step": step_no,
                "steps_per_sec": this_chunk / dt_wall,
                "particle_steps_per_sec": this_chunk * cfg.n / dt_wall,
                "per_shard_active": act.tolist(),
                "balance_min_over_mean": float(act.min()
                                               / max(act.mean(), 1)),
                "overflows": overflows,
                "max_speed": float(sdiag[:, 0].max()),
                "n_escaped": int(sdiag[:, 1].sum()),
                "nan_detected": bool(sdiag[:, 2].sum() > 0),
            }
            if args.metrics_every and done % args.metrics_every == 0:
                d = density_diag(sst).cpu().numpy()
                w = np.maximum(act, 1).astype(np.float64)
                record.update(
                    mean_density=float((d[:, 0] * w).sum() / w.sum()),
                    max_density_err=float(d[:, 1].max()))
            log.log(**record)
            if record["nan_detected"]:
                say("FATAL: non-finite state detected; aborting")
                return 2
            if sum(overflows):
                msg = (f"{tier}-tier overflow {overflows} (mig/merge/ghost/"
                       f"plan-or-table) at step {step_no}")
                if args.allow_overflow:
                    say(f"warning: {msg}; continuing under --allow-overflow")
                elif tier == "compact" and not overflows[0] + overflows[1]:
                    # ghost and plan/table overflow only soften the step's
                    # physics; migration and merge overflow drop particles
                    say(f"warning: {msg}; falling back to the spawn tier")
                    st, old = collected(), pcfg
                    rebuild(sharded.ParallelConfig.create(
                        cfg, D, state=st, rebalance=pcfg.rebalance,
                        ghost_rows=pcfg.ghost_rows), st, cfg)
                    tier = "spawn"
                    log.log(**tier_record("tier_fallback", old,
                                          overflows=overflows))
                else:
                    say(f"FATAL: {msg}; buffers truncated (migration and "
                        "merge overflow drop particles) — raise capacities "
                        "or pass --allow-overflow; aborting")
                    return 2

            if args.render_every and done % args.render_every == 0:
                st = collected()
                if writer:
                    writer.submit(step_no, st.x)
            if (args.checkpoint and args.checkpoint_every
                    and done % args.checkpoint_every == 0):
                st = collected()
                if lead:
                    checkpoint.save(args.checkpoint, cfg, st)
    finally:
        if writer:
            writer.close()

    wall = time.perf_counter() - t_start
    if args.checkpoint:
        st = collected()
        if lead:
            checkpoint.save(args.checkpoint, cfg, st)
    log.log(event="done", steps=done, wall_seconds=wall,
            steps_per_sec=done / wall,
            particle_steps_per_sec=done * cfg.n / wall, devices=D,
            frames=writer.frames_written if writer else 0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
