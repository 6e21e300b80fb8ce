"""Headless simulation runner of the port: the single-device path of
`pdb_sph_tpu/cli.py` (`:29-196`, `:427-554`) on PyTorch.

Same flags, JSONL records, frames, checkpoints and aborts as the JAX
runner; a JAX command line (and a JAX checkpoint) carries across. What
differs: `--backend` takes the port's names (`auto`/`window`/`dense`), and
`--device` (default `cuda`) names where the state lives. A CUDA request
without a card exits non-zero; it never moves to the CPU.

Examples:
    python -m pdb_sph_tpu_torch.cli --scene dam_break --n 80000 --steps 600
    python -m pdb_sph_tpu_torch.cli --scene blowup --render-every 10 --out frames/
    python -m pdb_sph_tpu_torch.cli --resume ckpt.npz --steps 100
    python -m pdb_sph_tpu_torch.cli --device cpu --n 2048 --steps 20
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

import torch

from .config import SCENES, SimConfig, blowup_config, default_config
from .core.step import BACKENDS, diagnostics_fn, make_rollout
from .io import checkpoint, frames
from .models.scenes import spawn
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
                   help="the JAX cell table's slots per cell; inert here, "
                        "kept so a JAX command line and checkpoint carry "
                        "across (0 = scene default)")
    p.add_argument("--max-occ", type=int, default=0,
                   help="the JAX cell table's rows; inert here, kept like "
                        "--cell-capacity (0 = derived from n)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--backend", choices=BACKENDS, default="auto",
                   help="window: the CUDA window kernels (plain torch on "
                        "the CPU); dense: the all-pairs oracle; auto = "
                        "window")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the state (cuda, cuda:N or cpu); "
                        "a CUDA request without a card fails")
    p.add_argument("--chunk", type=int, default=20,
                   help="steps per Rollout call; its stats are read back "
                        "once per chunk")
    p.add_argument("--allow-overflow", action="store_true",
                   help="downgrade the neighbor-structure overflow abort "
                        "(rc=2) to a warning; the port's structures have "
                        "no capacity, so its counters read 0")
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
    if args.gif and not args.render_every:
        print("error: --gif requires --render-every (no frames are rendered)",
              file=sys.stderr)
        return 2
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.resume:
        cfg, state = checkpoint.load(args.resume, device)
    else:
        cfg = config_from_args(args)
        state = spawn(cfg, args.scene, args.seed, device=device)

    with MetricsLogger(args.metrics) as log:
        return _run(args, cfg, state, device, log)


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
    t_start = time.perf_counter()
    try:
        while done < args.steps:
            this_chunk = min(chunk, args.steps - done)
            if this_chunk != chunk:  # final partial chunk: exact step count
                rollout = make_rollout(cfg, args.backend, this_chunk,
                                       with_stats=True, device=device)
            t0 = time.perf_counter()
            state, stats = rollout(state)
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
            if args.metrics_every and done % args.metrics_every == 0:
                d = diagnostics_fn(cfg, state)
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


if __name__ == "__main__":
    sys.exit(main())
