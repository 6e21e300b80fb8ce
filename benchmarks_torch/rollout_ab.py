#!/usr/bin/env python3
"""A/B of the 80k dam-break rollout between this tree and another checkout.

Run from the repository root on a machine with one CUDA card and nvcc:

    git archive <commit> | tar -x -C build/ab/parent
    python3 benchmarks_torch/rollout_ab.py --parent build/ab/parent

Runs the rollout of `pdb_sph_tpu_torch` from each checkout in a process of
its own, in the order parent, tree, tree, parent (`--rounds` times); each
process builds its checkout's kernels into that checkout's `build/`. One
run: the 80k dam break in the geometry `geometry_from_env` gives (the
default one; `PBF_MXU_SUM=1 PBF_MXU_RD2=1 PBF_MXU_PROJ=1` in the
environment runs both checkouts with every tensor-core switch on), a
240-step settle chunk, then a
timed 240-step rollout (host clock, fenced: steps/s), then the median of
20 steps of the stage breakdown from CUDA events recorded between the
stages (the `mark` hook of `Stepper.step`). Writes
chiprun_out/rollout_ab.json.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N = 80_000
STEPS = 240
REPS = 20


def _stages(stepper, state) -> dict:
    """Median ms of each stage over REPS steps; repeated stages summed."""
    import torch

    per_step = []
    for _ in range(REPS):
        marks = [("start", torch.cuda.Event(enable_timing=True))]
        marks[0][1].record()

        def mark(name, marks=marks):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))

        state = stepper.step(state, mark=mark)
        per_step.append(marks)
    torch.cuda.synchronize()
    stages: dict[str, list[float]] = {}
    for marks in per_step:
        acc: dict[str, float] = {}
        for (_, a), (name, b) in zip(marks, marks[1:]):
            acc[name] = acc.get(name, 0.0) + a.elapsed_time(b)
        for name, ms in acc.items():
            stages.setdefault(name, []).append(ms)
    return {name: statistics.median(v) for name, v in stages.items()}


def run_one(root: Path) -> dict:
    """One rollout of the package found under `root`."""
    sys.path.insert(0, str(root))
    import torch

    import pdb_sph_tpu_torch as pbf
    from pdb_sph_tpu_torch.utils.timing import fence

    if Path(pbf.__file__).resolve().parents[1] != root.resolve():
        raise RuntimeError(f"imported {pbf.__file__}, not from {root}")
    device = torch.device("cuda", 0)
    cfg = pbf.default_config(n=N)
    rollout = pbf.make_rollout(cfg, "window", STEPS, with_stats=True,
                               device=device)
    state, _ = rollout(pbf.spawn(cfg, "dam_break", seed=0, device=device))
    fence(device)
    t0 = time.perf_counter()
    state, stats = rollout(state)
    fence(device)
    secs = time.perf_counter() - t0
    if stats.tolist() != [0, 0, 0] or not torch.isfinite(state.x).all():
        raise AssertionError(f"rollout went wrong: stats {stats.tolist()}")
    stages = _stages(rollout.stepper, state)
    return {"steps_per_s": STEPS / secs, "seconds": secs, "stages_ms": stages,
            "stages_sum_ms": sum(stages.values()), "geom": repr(cfg.geom)}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path,
                    help="the other checkout (its root directory)")
    ap.add_argument("--one", type=Path,
                    help="run once from this checkout and print JSON")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out", default="chiprun_out/rollout_ab.json")
    args = ap.parse_args(argv)
    if args.one is not None:
        print(json.dumps(run_one(args.one)))
        return 0
    if args.parent is None:
        ap.error("give --parent (or --one)")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    roots = {"parent": args.parent.resolve(), "tree": ROOT}
    runs = {"parent": [], "tree": []}
    for _ in range(args.rounds):
        for tag in ("parent", "tree", "tree", "parent"):
            res = subprocess.run(
                [sys.executable, __file__, "--one", str(roots[tag])],
                capture_output=True, text=True, cwd=roots[tag])
            if res.returncode != 0:
                print(res.stdout + res.stderr, file=sys.stderr)
                raise RuntimeError(f"{tag} run failed ({res.returncode})")
            r = json.loads(res.stdout.strip().splitlines()[-1])
            runs[tag].append(r)
            print(f"[rollout] {tag} ({r['geom']}): "
                  f"{r['steps_per_s']:.2f} steps/s "
                  f"({N * r['steps_per_s']:.1f} particle-steps/s); stages "
                  "(median of 20 steps, CUDA events, ms): " + ", ".join(
                      f"{k} {v:.4f}" for k, v in r["stages_ms"].items())
                  + f"; sum {r['stages_sum_ms']:.4f}")
    for tag, rs in runs.items():
        rate = statistics.median(r["steps_per_s"] for r in rs)
        print(f"[rollout] {tag}: median {rate:.2f} steps/s")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "n": N, "steps": STEPS, "runs": runs}, f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
