#!/usr/bin/env python3
"""What the runner's diagnostics cost end to end, and how busy the card is.

Run from the repository root on a machine with one CUDA card and nvcc:

    python3 benchmarks_torch/runner_probe.py

Drives `pdb_sph_tpu_torch.cli.main` in-process on the 80k dam break, 240
steps in chunks of 20, no frames (its rollout runs as a CUDA graph): after
one warm-up run, `--rounds` rounds of four runs in the order no
diagnostics, diagnostics every 20, every 20, none (`--metrics-every 0` /
`20`), each reporting its `done` steps/s and the median of its chunk rates
(chunks 2-12). Then one `--profile` run of 40 steps with diagnostics every
20, and, on the state the 240-step settle chunk leaves, 40 steps of the
eager `Stepper.step` loop and 40 of the graph `Rollout`, each profiled:
the device's busy share of the profiled span (kernel intervals merged; the
profiler is on), its kernels a step and their device ms a step, and each
kernel's launches and device time.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "runner_probe"


def _run(tag: str, extra: list[str], steps: int = 240) -> tuple[float, float]:
    from pdb_sph_tpu_torch import cli

    metrics = OUT / f"{tag}.jsonl"
    metrics.unlink(missing_ok=True)
    rc = cli.main(["--scene", "dam_break", "--n", "80000", "--steps",
                   str(steps), "--chunk", "20", "--device", "cuda",
                   "--metrics", str(metrics), *extra])
    if rc != 0:
        raise AssertionError(f"cli exited {rc}: {extra}")
    records = [json.loads(line) for line in metrics.read_text().splitlines()]
    prog = [r for r in records if r["event"] == "progress"]
    return records[-1]["steps_per_sec"], statistics.median(
        r["steps_per_sec"] for r in prog[1:])


def _report(tag: str, r: dict, steps: int) -> None:
    if not r["kernels"]:
        print(f"[profile] {tag}: the trace holds no kernels; busy share not "
              "measured")
        return
    print(f"[profile] {tag}: {r['kernels']} kernels "
          f"({r['kernels'] / steps:.1f} a step), "
          f"{r['kernel_ms'] / steps:.4f} device ms a step; device busy "
          f"{r['busy_ms']:.3f} ms of {r['span_ms']:.3f} ms span = "
          f"{100 * r['busy_share']:.1f} % (idle "
          f"{100 - 100 * r['busy_share']:.1f} %)")
    for name, n, ms in r["by_name"][:8]:
        print(f"[profile]   {ms:9.3f} ms {n:5d} launches  {name[:110]}")


def _eager_vs_graph(steps: int = 40) -> None:
    """The eager Stepper loop and the graph Rollout, `steps` each, profiled
    from the settled state."""
    import pdb_sph_tpu_torch as pbf
    from pdb_sph_tpu_torch.utils.timing import profile_kernels

    device = torch.device("cuda", 0)
    cfg = pbf.default_config(n=80_000)
    rollout = pbf.make_rollout(cfg, "window", 240, with_stats=True,
                               device=device)
    state, _ = rollout(pbf.spawn(cfg, "dam_break", seed=0, device=device))
    stepper = rollout.stepper

    def eager():
        s = state
        total = torch.zeros((3,), dtype=torch.int32, device=device)
        for _ in range(steps):
            s, stats = stepper.step(s, with_stats=True)
            total += stats

    for tag, fn in (("eager Stepper loop", eager),
                    ("graph Rollout", lambda: rollout(state, steps))):
        _report(f"{tag}, {steps} steps",
                profile_kernels(fn, OUT / f"{tag.split()[0]}.json"), steps)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("runner_probe: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"{card} | torch {torch.__version__}")
    os.makedirs(OUT, exist_ok=True)

    _run("warm", ["--metrics-every", "0"])
    res: dict[str, list[tuple[float, float]]] = {"nodiag": [], "diag20": []}
    for _ in range(args.rounds):
        for tag in ("nodiag", "diag20", "diag20", "nodiag"):
            every = "0" if tag == "nodiag" else "20"
            res[tag].append(_run(tag, ["--metrics-every", every]))
    for tag, v in res.items():
        print(f"[abba] {tag}: done steps/s {[round(a, 2) for a, _ in v]}; "
              f"median chunk steps/s {[round(b, 2) for _, b in v]}; median "
              f"of done {statistics.median(a for a, _ in v):.2f}")

    from pdb_sph_tpu_torch.utils.timing import kernel_busy

    prof = OUT / "prof"
    _run("prof", ["--metrics-every", "20", "--profile", str(prof)], steps=40)
    _report("runner, 40 steps, diagnostics every 20",
            kernel_busy(prof / "trace.json"), 40)
    _eager_vs_graph()
    return 0


if __name__ == "__main__":
    sys.exit(main())
