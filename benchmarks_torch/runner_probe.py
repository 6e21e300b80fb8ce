#!/usr/bin/env python3
"""What the runner's diagnostics cost end to end, and how busy the card is.

Run from the repository root on a machine with one CUDA card and nvcc:

    python3 benchmarks_torch/runner_probe.py

Drives `pdb_sph_tpu_torch.cli.main` in-process on the 80k dam break, 240
steps in chunks of 20, no frames: after one warm-up run, `--rounds` rounds
of four runs in the order no diagnostics, diagnostics every 20, every 20,
none (`--metrics-every 0` / `20`), each reporting its `done` steps/s and
the median of its chunk rates (chunks 2-12). Then one `--profile` run of
40 steps with diagnostics every 20, whose trace gives the device's busy
share of the profiled span (kernel intervals merged; the profiler is on)
and each kernel's launches and device time.
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


def _busy(trace_path: Path, steps: int) -> None:
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    iv = sorted((e["ts"], e["ts"] + e["dur"]) for e in kern)
    busy, cur_s, cur_e = 0.0, iv[0][0], iv[0][1]
    for s, e in iv[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = iv[-1][1] - iv[0][0]
    print(f"[profile] {len(kern)} kernels ({len(kern) / steps:.1f} per "
          f"step); device busy {busy / 1e3:.3f} ms of {span / 1e3:.3f} ms "
          f"span = {100 * busy / span:.1f} % (idle "
          f"{100 - 100 * busy / span:.1f} %)")
    by: dict[str, tuple[int, float]] = {}
    for e in kern:
        n, d = by.get(e["name"], (0, 0.0))
        by[e["name"]] = (n + 1, d + e["dur"])
    for name, (n, d) in sorted(by.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"[profile]   {d / 1e3:9.3f} ms {n:5d} launches  {name[:110]}")


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

    prof = OUT / "prof"
    _run("prof", ["--metrics-every", "20", "--profile", str(prof)], steps=40)
    _busy(prof / "trace.json", 40)
    return 0


if __name__ == "__main__":
    sys.exit(main())
