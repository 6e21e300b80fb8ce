#!/usr/bin/env python3
"""A/B of the FP32 solve kernels against their tensor-core forms.

Run from the repository root on a machine with one CUDA card and nvcc:

    python3 benchmarks_torch/geometry_ab.py

On the 80k dam break at step 60 (mid-collapse) and at step 480 (settled),
times every form of the density and project passes through the port's
own wrappers (`cuda_pbf.density_pass`, `cuda_pbf.project_pass`), each in
the geometry that selects it: medians of 20 CUDA-event timed launches, the
forms in order and then in reverse, `--rounds` times. The `sum` forms
differ from the FP32 kernels in their thread layout (one warp per 16 own
rows, four pair elements a thread per 8-candidate tile) and in the row
sums of the epilogue, so they separate the layout from the tensor-core
rd2 and delta-p. Then the 240-step rollout after a 240-step settle chunk,
in the default geometry and with every switch on, in the order default,
tensor-core, tensor-core, default (host clock, fenced). Writes
chiprun_out/geometry_ab.json.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT.parent))
sys.path.insert(0, str(ROOT))

from kernel_ab import N, REPS, STATES, _state_inputs  # noqa: E402

ALL = dict(mxu_rd2=True, mxu_sum=True, mxu_proj=True)
FORMS = {  # pass -> form -> the geometry's switches
    "density": {"fp32": {}, "sum": dict(mxu_sum=True),
                "rd2": dict(mxu_rd2=True), "rd2_sum": ALL},
    "project": {"fp32": {}, "sum": dict(mxu_sum=True),
                "proj": dict(mxu_proj=True), "proj_sum": ALL},
}
ROLLOUT_STEPS = 240


def _rollout_rate(cfg, device) -> float:
    """steps/s of one fenced rollout chunk after a settle chunk."""
    import pdb_sph_tpu_torch as pbf
    from pdb_sph_tpu_torch.utils.timing import fence

    rollout = pbf.make_rollout(cfg, "window", ROLLOUT_STEPS, with_stats=True,
                               device=device)
    state, _ = rollout(pbf.spawn(cfg, "dam_break", seed=0, device=device))
    fence(device)
    t0 = time.perf_counter()
    state, stats = rollout(state)
    fence(device)
    secs = time.perf_counter() - t0
    if stats.tolist() != [0, 0, 0] or not torch.isfinite(state.x).all():
        raise AssertionError(f"rollout in {cfg.geom} went wrong: {stats}")
    return ROLLOUT_STEPS / secs


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default="chiprun_out/geometry_ab.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("geometry_ab: needs a CUDA card", file=sys.stderr)
        return 1
    import pdb_sph_tpu_torch as pbf
    from pdb_sph_tpu_torch.ops import cuda_pbf
    from pdb_sph_tpu_torch.utils.timing import cuda_ms

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    device = torch.device("cuda", 0)
    cfg = pbf.default_config(n=N)

    def geom_cfg(switches):
        return dataclasses.replace(
            cfg, geom=dataclasses.replace(cfg.geom, **switches))

    result = {"card": card, "states": [], "rollout_steps_per_s": {}}
    for step, p4, _, plan, d4, mean_c, max_c in _state_inputs(cfg, device,
                                                              STATES):
        buf = torch.empty_like(p4)
        scratch = cuda_pbf.alloc_scratch(cfg, p4.shape[0], device)
        row = {"step": step, "candidates_mean": mean_c,
               "candidates_max": max_c}
        for name, forms in FORMS.items():
            wrapper = getattr(cuda_pbf, f"{name}_pass")
            src = p4 if name == "density" else d4
            times = {form: [] for form in forms}
            order = list(forms)
            for _ in range(args.rounds):
                for form in order + order[::-1]:
                    c = geom_cfg(forms[form])
                    times[form].append(cuda_ms(
                        lambda: wrapper(c, src, plan, N, buf, scratch),
                        REPS))
            for form, v in times.items():
                row[f"{name}_{form}_ms"] = v
                row[f"{name}_{form}_median_ms"] = statistics.median(v)
            base = row[f"{name}_fp32_median_ms"]
            print(f"[ab] step {step} (candidates/chunk mean {mean_c:.1f} "
                  f"max {max_c}) {name}: " + ", ".join(
                      f"{form} {row[f'{name}_{form}_median_ms']:.4f} ms "
                      f"(x{row[f'{name}_{form}_median_ms'] / base:.4f})"
                      for form in forms))
        result["states"].append(row)

    rates = {"default": [], "tensor_core": []}
    for tag in ("default", "tensor_core", "tensor_core", "default"):
        rates[tag].append(_rollout_rate(
            geom_cfg(ALL if tag == "tensor_core" else {}), device))
    result["rollout_steps_per_s"] = rates
    print(f"[ab] rollout n={N}, {ROLLOUT_STEPS} steps after a settle chunk, "
          f"order default, tensor_core, tensor_core, default: steps/s "
          f"default {rates['default']}, tensor_core {rates['tensor_core']}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
