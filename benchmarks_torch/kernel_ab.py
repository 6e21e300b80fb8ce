#!/usr/bin/env python3
"""A/B of the solve kernels between two versions of csrc/pbf_window.cu.

Run from the repository root on a machine with one CUDA card and nvcc:

    git show <commit>:pdb_sph_tpu_torch/csrc/pbf_window.cu > build/ab/base.cu
    python3 benchmarks_torch/kernel_ab.py --base build/ab/base.cu

Builds the tree's source and the base source with the same nvcc flags,
each into its own library, and drives the port's own wrappers
(`cuda_pbf.density_pass`, `cuda_pbf.project_pass`) with each library in
turn on the same inputs: the 80k dam break at step 60 (mid-collapse) and
at step 480 (settled). Launch times are medians of 20 CUDA-event timed
launches, taken in the order base, tree, tree, base, `--rounds` times.
The two libraries' outputs must be bitwise equal. The density kernel's
lambda form is also compared as PTX, symbol names and label numbers aside
(the differing lines are printed), and each build's ptxas register report
is printed.
"""

from __future__ import annotations

import argparse
import difflib
import json
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
N = 80_000
STATES = (60, 480)
REPS = 20


def _entries(ptx: str) -> dict[str, list[str]]:
    """PTX entry name -> its lines, every mangled symbol (the entry, its
    parameters, the shared array) replaced by `SYM` and the function's
    index dropped from its block labels: the anonymous namespace's
    mangling differs from one source file to another, and the labels
    number the functions in file order."""
    out, name, body = {}, None, []
    for line in ptx.splitlines():
        m = re.search(r"\.entry\s+(\S+)\(", line)
        if m:
            name, body = m.group(1), []
        if name is not None:
            line = re.sub(r"\$L__BB\d+_", "$L__BB_", line)
            body.append(re.sub(r"_Z\w+", "SYM", line))
            if line.strip() == "}":
                out[name], name = body, None
    return out


def _lambda_ptx(src: Path, out_dir: Path, tag: str) -> tuple[str, list[str]]:
    from pdb_sph_tpu_torch.utils.cuda_build import find_nvcc

    out_dir.mkdir(parents=True, exist_ok=True)
    ptx = out_dir / f"{tag}.ptx"
    subprocess.run([find_nvcc(), "-arch=sm_90a", "-std=c++17", "-O3", "-ptx",
                    "-o", str(ptx), str(src)], check=True)
    entries = {k: v for k, v in _entries(ptx.read_text()).items()
               if "density_lambda_kernel" in k}
    # the template's lambda form is DensityOut::kLambda, enumerator 0
    name = (next(iter(entries)) if len(entries) == 1
            else next(k for k in entries if "E0E" in k))
    return name, entries[name]


def _state_inputs(cfg, device, steps_to: tuple[int, ...]):
    """(step, p4, plan, lambda-carrying p4) for the dam at each step."""
    import pdb_sph_tpu_torch as pbf
    from pdb_sph_tpu_torch.core.step import sort_cells
    from pdb_sph_tpu_torch.ops import cuda_pbf, hashgrid

    state, at, out = pbf.spawn(cfg, "dam_break", seed=0, device=device), 0, []
    for step in steps_to:
        state = pbf.make_rollout(cfg, "window", step - at,
                                 device=device)(state)
        at = step
        sorted_cid, order = sort_cells(cfg, hashgrid.cell_ids(cfg, state.x))
        p4 = torch.zeros((sorted_cid.shape[0], 4), dtype=torch.float32,
                         device=device)
        p4[:N, :3] = state.x[order]
        plan = cuda_pbf.build_plan(cfg, sorted_cid)
        lens = (plan.ranges[..., 1] - plan.ranges[..., 0]).sum(dim=1)
        out.append((step, p4, plan, cuda_pbf.density_pass(cfg, p4, plan, N),
                    float(lens.float().mean()), int(lens.max())))
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, type=Path,
                    help="the other version of csrc/pbf_window.cu")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default="chiprun_out/kernel_ab.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import pdb_sph_tpu_torch as pbf
    from pdb_sph_tpu_torch.ops import cuda_pbf
    from pdb_sph_tpu_torch.utils import cuda_build
    from pdb_sph_tpu_torch.utils.timing import cuda_ms

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    ab_dir = ROOT / "build" / "kernel_ab"
    tree_src = cuda_build.CSRC / "pbf_window.cu"
    libs = {"tree": cuda_build.load_kernels(),
            "base": cuda_build.build_library([args.base.resolve()], ab_dir)}
    for tag, kl in libs.items():
        regs = [ln.strip() for ln in kl.log.splitlines() if "registers" in ln]
        print(f"[build] {tag}: {kl.path.name}; ptxas: {' | '.join(regs)}")

    names, ptx = {}, {}
    for tag, src in (("tree", tree_src), ("base", args.base.resolve())):
        names[tag], ptx[tag] = _lambda_ptx(src, ab_dir, tag)
    same_ptx = ptx["tree"] == ptx["base"]
    diff = sum(a != b for a, b in zip(ptx["tree"], ptx["base"])) + abs(
        len(ptx["tree"]) - len(ptx["base"]))
    print(f"[ptx] lambda kernel: tree {names['tree']} ({len(ptx['tree'])} "
          f"lines), base {names['base']} ({len(ptx['base'])} lines); "
          f"identical {same_ptx} ({diff} lines differ)")
    udiff = list(difflib.unified_diff(ptx["base"], ptx["tree"], "base",
                                      "tree", n=0, lineterm=""))
    for line in udiff[:60]:
        print(f"[ptx]   {line}")

    device = torch.device("cuda", 0)
    cfg = pbf.default_config(n=N)
    result = {"card": card, "lambda_ptx_identical": same_ptx, "states": []}
    loader = cuda_build.load_kernels
    try:
        for step, p4, plan, d4, mean_c, max_c in _state_inputs(
                cfg, device, STATES):
            outs, times = {}, {t: {"density_lambda": [], "project": []}
                               for t in libs}
            buf = torch.empty_like(p4)
            for _ in range(args.rounds):
                for tag in ("base", "tree", "tree", "base"):
                    cuda_build.load_kernels = (lambda kl=libs[tag]: kl)
                    times[tag]["density_lambda"].append(cuda_ms(
                        lambda: cuda_pbf.density_pass(cfg, p4, plan, N, buf),
                        REPS))
                    times[tag]["project"].append(cuda_ms(
                        lambda: cuda_pbf.project_pass(cfg, d4, plan, N, buf),
                        REPS))
                    outs[tag] = (cuda_pbf.density_pass(cfg, p4, plan, N),
                                 cuda_pbf.project_pass(cfg, d4, plan, N))
            equal = all(torch.equal(a, b)
                        for a, b in zip(outs["tree"], outs["base"]))
            row = {"step": step, "candidates_mean": mean_c,
                   "candidates_max": max_c, "bitwise_equal": equal}
            for tag in libs:
                for k, v in times[tag].items():
                    row[f"{k}_{tag}_ms"] = v
                    row[f"{k}_{tag}_median_ms"] = statistics.median(v)
            result["states"].append(row)
            print(f"[ab] step {step} (candidates/chunk mean {mean_c:.1f} "
                  f"max {max_c}): outputs bitwise equal {equal}")
            for k in ("density_lambda", "project"):
                b, t = (row[f"{k}_{x}_median_ms"] for x in ("base", "tree"))
                print(f"[ab]   {k}: base {b:.4f} ms, tree {t:.4f} ms "
                      f"(tree/base {t / b:.4f}); base runs "
                      f"{row[f'{k}_base_ms']}, tree runs "
                      f"{row[f'{k}_tree_ms']}")
            if not equal:
                raise AssertionError("the two builds' outputs differ")
    finally:
        cuda_build.load_kernels = loader
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
