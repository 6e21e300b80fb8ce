#!/usr/bin/env python3
"""A/B of the FP32 kernels between two versions of csrc/pbf_window.cu, and
the sweep of the work items' segment length.

Run from the repository root on a machine with one CUDA card and nvcc:

    git show <commit>:pdb_sph_tpu_torch/csrc/pbf_window.cu > build/ab/base.cu
    python3 benchmarks_torch/kernel_ab.py --base build/ab/base.cu

Builds the tree's source and the base source with the same nvcc flags,
each into its own library, and runs K1 (lambda), K2 (project) and K1's rho
output of each on the same inputs, the states of `--states`: by default
the 80k dam break at step 60 (mid-collapse) and at step 480 (settled, the
heaviest own-chunks), and the 1M dam break (wall 4.64) at step 60; the
1M blowup (`blowup1m`) is a scene of its own. The tree's kernels go
through the port's wrappers; a base with another launcher interface
(`pbf_window_abi`) is launched directly with its own arguments: interface
2 is the work table without the evaluated-pair counter (before the cull),
and a library without the symbol is the one-block-per-chunk design.
Launch times are medians of 20 CUDA-event timed launches, taken in the
order base, tree, tree, base, `--rounds` times. Outputs must agree
within the kernels' tolerances (chip_smoke.py's); whether they are also
bitwise equal is reported beside (a change to the cull's groups changes
which pairs each row's sum takes and in what order). Then the tree's kernels
at every segment length of `--segs` (the geometry's `seg`), in order and
reversed, on the 80k states. A variant of a kernel
constant (the ring's `kStageLen`, `kStages`) is A/B'd as a variant source
through `--base`. Each build's ptxas register report is printed. Writes
chiprun_out/kernel_ab.json.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple

import torch

ROOT = Path(__file__).resolve().parents[1]
# scene -> (the scene spawned, n, wall or None for the default)
SCENES = {"80k": ("dam_break", 80_000, None),
          "1m": ("dam_break", 1_000_000, 4.64),
          "blowup1m": ("blowup", 1_000_000, 4.64)}
STATES = "80k:60,80k:480,1m:60"
REPS = 20
KINDS = ("density_lambda", "project", "density_rho")
# the tolerances of chip_smoke.py's kernel checks
LAMBDA_RTOL, LAMBDA_ATOL, POS_ATOL, RHO_RTOL = 1e-4, 1e-8, 1e-5, 1e-5

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the launchers' constants, by kind: (name, float constants)
_LAUNCHERS = {"density_lambda": ("launch_density_lambda", 7),
              "project": ("launch_project", 5),
              "density_rho": ("launch_density_rho", 3)}
_V1_TILE = 128


class State(NamedTuple):
    label: str              # "<scene>:<step>"
    cfg: object
    n: int
    p4: torch.Tensor
    sorted_cid: torch.Tensor
    plan: object
    d4: torch.Tensor        # p4 with K1's lambda, K2's input
    candidates_mean: float  # per chunk
    candidates_max: int


def _state_inputs(spec: str, device) -> list[State]:
    """The states named in `spec` ("<scene>:<step>,..."), each scene
    rolled out once from its seed-0 spawn."""
    import pdb_sph_tpu_torch as pbf
    from pdb_sph_tpu_torch.core.step import sort_cells
    from pdb_sph_tpu_torch.ops import cuda_pbf, hashgrid

    wanted: dict[str, list[int]] = {}
    for item in spec.split(","):
        scene, step = item.split(":")
        wanted.setdefault(scene, []).append(int(step))
    out = []
    for scene, steps in wanted.items():
        kind, n, wall = SCENES[scene]
        config = pbf.blowup_config if kind == "blowup" else \
            pbf.default_config
        cfg = config(n=n, **({} if wall is None else {"wall": wall}))
        state, at = pbf.spawn(cfg, kind, seed=0, device=device), 0
        for step in sorted(steps):
            state = pbf.make_rollout(cfg, "window", step - at,
                                     device=device)(state)
            at = step
            sorted_cid, order = sort_cells(cfg,
                                           hashgrid.cell_ids(cfg, state.x))
            p4 = torch.zeros((sorted_cid.shape[0], 4), dtype=torch.float32,
                             device=device)
            p4[:n, :3] = state.x[order]
            plan = cuda_pbf.build_plan(cfg, sorted_cid)
            lens = (plan.ranges[..., 1] - plan.ranges[..., 0]).sum(dim=1)
            out.append(State(f"{scene}:{step}", cfg, n, p4, sorted_cid, plan,
                             cuda_pbf.density_pass(cfg, p4, plan, n),
                             float(lens.float().mean()), int(lens.max())))
    return out


def _abi(kl) -> int:
    fn = getattr(kl.lib, "pbf_window_abi", None)
    return 1 if fn is None else int(fn())


def _runner(kl, st: State, scratch, abi: int):
    """kind -> fn(src, plan, out) launching `kind` from library `kl` on
    state `st`'s sizes; `abi` is the tree's launcher interface, which the
    port's wrappers call."""
    from pdb_sph_tpu_torch.ops import cuda_pbf
    from pdb_sph_tpu_torch.utils import cuda_build

    cfg, n = st.cfg, st.n
    if _abi(kl) == abi:
        wrappers = {"density_lambda": cuda_pbf.density_pass,
                    "project": cuda_pbf.project_pass,
                    "density_rho": cuda_pbf.density_rho}

        def run(kind, src, plan, out):
            cuda_build.load_kernels = lambda: kl
            return wrappers[kind](cfg, src, plan, n, out, scratch)
        return run

    consts = {"density_lambda": cuda_pbf.density_consts(cfg),
              "project": cuda_pbf.project_consts(cfg),
              "density_rho": cuda_pbf.rho_consts(cfg)}
    stream = torch.cuda.current_stream().cuda_stream
    if _abi(kl) == 2:
        # the work table, no counter: (pin, pout, ranges, seg_prefix,
        # seg_len, partials, counters, n, chunks, own, constants...,
        # stream)
        for name, n_consts in _LAUNCHERS.values():
            getattr(kl.lib, name).argtypes = (_P,) * 7 + (_I,) * 3 + (
                _F,) * n_consts + (_P,)

        def run(kind, src, plan, out):
            name = _LAUNCHERS[kind][0]
            kl.check(getattr(kl.lib, name)(
                src.data_ptr(), out.data_ptr(), plan.ranges.data_ptr(),
                plan.seg_prefix.data_ptr(), plan.seg_len.data_ptr(),
                scratch.partials.data_ptr(), scratch.counters.data_ptr(), n,
                plan.ranges.shape[0], cfg.geom.own, *consts[kind], stream),
                name)
            return out
        return run

    # one block per chunk: (pin, pout, ranges, n, chunks, own, tile,
    # constants..., stream)
    for name, n_consts in _LAUNCHERS.values():
        getattr(kl.lib, name).argtypes = (_P, _P, _P, _I, _I, _I, _I,
                                          *[_F] * n_consts, _P)

    def run(kind, src, plan, out):
        name = _LAUNCHERS[kind][0]
        kl.check(getattr(kl.lib, name)(
            src.data_ptr(), out.data_ptr(), plan.ranges.data_ptr(), n,
            plan.ranges.shape[0], cfg.geom.own, _V1_TILE, *consts[kind],
            stream), name)
        return out
    return run


def _disagreement(kind: str, got: torch.Tensor, want: torch.Tensor, n: int):
    """(max |diff|, entries outside the kernel's tolerance)."""
    if kind == "project":
        err = (got[:n, :3] - want[:n, :3]).abs()
        return float(err.max()), int((err > POS_ATOL).sum())
    err = (got[:n, 3] - want[:n, 3]).abs()
    if kind == "density_lambda":
        tol = LAMBDA_ATOL + LAMBDA_RTOL * want[:n, 3].abs()
    else:
        tol = RHO_RTOL * want[:n, 3].abs()
    return float(err.max()), int((err > tol).sum())


def _sweep(device, states: list[State], segs, rounds) -> list[dict]:
    """The tree's kernels at each seg, forward then reversed."""
    from pdb_sph_tpu_torch.ops import cuda_pbf
    from pdb_sph_tpu_torch.utils.timing import cuda_ms

    rows = []
    for st in states:
        cfg, n, p4, sorted_cid, d4 = st.cfg, st.n, st.p4, st.sorted_cid, \
            st.d4
        times = {s: {k: [] for k in KINDS} for s in segs}
        plans, cfgs = {}, {}
        for seg in segs:
            c = dataclasses.replace(cfg, geom=dataclasses.replace(
                cfg.geom, seg=seg))
            c.geom.validate()
            cfgs[seg] = c
            plans[seg] = cuda_pbf.build_plan(c, sorted_cid)
        scratch = cuda_pbf.alloc_scratch(cfg, p4.shape[0], device)
        buf = torch.empty_like(p4)
        fns = {"density_lambda": (cuda_pbf.density_pass, p4),
               "project": (cuda_pbf.project_pass, d4),
               "density_rho": (cuda_pbf.density_rho, p4)}
        for _ in range(rounds):
            for g in segs + segs[::-1]:
                for kind, (fn, src) in fns.items():
                    times[g][kind].append(cuda_ms(
                        lambda: fn(cfgs[g], src, plans[g], n, buf, scratch),
                        REPS))
        for seg, v in times.items():
            row = {"state": st.label, "seg": seg,
                   "items": int(plans[seg].seg_prefix[-1])}
            row.update({f"{k}_median_ms": statistics.median(t)
                        for k, t in v.items()})
            rows.append(row)
            print(f"[sweep] {st.label} seg {seg} "
                  f"({row['items']} items): " + ", ".join(
                      f"{k} {row[f'{k}_median_ms']:.4f} ms" for k in KINDS))
    return rows


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, type=Path,
                    help="the other version of csrc/pbf_window.cu")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--states", default=STATES,
                    help="<scene>:<step>,... with scene 80k, 1m or "
                    "blowup1m")
    ap.add_argument("--segs", default="256,384,512,768,1024,1536,2048")
    ap.add_argument("--out", default="chiprun_out/kernel_ab.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from pdb_sph_tpu_torch.ops import cuda_pbf
    from pdb_sph_tpu_torch.utils import cuda_build
    from pdb_sph_tpu_torch.utils.timing import cuda_ms

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    ab_dir = ROOT / "build" / "kernel_ab"
    libs = {"tree": cuda_build.load_kernels(),
            "base": cuda_build.build_library([args.base.resolve()], ab_dir)}
    abi = {tag: _abi(kl) for tag, kl in libs.items()}
    for tag, kl in libs.items():
        print(f"[build] {tag}: {kl.path.name}, launcher interface "
              f"{abi[tag]}; ptxas: "
              + "; ".join(cuda_build.ptxas_registers(kl.log)))

    device = torch.device("cuda", 0)
    result = {"card": card, "abi": abi, "states": []}
    loader = cuda_build.load_kernels
    try:
        states = _state_inputs(args.states, device)
        for st in states:
            p4, plan, d4 = st.p4, st.plan, st.d4
            scratch = cuda_pbf.alloc_scratch(st.cfg, p4.shape[0], device)
            runs = {t: _runner(kl, st, scratch, abi["tree"])
                    for t, kl in libs.items()}
            src = {"density_lambda": p4, "project": d4, "density_rho": p4}
            times = {t: {k: [] for k in KINDS} for t in libs}
            buf = torch.empty_like(p4)
            for _ in range(args.rounds):
                for tag in ("base", "tree", "tree", "base"):
                    for kind in KINDS:
                        times[tag][kind].append(cuda_ms(
                            lambda: runs[tag](kind, src[kind], plan, buf),
                            REPS))
            row = {"state": st.label, "candidates_mean": st.candidates_mean,
                   "candidates_max": st.candidates_max,
                   "items": int(plan.seg_prefix[-1])}
            bad = []
            for kind in KINDS:
                outs = {t: runs[t](kind, src[kind], plan,
                                   torch.zeros_like(p4)) for t in libs}
                diff, outside = _disagreement(kind, outs["tree"],
                                              outs["base"], st.n)
                bitwise = torch.equal(outs["tree"], outs["base"])
                if outside:
                    bad.append(kind)
                row[f"{kind}_max_abs_diff"] = diff
                row[f"{kind}_bitwise"] = bitwise
                for tag in libs:
                    row[f"{kind}_{tag}_ms"] = times[tag][kind]
                    row[f"{kind}_{tag}_median_ms"] = statistics.median(
                        times[tag][kind])
                b, t = (row[f"{kind}_{x}_median_ms"] for x in ("base",
                                                              "tree"))
                print(f"[ab] {st.label} (candidates/chunk mean "
                      f"{st.candidates_mean:.1f} max {st.candidates_max}; "
                      f"{row['items']} items) {kind}: base "
                      f"{b:.4f} ms, tree {t:.4f} ms (tree/base {t / b:.4f}); "
                      f"outputs {'bitwise equal' if bitwise else 'not bitwise'}"
                      f" (max|diff| {diff:.3e}, {outside} outside the "
                      f"tolerance); base runs {times['base'][kind]}, tree runs "
                      f"{times['tree'][kind]}")
            result["states"].append(row)
            if bad:
                raise AssertionError(f"the two builds disagree at "
                                     f"{st.label}: {bad}")
        cuda_build.load_kernels = loader
        segs = [int(s) for s in args.segs.split(",") if s]
        result["sweep"] = _sweep(
            device, [st for st in states if st.label.startswith("80k:")],
            segs, max(1, args.rounds - 1)) if segs else []
    finally:
        cuda_build.load_kernels = loader
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
