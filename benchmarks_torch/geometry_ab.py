#!/usr/bin/env python3
"""A/B of the FP32 solve kernels against their tensor-core forms, and of
the tensor-core kernels against another version of csrc/pbf_tc.cu.

Run from the repository root on a machine with one CUDA card and nvcc:

    python3 benchmarks_torch/geometry_ab.py
    git show <commit>:pdb_sph_tpu_torch/csrc/pbf_tc.cu > build/ab/base_tc.cu
    python3 benchmarks_torch/geometry_ab.py --base-tc build/ab/base_tc.cu

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
tensor-core, tensor-core, default (host clock, fenced).

With `--base-tc`, first the six tensor-core forms of the base source
(built with the tree's pbf_window.cu into a library of its own) against
the tree's, in the order base, tree, tree, base, `--rounds` times, at
both steps; both outputs are held against the plain versions at
chip_smoke.py's tolerances. A base without `pbf_tc_abi` has the launcher
interface of one block per own-chunk (before the work items: threads and
a staging `tile` in the place of the work table) and is launched
directly; a base with it, a variant of the tree's source (a kernel
constant such as `kColGroups`), goes through the port's wrappers. Writes
chiprun_out/geometry_ab.json.
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
# the tolerances of chip_smoke.py's tensor-core checks
TC_LAMBDA_RTOL, TC_LAMBDA_ATOL, TC_POS_ATOL = 1e-4, 1e-6, 1e-5
# the one-block-per-chunk launchers: (pin, pout, ranges, n, chunks,
# threads, tile, switches, constants..., stream), one warp per 16 own rows
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_V1 = {"density": 7, "project": 5}
_V1_TILE = 128


def _tc_runner(kl, scratch):
    """fn(cfg, pass, src, plan, out) launching the pass's tensor-core form
    of `cfg` from library `kl`."""
    from pdb_sph_tpu_torch.ops import cuda_pbf
    from pdb_sph_tpu_torch.utils import cuda_build

    if getattr(kl.lib, "pbf_tc_abi", None) is not None:
        def run(c, name, src, plan, out):
            cuda_build.load_kernels = lambda: kl
            wrapper = getattr(cuda_pbf, f"{name}_pass")
            return wrapper(c, src, plan, N, out, scratch)
        return run

    for name, n_consts in _V1.items():
        getattr(kl.lib, f"launch_{name}_tc").argtypes = (
            _P, _P, _P, _I, _I, _I, _I, _I, _I, *[_F] * n_consts, _P)

    def run(c, name, src, plan, out):
        g = c.geom
        if name == "density":
            args = (g.mxu_rd2, g.mxu_sum, *cuda_pbf.density_consts(c))
        else:
            args = (g.mxu_proj, g.mxu_sum, *cuda_pbf.project_consts(c))
        fn = f"launch_{name}_tc"
        kl.check(getattr(kl.lib, fn)(
            src.data_ptr(), out.data_ptr(), plan.ranges.data_ptr(), N,
            plan.ranges.shape[0], g.own // 16 * 32, _V1_TILE,
            *map(int, args[:2]), *args[2:],
            torch.cuda.current_stream().cuda_stream), fn)
        return out
    return run


def _outside(name: str, got, want) -> tuple[float, int]:
    """(max |diff|, entries outside the tensor-core tolerance)."""
    if name == "density":
        err = (got[:N, 3] - want[:N, 3]).abs()
        tol = TC_LAMBDA_ATOL + TC_LAMBDA_RTOL * want[:N, 3].abs()
        return float(err.max()), int((err > tol).sum())
    err = (got[:N, :3] - want[:N, :3]).abs()
    return float(err.max()), int((err > TC_POS_ATOL).sum())


def _base_tc_ab(base: Path, states, geom_cfg, rounds: int) -> list[dict]:
    """The six tensor-core forms of `base` against the tree's, ABBA."""
    from pdb_sph_tpu_torch.ops import cuda_pbf
    from pdb_sph_tpu_torch.utils import cuda_build
    from pdb_sph_tpu_torch.utils.timing import cuda_ms

    libs = {"tree": cuda_build.load_kernels(),
            "base": cuda_build.build_library(
                [base.resolve(), cuda_build.CSRC / "pbf_window.cu"],
                ROOT.parent / "build" / "geometry_ab")}
    for tag, kl in libs.items():
        regs = [r for r in cuda_build.ptxas_registers(kl.log)
                if "_tc_kernel" in r]
        print(f"[base-tc] {tag}: {kl.path.name}, launcher interface "
              f"{2 if getattr(kl.lib, 'pbf_tc_abi', None) else 1}; ptxas: "
              + "; ".join(regs))
    loader = cuda_build.load_kernels
    rows = []
    try:
        for step, p4, _, plan, d4, mean_c, max_c in states:
            scratch = cuda_pbf.alloc_scratch(geom_cfg({}), p4.shape[0],
                                             p4.device)
            runs = {t: _tc_runner(kl, scratch) for t, kl in libs.items()}
            buf = torch.empty_like(p4)
            row = {"step": step, "candidates_mean": mean_c,
                   "candidates_max": max_c}
            bad = []
            for name, forms in FORMS.items():
                src = p4 if name == "density" else d4
                for form, switches in forms.items():
                    if not switches:
                        continue
                    c = geom_cfg(switches)
                    times = {"base": [], "tree": []}
                    for _ in range(rounds):
                        for tag in ("base", "tree", "tree", "base"):
                            times[tag].append(cuda_ms(
                                lambda: runs[tag](c, name, src, plan, buf),
                                REPS))
                    plain = getattr(cuda_pbf, f"{name}_pass_ref")(
                        c, src, plan, N)
                    outs = {t: runs[t](c, name, src, plan,
                                       torch.zeros_like(p4)) for t in libs}
                    checks = {t: _outside(name, o, plain)
                              for t, o in outs.items()}
                    equal = torch.equal(outs["base"], outs["tree"])
                    key = f"{name}_{form}"
                    med = {t: statistics.median(v) for t, v in times.items()}
                    row[key] = {"times_ms": times, "median_ms": med,
                                "bitwise_equal": equal,
                                "max_abs_err_vs_plain": {
                                    t: v[0] for t, v in checks.items()}}
                    if any(v[1] for v in checks.values()):
                        bad.append(key)
                    print(f"[base-tc] step {step} {key}: base "
                          f"{med['base']:.4f} ms, tree {med['tree']:.4f} ms "
                          f"(tree/base {med['tree'] / med['base']:.4f}); "
                          f"max|err| vs plain base "
                          f"{checks['base'][0]:.3e} ({checks['base'][1]} "
                          f"outside), tree {checks['tree'][0]:.3e} "
                          f"({checks['tree'][1]} outside); outputs "
                          f"{'bitwise equal' if equal else 'differ'}; "
                          f"base runs "
                          f"{times['base']}, tree runs {times['tree']}")
            rows.append(row)
            if bad:
                raise AssertionError(f"outside the tolerance at step {step}: "
                                     f"{bad}")
    finally:
        cuda_build.load_kernels = loader
    return rows


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
    ap.add_argument("--base-tc", type=Path,
                    help="another csrc/pbf_tc.cu to A/B the tensor-core "
                         "kernels against")
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
    states = _state_inputs(cfg, device, STATES)
    if args.base_tc is not None:
        result["base_tc"] = _base_tc_ab(args.base_tc, states, geom_cfg,
                                        args.rounds)
    for step, p4, _, plan, d4, mean_c, max_c in states:
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
