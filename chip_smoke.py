#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA card.

Run from the repository root, on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each printing its own line(s); any failure raises and the script
exits non-zero:

  1. device  — the card's name and power limit, torch / CUDA / nvcc versions;
  2. build   — the CUDA kernels built from csrc/ with nvcc;
  3. kernels — each kernel against its plain torch version on the same
               inputs, at the main path's shape, with errors, times, and
               each kernel's bound and share of it: the FP32 kernels
               (csrc/pbf_window.cu) and the six tensor-core instantiations
               (csrc/pbf_tc.cu) on the 80k dam break mid-collapse (step
               60) and settled (step 480, the heaviest own-chunks), each
               launched twice for bitwise-equal output, the scratch's
               counters back at 0;
  4. oracle  — 3 window-backend steps against the all-pairs dense backend;
  5. main    — the 80k dam break rolled out 240 steps after a 240-step
               settle chunk: steps/s, stats, launch counts, stage breakdown;
               then the same with every tensor-core switch on, and two
               short rollouts with {mxu_sum} and {mxu_rd2, mxu_proj}, so
               that each tensor-core instantiation runs on a path;
  6. settle  — the settle gate (core/settle.py): the 8k dam break run 2000
               steps must come to rest (mean dense rho within 5 % of rho0,
               max speed < 0.5, nothing escaped, stats [0, 0, 0], no NaN),
               in the default geometry and with every tensor-core switch
               on, each also with one work item a chunk (a witness whose
               sums differ from the geometry's only in their order);
  7. cli     — the runner (pdb_sph_tpu_torch.cli.main) in-process on the
               card: the 80k dam break with metrics, frames, a GIF and a
               checkpoint; a resume of it; the 80k blowup; and a short 80k
               dam break with PBF_MXU_SUM/RD2/PROJ=1 in the environment.

Every path (phases 5, 6 and 7's runs) is driven with the kernel launch
counts set to 0 just before it and read just after.

The line before the last is a JSON object with each kernel's launches
(`launches_from` names the phases they were counted in: the FP32 solve
kernels' from phase 5, the rho output's from phase 7's runs, the
all-switches tensor-core kernels' from phases 5-7, the four one-switch
instantiations' from phase 5's short rollouts), error and times at both
steps; the last line is {"ok": true, "device": {...}}. Without a card, or
without the package beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import torch

N_MAIN = 80_000        # the flagship dam break
SETTLE_STEPS = 60      # kernel-vs-plain inputs: mid-collapse state
SETTLED_STEP = 480     # and the settled state, with the heaviest chunks
N_ORACLE = 2048
ROLLOUT_STEPS = 240
# the one-switch geometries' rollouts: each runs its two instantiations
SHORT_STEPS = 40
REPS = 20
# kernel vs plain: sums run in another order, with FMA contraction
LAMBDA_RTOL, LAMBDA_ATOL = 1e-4, 1e-8
POS_ATOL = 1e-5
# rho is a sum of positive terms, each at least the self term: relative
RHO_RTOL = 1e-5
# tensor-core forms vs their plain versions: the products of the split dot
# are exact, but the mma sums them (not IEEE) where the plain version adds
# in order, so rd2 = (|o|^2 - 2 dot) + |c|^2 may differ by about an ulp of
# |p|^2 <= 12 (9.5e-7) on every pair, and lambda = -C / (l2 g2 + 600) by
# ~ poly6 / rho0 * 3 t^2 <= 74 times that per neighbour over >= 600: up
# to ~1e-7 per neighbour. The row sums' three-piece mma is exact in its
# products. A form that is another function than the FP32 one (rd2, proj)
# must also lie at least TC_SEPARATION times closer to its plain version
# than that plain version lies to the plain FP32 form.
TC_LAMBDA_RTOL, TC_LAMBDA_ATOL = 1e-4, 1e-6
TC_POS_ATOL = 1e-5
TC_SEPARATION = 10
TC_PLAIN_REPS = 3  # the plain tensor-core forms take ~0.5 s each
SETTLE_N, SETTLE_GATE_STEPS = 8192, 2000
# the settle gate's witness geometry: segments longer than any chunk's
# candidates, so one work item a chunk
WITNESS_SEG = 1 << 20
# the runner's runs: 80k dam break, its resume, the 80k blowup
CLI_STEPS, CLI_RESUME_STEPS, CLI_EVERY, CLI_RENDER = 240, 40, 20, 120
# window vs dense over 3 steps (tests/test_pallas.py:45-55)
ORACLE_RTOL, ORACLE_ATOL = 1e-4, 1e-5

# the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): FP32
# outside the tensor cores, dense bf16 on the tensor cores, HBM3
PEAK_FP32, PEAK_BF16_MMA, PEAK_BYTES = 67e12, 989e12, 3.35e12

CU_SOURCE = "pdb_sph_tpu_torch/csrc/pbf_window.cu"
TC_SOURCE = "pdb_sph_tpu_torch/csrc/pbf_tc.cu"
PALLAS = "pdb_sph_tpu/ops/pallas_pbf.py"
# wrapper counter -> (kernel name, source, the TPU kernel it replaces)
KERNELS = {
    "density_lambda": ("window_kernel<kLambda>", CU_SOURCE, f"{PALLAS}:424"),
    "project": ("window_kernel<kProject>", CU_SOURCE, f"{PALLAS}:477"),
    # K1's kernel with the rho output: the diagnostic density, which the JAX
    # package computes in plain XLA (no pallas_call) in diagnostics_fn
    "density_rho": ("window_kernel<kRho>", CU_SOURCE,
                    "pdb_sph_tpu/core/step.py:130"),
    "density_tc_rd2": ("density_tc_kernel<kRd2Mma>", TC_SOURCE,
                       f"{PALLAS}:445"),
    "density_tc_sum": ("density_tc_kernel<kSumMma>", TC_SOURCE,
                       f"{PALLAS}:318"),
    "density_tc_rd2_sum": ("density_tc_kernel<kRd2Mma, kSumMma>", TC_SOURCE,
                           f"{PALLAS}:445"),
    "project_tc_proj": ("project_tc_kernel<kProjMma>", TC_SOURCE,
                        f"{PALLAS}:525"),
    "project_tc_sum": ("project_tc_kernel<kSumMma>", TC_SOURCE,
                       f"{PALLAS}:318"),
    "project_tc_proj_sum": ("project_tc_kernel<kProjMma, kSumMma>",
                            TC_SOURCE, f"{PALLAS}:525"),
}
# flops per (own row, candidate) pair, an FMA counted as 2, read from the
# pair bodies, each as (on the CUDA cores in float32, on the tensor cores):
# first what every candidate costs, then what only a pair within h adds.
# The clamp of rd2 to h^2 zeroes every term of a pair beyond h, so the
# function needs no more of such a pair than its distance. FP32: deltas 3
# and rd2 5 for every pair; within h, lambda t 1, u 2, t2 u2 2, the two
# sums 5; rho t^3 and its sum 4; project u 2, u^2 1, lambda sum 1, s 1,
# three FMAs 6. The rd2 mma forms take rd2 as (|o|^2 - 2 dot) + |c|^2 (3
# flops on the CUDA cores in place of 8) and one m16n8k16 per 16 x 8 pairs
# (32 flops a pair); proj also splits s (1 flop) and takes delta-p in two
# more mmas per 16 x 16 pairs in place of three FMAs. The sum forms still
# add each term element-wise on the CUDA cores; their row-sum mma runs
# once per row.
PAIR_FLOPS = {
    "density_lambda": ((8, 0), (10, 0)), "density_rho": ((8, 0), (4, 0)),
    "project": ((8, 0), (11, 0)),
    "density_tc_rd2": ((3, 32), (10, 0)), "density_tc_sum": ((8, 0), (10, 0)),
    "density_tc_rd2_sum": ((3, 32), (10, 0)),
    "project_tc_proj": ((3, 32), (7, 32)), "project_tc_sum": ((8, 0), (11, 0)),
    "project_tc_proj_sum": ((3, 32), (7, 32)),
}
SOLVE_KERNELS = ("density_lambda", "project")
TC_SOLVE_KERNELS = ("density_tc_rd2_sum", "project_tc_proj_sum")
# wrapper counter of each tensor-core form -> the geometry's switches
TC_FORMS = {
    "density_tc_rd2": dict(mxu_rd2=True),
    "density_tc_sum": dict(mxu_sum=True),
    "density_tc_rd2_sum": dict(mxu_rd2=True, mxu_sum=True),
    "project_tc_proj": dict(mxu_proj=True),
    "project_tc_sum": dict(mxu_sum=True),
    "project_tc_proj_sum": dict(mxu_proj=True, mxu_sum=True),
}
ALL_SWITCHES = dict(mxu_sum=True, mxu_rd2=True, mxu_proj=True)
# phase 5's short rollouts, which run the four one-switch instantiations
ONE_SWITCH_GEOMS = (dict(mxu_sum=True), dict(mxu_rd2=True, mxu_proj=True))
MXU_ENV = ("PBF_MXU_SUM", "PBF_MXU_RD2", "PBF_MXU_PROJ")
CLI_TC_STEPS = 40


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card)
    from pdb_sph_tpu_torch.utils.cuda_build import find_nvcc

    nvcc = subprocess.run(
        [find_nvcc(), "--version"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[-1]
    print(f"[device] {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} | CUDA {torch.version.cuda} | nvcc {nvcc}")
    return card


def phase_build() -> None:
    from pdb_sph_tpu_torch.utils.cuda_build import (load_kernels,
                                                    ptxas_registers)

    t0 = time.perf_counter()
    kl = load_kernels()
    total = time.perf_counter() - t0
    print(f"[build] ok {kl.path.name} nvcc {kl.build_seconds:.2f} s "
          f"(load total {total:.2f} s); ptxas (template arguments: pass or "
          f"switches, rows per lane or own): "
          + "; ".join(ptxas_registers(kl.log)))


def _sorted_p4(cfg, x: torch.Tensor):
    """Cell-sort positions and build the plan, as the step does."""
    from pdb_sph_tpu_torch.core.step import sort_cells
    from pdb_sph_tpu_torch.ops import cuda_pbf, hashgrid

    n = x.shape[0]
    sorted_cid, order = sort_cells(cfg, hashgrid.cell_ids(cfg, x))
    p4 = torch.zeros((sorted_cid.shape[0], 4), dtype=torch.float32,
                     device=x.device)
    p4[:n, :3] = x[order]
    return p4, cuda_pbf.build_plan(cfg, sorted_cid)


def _candidates(plan) -> tuple[float, int]:
    """(mean, max) candidates per own-chunk of a plan."""
    lens = (plan.ranges[..., 1] - plan.ranges[..., 0]).sum(dim=1)
    return float(lens.float().mean()), int(lens.max())


def _near_pairs(cfg, p4, plan, n: int) -> int:
    """The (real own row, candidate) pairs of this plan that lie within h:
    those whose terms the clamp does not zero."""
    from pdb_sph_tpu_torch.ops import cuda_pbf

    h2 = torch.tensor(float(cfg.h2), dtype=torch.float32, device=p4.device)
    near = 0
    for row0, mine, _, rd2, mask, _ in cuda_pbf._pair_blocks(cfg, p4, plan,
                                                             n):
        rows = row0 + torch.arange(mine.shape[0] * mine.shape[1],
                                   device=p4.device).view(mine.shape[:2])
        near += int(((rd2 < h2) & mask & (rows < n)[..., None]).sum())
    return near


def _bound(name: str, plan, n: int, own: int,
           near: int) -> tuple[float, str, int]:
    """(bound ms, "operations" or "bytes", pairs) of one launch of kernel
    `name` on this plan: the least time the card could take, the larger of
    the pair flops over the published peak of their type and the bytes
    (positions read once, the n rows written once, the plan read once)
    over the memory rate. Pairs are those this data needs: each real own
    row against its chunk's candidates, each costing its distance, and of
    them the `near` pairs within h the rest of the pair body."""
    lens = (plan.ranges[..., 1] - plan.ranges[..., 0]).sum(dim=1).double()
    rows = (n - own * torch.arange(lens.numel(), device=lens.device,
                                   dtype=torch.float64)).clamp(0, own)
    pairs = int((rows * lens).sum())
    (fp32, mma), (fp32_near, mma_near) = PAIR_FLOPS[name]
    ops_s = max((pairs * fp32 + near * fp32_near) / PEAK_FP32,
                (pairs * mma + near * mma_near) / PEAK_BF16_MMA)
    plan_bytes = sum(t.numel() * t.element_size() for t in (
        plan.ranges, plan.seg_prefix, plan.seg_len))
    bytes_s = (16 * own * lens.numel() + 16 * n + plan_bytes) / PEAK_BYTES
    return (1e3 * max(ops_s, bytes_s),
            "operations" if ops_s >= bytes_s else "bytes", pairs)


def _fp32_kernels(cfg, p4, plan, n: int, step: int,
                  plain_reps: int) -> tuple[dict, torch.Tensor]:
    """K1 lambda, K2 and K1 rho against their plain versions on one state:
    errors within the tolerances, two launches bitwise equal, times beside
    their bounds. Returns ({counter: (max|err|, ms, plain ms or None,
    bound ms, bound by)}, K1's output)."""
    from pdb_sph_tpu_torch.ops import cuda_pbf
    from pdb_sph_tpu_torch.utils.timing import cuda_ms

    scratch = cuda_pbf.alloc_scratch(cfg, p4.shape[0], p4.device)
    d_k = cuda_pbf.density_pass(cfg, p4, plan, n, scratch=scratch)
    d_r = cuda_pbf.density_pass_ref(cfg, p4, plan, n)
    lam_k, lam_r = d_k[:n, 3], d_r[:n, 3]
    lam_err = (lam_k - lam_r).abs()
    lam_bad = int((lam_err > LAMBDA_ATOL + LAMBDA_RTOL * lam_r.abs()).sum())
    lam_rel = float((lam_err / lam_r.abs().clamp_min(1e-12)).max())
    if not torch.equal(d_k[:n, :3], p4[:n, :3]):
        raise AssertionError("density kernel changed the positions it carries")

    # both project versions take the kernel's density output
    p_k = cuda_pbf.project_pass(cfg, d_k, plan, n, scratch=scratch)
    p_r = cuda_pbf.project_pass_ref(cfg, d_k, plan, n)
    pos_err = (p_k[:n, :3] - p_r[:n, :3]).abs()
    pos_max = float(pos_err.max())
    move = float((p_r[:n, :3] - d_k[:n, :3]).abs().max())

    # the diagnostic rho, through K1's kernel with the rho output
    r_k = cuda_pbf.density_rho(cfg, p4, plan, n, scratch=scratch)
    r_r = cuda_pbf.density_rho_ref(cfg, p4, plan, n)
    rho_err = (r_k[:n, 3] - r_r[:n, 3]).abs()
    rho_bad = int((rho_err > RHO_RTOL * r_r[:n, 3].abs()).sum())
    rho_rel = float((rho_err / r_r[:n, 3].abs()).max())
    if not torch.equal(r_k[:n, :3], p4[:n, :3]):
        raise AssertionError("rho kernel changed the positions it carries")

    # a second launch of each gives the same bits: the combine is fixed
    again = {
        "density_lambda": (cuda_pbf.density_pass(cfg, p4, plan, n,
                                                 scratch=scratch), d_k),
        "project": (cuda_pbf.project_pass(cfg, d_k, plan, n,
                                          scratch=scratch), p_k),
        "density_rho": (cuda_pbf.density_rho(cfg, p4, plan, n,
                                             scratch=scratch), r_k),
    }
    unequal = [k for k, (a, b) in again.items() if not torch.equal(a, b)]
    if scratch.counters.any():
        raise AssertionError("a kernel left its counters nonzero")

    buf = torch.empty_like(p4)
    runs = {
        "density_lambda": (
            lambda: cuda_pbf.density_pass(cfg, p4, plan, n, buf, scratch),
            lambda: cuda_pbf.density_pass_ref(cfg, p4, plan, n, buf)),
        "project": (
            lambda: cuda_pbf.project_pass(cfg, d_k, plan, n, buf, scratch),
            lambda: cuda_pbf.project_pass_ref(cfg, d_k, plan, n, buf)),
        "density_rho": (
            lambda: cuda_pbf.density_rho(cfg, p4, plan, n, buf, scratch),
            lambda: cuda_pbf.density_rho_ref(cfg, p4, plan, n, buf)),
    }
    errs = {"density_lambda": float(lam_err.max()), "project": pos_max,
            "density_rho": float(rho_err.max())}
    mean_c, max_c = _candidates(plan)
    items = int(plan.seg_prefix[-1])
    near = _near_pairs(cfg, p4, plan, n)
    pairs = _bound("density_lambda", plan, n, cfg.geom.own, near)[2]
    print(f"[kernels] n={n} after {step} steps; candidates/chunk "
          f"mean {mean_c:.1f} max {max_c}; {pairs} pairs, {near} within h "
          f"({100 * near / pairs:.2f} %); {items} work items of <= "
          f"{int(plan.seg_len)} candidates; "
          f"lambda max|err| {float(lam_err.max()):.3e} max rel "
          f"{lam_rel:.3e} (tol {LAMBDA_ATOL:g} + {LAMBDA_RTOL:g}|ref|, "
          f"{lam_bad} outside); positions max|err| {pos_max:.3e} (atol "
          f"{POS_ATOL:g}; largest move {move:.3e}); rho max|err| "
          f"{float(rho_err.max()):.3e} max rel {rho_rel:.3e} (rtol "
          f"{RHO_RTOL:g}, {rho_bad} outside); two launches bitwise equal: "
          f"{'all' if not unequal else 'not ' + ', '.join(unequal)}")
    out = {}
    for name, (kernel, plain) in runs.items():
        k_ms = cuda_ms(kernel, REPS)
        r_ms = cuda_ms(plain, plain_reps) if plain_reps else None
        bound_ms, bound_by, _ = _bound(name, plan, n, cfg.geom.own, near)
        plain_txt = (f"plain {r_ms:.4f} ms (median of {plain_reps})"
                     if r_ms is not None else "plain not timed here")
        every, within = (f[0] for f in PAIR_FLOPS[name])
        print(f"[kernels] {KERNELS[name][0]} at step {step}: kernel "
              f"{k_ms:.4f} ms (median of {REPS}, CUDA events), {plain_txt}; "
              f"bound {bound_ms:.4f} ms by {bound_by} ({pairs} pairs x "
              f"{every} + {near} x {within} flops at "
              f"{PEAK_FP32 / 1e12:g} TFLOP/s), "
              f"{100 * bound_ms / k_ms:.1f} % of bound")
        out[name] = (errs[name], k_ms, r_ms, bound_ms, bound_by)
    if lam_bad or not pos_max <= POS_ATOL or rho_bad:
        raise AssertionError(f"a kernel disagrees with its plain version at "
                             f"step {step}")
    if unequal:
        raise AssertionError(f"two launches differ at step {step}: {unequal}")
    return out, d_k


def phase_kernels(device, n: int = N_MAIN) -> dict:
    """Each kernel against its plain version on the dam break at steps 60
    and 480. Returns {counter: (max|err|, ms, plain ms, bound ms, bound by,
    ms at step 480, bound ms at step 480)}."""
    import pdb_sph_tpu_torch as pbf

    cfg = pbf.default_config(n=n)
    g = cfg.geom
    print(f"[kernels] tensor-core layout at own {g.own}: "
          f"{g.tc_m_tiles} m16 tile(s) a warp, {g.tc_col_groups} warp(s) "
          f"splitting each stage's candidates, {g.tc_smem_bytes} bytes of "
          f"shared memory (kProjMma)")
    state = pbf.spawn(cfg, "dam_break", seed=0, device=device)
    state = pbf.make_rollout(cfg, "window", SETTLE_STEPS, device=device)(state)
    p4, plan = _sorted_p4(cfg, state.x)
    mid, d_k = _fp32_kernels(cfg, p4, plan, n, SETTLE_STEPS, REPS)
    mid.update(_tc_kernels(cfg, p4, d_k, plan, n, SETTLE_STEPS,
                           TC_PLAIN_REPS))
    state = pbf.make_rollout(cfg, "window", SETTLED_STEP - SETTLE_STEPS,
                             device=device)(state)
    p4, plan = _sorted_p4(cfg, state.x)
    settled, d_k = _fp32_kernels(cfg, p4, plan, n, SETTLED_STEP, 0)
    settled.update(_tc_kernels(cfg, p4, d_k, plan, n, SETTLED_STEP, 0))
    return {k: (max(v[0], settled[k][0]), *v[1:], settled[k][1],
                settled[k][3]) for k, v in mid.items()}


def _tc_kernels(cfg, p4, d_fp, plan, n: int, step: int,
                plain_reps: int) -> dict:
    """The six tensor-core instantiations against their plain versions on
    one state; the project forms take the FP32 kernel's lambda, as the FP32
    project kernel does. Each launched twice for bitwise-equal output, the
    scratch's counters back at 0 after. Returns {counter: (max|err|, ms,
    plain ms or None, bound ms, bound by)}."""
    import dataclasses

    from pdb_sph_tpu_torch.ops import cuda_pbf
    from pdb_sph_tpu_torch.utils.timing import cuda_ms

    fp32 = {"density": cuda_pbf.density_pass_ref(cfg, p4, plan, n)[:n, 3],
            "project": cuda_pbf.project_pass_ref(cfg, d_fp, plan, n)[:n, :3]}
    near = _near_pairs(cfg, p4, plan, n)
    scratch = cuda_pbf.alloc_scratch(cfg, p4.shape[0], p4.device)
    buf = torch.empty_like(p4)
    out, bad = {}, []
    for name, switches in TC_FORMS.items():
        tcfg = dataclasses.replace(
            cfg, geom=dataclasses.replace(cfg.geom, **switches))
        density = name.startswith("density")
        src = p4 if density else d_fp
        wrapper = cuda_pbf.density_pass if density else cuda_pbf.project_pass
        plain = (cuda_pbf.density_pass_ref if density
                 else cuda_pbf.project_pass_ref)
        cuda_pbf.reset_launches()
        got = wrapper(tcfg, src, plan, n, scratch=scratch)
        again = wrapper(tcfg, src, plan, n, scratch=scratch)
        torch.cuda.synchronize()
        launches = cuda_pbf.LAUNCHES[name]
        equal = torch.equal(got, again)
        counters = int(scratch.counters.abs().sum())
        want = plain(tcfg, src, plan, n)
        cols = slice(3, 4) if density else slice(0, 3)
        kept = slice(0, 3) if density else slice(3, 4)
        if not torch.equal(got[:n, kept], src[:n, kept]):
            raise AssertionError(f"{name} changed the columns it carries")
        g, w = got[:n, cols], want[:n, cols]
        err = (g - w).abs()
        form = float((w.squeeze(-1) - fp32["density" if density
                                           else "project"]).abs().max())
        if density:
            n_bad = int((err > TC_LAMBDA_ATOL
                         + TC_LAMBDA_RTOL * w.abs()).sum())
            tol = f"{TC_LAMBDA_ATOL:g} + {TC_LAMBDA_RTOL:g}|ref|"
        else:
            n_bad = int((err > TC_POS_ATOL).sum())
            tol = f"atol {TC_POS_ATOL:g}"
        k_ms = cuda_ms(lambda: wrapper(tcfg, src, plan, n, buf, scratch),
                       REPS)
        r_ms = (cuda_ms(lambda: plain(tcfg, src, plan, n, buf), plain_reps)
                if plain_reps else None)
        bound_ms, bound_by, _ = _bound(name, plan, n, cfg.geom.own, near)
        plain_txt = (f"plain {r_ms:.4f} ms (median of {plain_reps})"
                     if r_ms is not None else "plain not timed here")
        print(f"[kernels] {KERNELS[name][0]} at step {step}: max|err| "
              f"{float(err.max()):.3e} vs plain (tol {tol}, {n_bad} "
              f"outside); plain form vs plain FP32 form max|diff| "
              f"{form:.3e}; kernel {k_ms:.4f} ms (median of {REPS}, CUDA "
              f"events), {plain_txt}; bound {bound_ms:.4f} ms by "
              f"{bound_by}, {100 * bound_ms / k_ms:.1f} % of bound; "
              f"checked launches {launches}, two launches bitwise equal "
              f"{equal}, counters after {counters}")
        other = switches.get("mxu_rd2") or switches.get("mxu_proj")
        if n_bad or launches != 2 or not equal or counters \
                or (other and TC_SEPARATION * float(err.max()) > form):
            bad.append(name)
        out[name] = (float(err.max()), k_ms, r_ms, bound_ms, bound_by)
    if bad:
        raise AssertionError(f"tensor-core kernels disagree with their plain "
                             f"versions, differ between two launches, left "
                             f"counters nonzero or did not launch at step "
                             f"{step}: {bad}")
    return out


def _unsorted_x(state) -> torch.Tensor:
    return state.x[torch.argsort(state.ids.long())]


def phase_oracle(device, n: int = N_ORACLE) -> None:
    import pdb_sph_tpu_torch as pbf

    cfg = pbf.default_config(n=n)
    st = pbf.spawn(cfg, "standard", seed=1, device=device)
    win = pbf.make_rollout(cfg, "window", 3, device=device)(st)
    den = pbf.make_rollout(cfg, "dense", 3, device=device)(st)
    xw, xd = _unsorted_x(win), den.x
    err = float((xw - xd).abs().max())
    print(f"[oracle] n={n} standard, 3 steps window vs dense: max|dx| "
          f"{err:.3e} (rtol {ORACLE_RTOL:g}, atol {ORACLE_ATOL:g})")
    torch.testing.assert_close(xw, xd, rtol=ORACLE_RTOL, atol=ORACLE_ATOL)


def _stage_breakdown(stepper, state, steps: int = REPS) -> dict:
    """Median ms of each stage of one step, from CUDA events recorded
    between the stages; repeated stages (the passes) are summed."""
    per_step = []
    for _ in range(steps):
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


def phase_main(device, card: str, geom=None, n: int = N_MAIN,
               steps: int = ROLLOUT_STEPS) -> dict:
    """The rollout in `geom` (None: the default geometry); its launches."""
    import pdb_sph_tpu_torch as pbf
    from pdb_sph_tpu_torch.ops import cuda_pbf
    from pdb_sph_tpu_torch.utils.timing import fence

    cfg = pbf.default_config(n=n, **({} if geom is None else {"geom": geom}))
    expect, idle = _solve_kernels(cfg.geom)
    rollout = pbf.make_rollout(cfg, "window", steps, with_stats=True,
                               device=device)
    scratch = rollout.stepper.scratch
    ptrs = [t.data_ptr() for t in scratch]
    state = pbf.spawn(cfg, "dam_break", seed=0, device=device)
    t0 = time.perf_counter()
    state, settle_stats = rollout(state)
    fence(device)
    settle_s = time.perf_counter() - t0

    cuda_pbf.reset_launches()
    fence(device)
    t0 = time.perf_counter()
    state, stats = rollout(state)
    fence(device)
    secs = time.perf_counter() - t0
    launches = dict(cuda_pbf.LAUNCHES)

    x, v = state.x, state.v
    finite = bool(torch.isfinite(x).all() and torch.isfinite(v).all())
    escaped = int(((x < 0) | (x > cfg.wall)).any(dim=1).sum())
    print(f"[main] dam_break n={n} {_geom_name(cfg.geom)}: {steps} steps in "
          f"{secs:.4f} s = "
          f"{steps / secs:.2f} steps/s = {n * steps / secs:.1f} "
          f"particle-steps/s on {card} (settle chunk {settle_s:.2f} s); "
          f"stats {stats.tolist()} (settle {settle_stats.tolist()}); "
          f"finite {finite}; escaped {escaped}; launches {launches}")
    want = cfg.solver_iters * steps
    if not finite or escaped or stats.tolist() != [0, 0, 0] \
            or settle_stats.tolist() != [0, 0, 0]:
        raise AssertionError("main path state or stats are wrong")
    if any(launches[k] != want for k in expect) \
            or any(launches[k] for k in idle):
        raise AssertionError(f"expected {want} launches of each of {expect} "
                             f"and none of {idle}, got {launches}")

    if rollout.stepper.scratch is not scratch \
            or [t.data_ptr() for t in scratch] != ptrs \
            or scratch.counters.any():
        raise AssertionError("the rollout replaced the Stepper's scratch or "
                             "left its counters nonzero")

    stages = _stage_breakdown(rollout.stepper, state)
    total = sum(stages.values())
    print(f"[main] {_geom_name(cfg.geom)} step breakdown (median of "
          f"{REPS} steps, CUDA events, ms): "
          + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
          + f"; sum {total:.4f}")
    return launches


def _geom_name(geom) -> str:
    from pdb_sph_tpu_torch.geometry import KernelGeometry

    on = [k for k in ALL_SWITCHES if getattr(geom, k)]
    if geom.seg != KernelGeometry.seg:
        on.append(f"seg={geom.seg}")
    return "+".join(on) if on else "default geometry"


def _solve_kernels(geom) -> tuple[tuple, tuple]:
    """(the two solve kernels `geom` launches, the other solve kernels,
    which it must not launch)."""
    density = ("density_tc" + "_rd2" * geom.mxu_rd2 + "_sum" * geom.mxu_sum
               if geom.mxu_rd2 or geom.mxu_sum else "density_lambda")
    project = ("project_tc" + "_proj" * geom.mxu_proj
               + "_sum" * geom.mxu_sum
               if geom.mxu_proj or geom.mxu_sum else "project")
    expect = (density, project)
    return expect, tuple(k for k in (*SOLVE_KERNELS, *TC_FORMS)
                         if k not in expect)


def phase_settle(device, geom=None) -> dict:
    """The settle gate on the card: the precision check of the kernels, in
    `geom` (None: the default geometry). Returns its launches."""
    from pdb_sph_tpu_torch.core import settle
    from pdb_sph_tpu_torch.geometry import KernelGeometry
    from pdb_sph_tpu_torch.ops import cuda_pbf

    expect, idle = _solve_kernels(geom or KernelGeometry())
    cuda_pbf.reset_launches()
    r = settle.settle_check(device, n=SETTLE_N, steps=SETTLE_GATE_STEPS,
                            geom=geom)
    launches = dict(cuda_pbf.LAUNCHES)
    name = _geom_name(geom or KernelGeometry())
    for line in settle.format_result(r).splitlines():
        print(f"[settle] {name}: {line}")
    print(f"[settle] {name}: {SETTLE_GATE_STEPS / r['seconds']:.2f} steps/s; "
          f"launches {launches}")
    want = 3 * SETTLE_GATE_STEPS
    if any(launches[k] != want for k in expect) \
            or any(launches[k] for k in idle):
        raise AssertionError(f"expected {want} launches of each of {expect} "
                             f"and none of {idle}, got {launches}")
    if not r["ok"]:
        raise AssertionError(f"SETTLE CHECK ({name}): FAIL")
    return launches


def _cli_run(argv: list[str], metrics: str,
             expect=(*SOLVE_KERNELS, "density_rho")
             ) -> tuple[list[dict], dict]:
    """One in-process run of the runner; (its JSONL records, the kernel
    launches it made). Raises unless it exits 0 and launched every kernel
    of `expect`."""
    from pdb_sph_tpu_torch import cli
    from pdb_sph_tpu_torch.ops import cuda_pbf

    cuda_pbf.reset_launches()
    rc = cli.main(argv + ["--device", "cuda", "--metrics", metrics])
    launches = dict(cuda_pbf.LAUNCHES)
    if rc != 0:
        raise AssertionError(f"cli exited {rc}: {argv}")
    with open(metrics) as f:
        records = [json.loads(line) for line in f]
    if records[-1]["event"] != "done":
        raise AssertionError(f"cli run did not finish: {records[-1]}")
    prog = [r for r in records if r["event"] == "progress"]
    if any(r["nan_detected"] or r["n_overflow"] or r["plan_overflow"]
           for r in prog):
        raise AssertionError("cli run reported NaN or overflow")
    if any(r.get("n_escaped", 0) for r in prog):
        raise AssertionError("cli run lost particles from the box")
    diag = [r for r in prog if "mean_density" in r]
    last = diag[-1] if diag else {}
    chunk_rate = statistics.median(r["steps_per_sec"] for r in prog)
    print(f"[cli] {' '.join(argv)}: rc 0, last step {prog[-1]['step']}, "
          f"{records[-1]['particle_steps_per_sec']:.1f} particle-steps/s "
          f"({records[-1]['steps_per_sec']:.2f} steps/s, "
          f"{records[-1]['wall_seconds']:.3f} s, frames and GIF included; "
          f"median chunk {chunk_rate:.2f} steps/s); {len(diag)} diagnostic "
          f"records (last: mean rho {last.get('mean_density', 0):.1f}, max "
          f"err {last.get('max_density_err', 0):.4f}, maxv "
          f"{last.get('max_speed', 0):.4f}); launches {launches}")
    for k in expect:
        if not launches[k]:
            raise AssertionError(f"{k} was not launched in {argv}")
    return records, launches


def phase_cli(device, out_dir: str) -> tuple[int, dict]:
    """The runner on the card; returns the rho kernel's launches and those
    of the run with the tensor-core switches in the environment."""
    import pdb_sph_tpu_torch as pbf
    from pdb_sph_tpu_torch.core.step import diagnostics_fn
    from pdb_sph_tpu_torch.io import checkpoint
    from pdb_sph_tpu_torch.utils.timing import fence

    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    ck, fr = os.path.join(out_dir, "dam.npz"), os.path.join(out_dir, "fr")
    gif = os.path.join(out_dir, "dam.gif")
    every = ["--metrics-every", str(CLI_EVERY)]
    dam, l_dam = _cli_run(
        ["--scene", "dam_break", "--n", str(N_MAIN), "--steps",
         str(CLI_STEPS), "--chunk", str(CLI_EVERY), *every,
         "--render-every", str(CLI_RENDER), "--width", "320", "--height",
         "240", "--out", fr, "--gif", gif, "--checkpoint", ck],
        os.path.join(out_dir, "dam.jsonl"))
    n_diag = sum("mean_density" in r for r in dam)
    pngs = sorted(os.listdir(fr))
    want_png = [f"frame_{s:06d}.png" for s in range(0, CLI_STEPS + 1,
                                                     CLI_RENDER)]
    if n_diag != CLI_STEPS // CLI_EVERY or l_dam["density_rho"] != n_diag:
        raise AssertionError(f"{n_diag} diagnostic records, "
                             f"{l_dam['density_rho']} rho launches")
    if pngs != want_png or not os.path.getsize(gif):
        raise AssertionError(f"frames {pngs}, gif {gif}")

    resumed, l_res = _cli_run(
        ["--resume", ck, "--steps", str(CLI_RESUME_STEPS), *every],
        os.path.join(out_dir, "resume.jsonl"))
    if resumed[-2]["step"] != CLI_STEPS + CLI_RESUME_STEPS:
        raise AssertionError(f"resume ended at step {resumed[-2]['step']}")

    bl_ck = os.path.join(out_dir, "blowup.npz")
    _, l_bl = _cli_run(
        ["--scene", "blowup", "--n", str(N_MAIN), "--steps", str(CLI_STEPS),
         *every, "--checkpoint", bl_ck],
        os.path.join(out_dir, "blowup.jsonl"))
    cfg0 = pbf.blowup_config(n=N_MAIN)
    spawned = _candidates(_sorted_p4(
        cfg0, pbf.spawn(cfg0, "blowup", seed=0, device=device).x)[1])
    cfg, state = checkpoint.load(bl_ck, device)
    final = _candidates(_sorted_p4(cfg, state.x)[1])
    print(f"[cli] blowup n={N_MAIN}: candidates/chunk at spawn mean "
          f"{spawned[0]:.1f} max {spawned[1]}; at step "
          f"{int(state.step)} mean {final[0]:.1f} max {final[1]}")

    # what one diagnostic record costs the runner: diagnostics_fn and the
    # four host reads, on the settled 80k dam of the first run
    cfg, state = checkpoint.load(ck, device)
    secs = []
    for _ in range(REPS + 2):
        fence(device)
        t0 = time.perf_counter()
        d = diagnostics_fn(cfg, state)
        _ = (float(d.mean_density), float(d.max_density_err),
             float(d.max_speed), int(d.n_escaped))
        secs.append(time.perf_counter() - t0)
    print(f"[cli] one diagnostic record at n={cfg.n}: "
          f"{1e3 * statistics.median(secs[2:]):.4f} ms (median of {REPS}, "
          "host clock, reads included)")

    # the tensor-core forms through the environment, as a user sets them
    tc_ck = os.path.join(out_dir, "dam_tc.npz")
    saved = {k: os.environ.get(k) for k in MXU_ENV}
    os.environ.update({k: "1" for k in MXU_ENV})
    try:
        _, l_tc = _cli_run(
            ["--scene", "dam_break", "--n", str(N_MAIN), "--steps",
             str(CLI_TC_STEPS), *every, "--checkpoint", tc_ck],
            os.path.join(out_dir, "dam_tc.jsonl"),
            expect=(*TC_SOLVE_KERNELS, "density_rho"))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if any(l_tc[k] for k in SOLVE_KERNELS):
        raise AssertionError(f"the PBF_MXU_* run launched FP32 solve "
                             f"kernels: {l_tc}")
    cfg, _ = checkpoint.load(tc_ck, device)
    print(f"[cli] PBF_MXU_SUM/RD2/PROJ=1: checkpoint geometry {cfg.geom}")
    if not all(getattr(cfg.geom, k) for k in ALL_SWITCHES):
        raise AssertionError(f"checkpoint lost the switches: {cfg.geom}")
    rho = l_dam["density_rho"] + l_res["density_rho"] + l_bl["density_rho"]
    return rho + l_tc["density_rho"], l_tc


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import pdb_sph_tpu_torch  # noqa: F401  (fails before any output if absent)

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from pdb_sph_tpu_torch.geometry import KernelGeometry

    tc_geom = KernelGeometry(**ALL_SWITCHES)
    card = phase_device()
    phase_build()
    kern = phase_kernels(device)
    phase_oracle(device)
    launches = phase_main(device, card)
    tc_main = phase_main(device, card, geom=tc_geom)
    short = {}
    for switches in ONE_SWITCH_GEOMS:
        got = phase_main(device, card, KernelGeometry(**switches),
                         steps=SHORT_STEPS)
        short.update({k: v for k, v in got.items() if k in TC_FORMS and v})
    phase_settle(device)
    tc_settle = phase_settle(device, geom=tc_geom)
    phase_settle(device, geom=KernelGeometry(seg=WITNESS_SEG))
    phase_settle(device, geom=KernelGeometry(**ALL_SWITCHES, seg=WITNESS_SEG))
    rho, tc_cli = phase_cli(
        device, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "chip_smoke_cli"))

    origin = {k: "phase 5" for k in SOLVE_KERNELS}
    launches["density_rho"], origin["density_rho"] = rho, "phase 7"
    for k in TC_SOLVE_KERNELS:
        launches[k] = tc_main[k] + tc_settle[k] + tc_cli[k]
        origin[k] = "phases 5-7"
    for k in set(TC_FORMS) - set(TC_SOLVE_KERNELS):
        launches[k] = short[k]
        origin[k] = f"phase 5 ({SHORT_STEPS}-step rollout)"
    # no single PyTorch call computes a windowed neighbour sum, so no
    # kernel has a library time
    report = [
        {"name": KERNELS[k][0], "route": "cuda", "source": KERNELS[k][1],
         "replaces": KERNELS[k][2], "launches": launches[k],
         "launches_from": origin[k], "max_abs_err": kern[k][0],
         "ms": kern[k][1], "plain_ms": kern[k][2], "bound_ms": kern[k][3],
         "bound_by": kern[k][4], "library_ms": None,
         f"ms_step{SETTLED_STEP}": kern[k][5],
         f"bound_ms_step{SETTLED_STEP}": kern[k][6]}
        for k in KERNELS
    ]
    if any(r["launches"] <= 0 for r in report):
        raise AssertionError(f"a kernel was not launched: {report}")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
