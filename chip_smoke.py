#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA card.

Run from the repository root, on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each printing its own line(s); any failure raises and the script
exits non-zero:

  1. device  — the card's name and power limit, torch / CUDA / nvcc versions;
  2. build   — the CUDA kernels built from csrc/ with nvcc;
  3. kernels — each kernel against its plain torch version on the same
               inputs, at the main path's shape (80k dam break, mid-collapse),
               with errors and times;
  4. oracle  — 3 window-backend steps against the all-pairs dense backend;
  5. main    — the 80k dam break rolled out 240 steps after a 240-step
               settle chunk: steps/s, stats, launch counts, stage breakdown.

The line before the last is a JSON object with each kernel's launches,
error and times; the last line is {"ok": true, "device": {...}}. Without a
card, or without the package beside it, the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch

N_MAIN = 80_000        # the flagship dam break
SETTLE_STEPS = 60      # kernel-vs-plain inputs: mid-collapse state
N_ORACLE = 2048
ROLLOUT_STEPS = 240
REPS = 20
# kernel vs plain: sums run in another order, with FMA contraction
LAMBDA_RTOL, LAMBDA_ATOL = 1e-4, 1e-8
POS_ATOL = 1e-5
# window vs dense over 3 steps (tests/test_pallas.py:45-55)
ORACLE_RTOL, ORACLE_ATOL = 1e-4, 1e-5

CU_SOURCE = "pdb_sph_tpu_torch/csrc/pbf_window.cu"
KERNELS = {  # wrapper counter -> (kernel name, the TPU kernel it replaces)
    "density_lambda": ("density_lambda_kernel",
                       "pdb_sph_tpu/ops/pallas_pbf.py:424"),
    "project": ("project_kernel", "pdb_sph_tpu/ops/pallas_pbf.py:477"),
}


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
    from pdb_sph_tpu_torch.utils.cuda_build import load_kernels

    t0 = time.perf_counter()
    kl = load_kernels()
    total = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in kl.log.splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    print(f"[build] ok {kl.path.name} nvcc {kl.build_seconds:.2f} s "
          f"(load total {total:.2f} s); ptxas: {' | '.join(ptxas)}")


def _sorted_p4(cfg, x: torch.Tensor):
    """Cell-sort positions and build the plan, as the step does."""
    from pdb_sph_tpu_torch.ops import cuda_pbf, hashgrid

    n = x.shape[0]
    n_pad = cuda_pbf.pad_to_chunks(cfg, n)
    cid = hashgrid.cell_ids(cfg, x)
    cid_pad = torch.cat([cid, cid.new_full((n_pad - n,), cfg.num_nb_cells)])
    sorted_cid, order = hashgrid.sort_by_cell(cfg, cid_pad)
    p4 = torch.zeros((n_pad, 4), dtype=torch.float32, device=x.device)
    p4[:n, :3] = x[order[:n]]
    return p4, cuda_pbf.build_plan(cfg, sorted_cid)


def phase_kernels(device, n: int = N_MAIN) -> dict:
    """Each kernel against its plain version on one mid-collapse state."""
    import pdb_sph_tpu_torch as pbf
    from pdb_sph_tpu_torch.ops import cuda_pbf
    from pdb_sph_tpu_torch.utils.timing import cuda_ms

    cfg = pbf.default_config(n=n)
    state = pbf.spawn(cfg, "dam_break", seed=0, device=device)
    state = pbf.make_rollout(cfg, "window", SETTLE_STEPS, device=device)(state)
    p4, plan = _sorted_p4(cfg, state.x)

    d_k = cuda_pbf.density_pass(cfg, p4, plan, n)
    d_r = cuda_pbf.density_pass_ref(cfg, p4, plan, n)
    lam_k, lam_r = d_k[:n, 3], d_r[:n, 3]
    lam_err = (lam_k - lam_r).abs()
    lam_bad = int((lam_err > LAMBDA_ATOL + LAMBDA_RTOL * lam_r.abs()).sum())
    lam_rel = float((lam_err / lam_r.abs().clamp_min(1e-12)).max())
    if not torch.equal(d_k[:n, :3], p4[:n, :3]):
        raise AssertionError("density kernel changed the positions it carries")

    # both project versions take the kernel's density output
    p_k = cuda_pbf.project_pass(cfg, d_k, plan, n)
    p_r = cuda_pbf.project_pass_ref(cfg, d_k, plan, n)
    pos_err = (p_k[:n, :3] - p_r[:n, :3]).abs()
    pos_max = float(pos_err.max())
    move = float((p_r[:n, :3] - d_k[:n, :3]).abs().max())

    buf = torch.empty_like(p4)
    times = {
        "density_lambda": (
            cuda_ms(lambda: cuda_pbf.density_pass(cfg, p4, plan, n, buf),
                    REPS),
            cuda_ms(lambda: cuda_pbf.density_pass_ref(cfg, p4, plan, n, buf),
                    REPS)),
        "project": (
            cuda_ms(lambda: cuda_pbf.project_pass(cfg, d_k, plan, n, buf),
                    REPS),
            cuda_ms(lambda: cuda_pbf.project_pass_ref(cfg, d_k, plan, n, buf),
                    REPS)),
    }
    lens = (plan.ranges[..., 1] - plan.ranges[..., 0]).sum(dim=1)
    print(f"[kernels] n={n} after {SETTLE_STEPS} steps; candidates/chunk "
          f"mean {float(lens.float().mean()):.1f} max {int(lens.max())}; "
          f"lambda max|err| {float(lam_err.max()):.3e} max rel "
          f"{lam_rel:.3e} (tol {LAMBDA_ATOL:g} + {LAMBDA_RTOL:g}|ref|, "
          f"{lam_bad} outside); positions max|err| {pos_max:.3e} (atol "
          f"{POS_ATOL:g}; largest move {move:.3e})")
    for name, (k_ms, r_ms) in times.items():
        print(f"[kernels] {KERNELS[name][0]}: kernel {k_ms:.4f} ms, plain "
              f"{r_ms:.4f} ms (median of {REPS}, CUDA events)")
    if lam_bad or not pos_max <= POS_ATOL:
        raise AssertionError("a kernel disagrees with its plain version")
    errs = {"density_lambda": float(lam_err.max()), "project": pos_max}
    return {k: (errs[k], *times[k]) for k in KERNELS}


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


def phase_main(device, card: str, n: int = N_MAIN,
               steps: int = ROLLOUT_STEPS) -> dict:
    import pdb_sph_tpu_torch as pbf
    from pdb_sph_tpu_torch.ops import cuda_pbf
    from pdb_sph_tpu_torch.utils.timing import fence

    cfg = pbf.default_config(n=n)
    rollout = pbf.make_rollout(cfg, "window", steps, with_stats=True,
                               device=device)
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
    print(f"[main] dam_break n={n}: {steps} steps in {secs:.4f} s = "
          f"{steps / secs:.2f} steps/s = {n * steps / secs:.1f} "
          f"particle-steps/s on {card} (settle chunk {settle_s:.2f} s); "
          f"stats {stats.tolist()} (settle {settle_stats.tolist()}); "
          f"finite {finite}; escaped {escaped}; launches {launches}")
    want = cfg.solver_iters * steps
    if not finite or escaped or stats.tolist() != [0, 0, 0] \
            or settle_stats.tolist() != [0, 0, 0]:
        raise AssertionError("main path state or stats are wrong")
    if any(launches[k] != want for k in KERNELS):
        raise AssertionError(f"expected {want} launches of each kernel, "
                             f"got {launches}")

    stages = _stage_breakdown(rollout.stepper, state)
    total = sum(stages.values())
    print("[main] step breakdown (median of "
          f"{REPS} steps, CUDA events, ms): "
          + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
          + f"; sum {total:.4f}")
    return launches


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

    card = phase_device()
    phase_build()
    kern = phase_kernels(device)
    phase_oracle(device)
    launches = phase_main(device, card)

    report = [
        {"name": KERNELS[k][0], "route": "cuda", "source": CU_SOURCE,
         "replaces": KERNELS[k][1], "launches": launches[k],
         "max_abs_err": kern[k][0], "ms": kern[k][1], "plain_ms": kern[k][2]}
        for k in KERNELS
    ]
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
