#!/usr/bin/env python3
"""Check the PyTorch port on one NVIDIA card: its kernels, paths and runner.

Run from the repository root, on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py

This is the card's correctness check, not a benchmark: the end-to-end and
per-layer numbers of the configurations the benchmark has cells for
(BENCHMARK.json) are pbfbench's, and this script times none of them. It
prints one rate line for each configuration that no cell measures, each
kernel's ms against the pair work pbfbench/work.py counts, and peak memory.

Phases, each printing its own line(s); any failure raises and the script
exits non-zero:

  1. device  — the card's name and power limit, torch / CUDA / nvcc versions;
  2. build   — the CUDA kernels built from csrc/ with nvcc;
     finalize — the finalize kernel (csrc/pbf_finalize.cu) against the
               plain torch chain it replaces on the same card tensors, bit
               for bit, in both collide modes: rows past each of the six
               walls moving out and in, v == 0 rows, NaN and +-inf in p and
               in last and a NaN velocity at a wall, as contiguous rows
               and as the solve buffer's stride-4 rows; the inputs of the
               step's own finalize on the 80k and 1M dam breaks at steps 60
               and 480; its flag against the old finite check; the step's
               non-finite stat on the dense backend with a NaN, an inf and
               (strict) a NaN velocity at a wall; the kernel's and the
               chain's ms beside the kernel's byte bound;
     plan   — the plan kernels (csrc/pbf_plan.cu) against the plain plan
               (cuda_pbf.build_plan_ref) on the same card tensors, every
               WindowPlan field bit for bit: the sorted cell ids of the 80k
               dam break at steps 0, 60 and 480 and of the 1M dam break at
               step 60, at own 32, 64, 128 and 256, with rank 0 of D = 2's
               restricted plans; the work table on 31,250 synthetic
               chunks, stretched and not, with its work-item counters; a
               plan's ms in a graph against the plain plan's; 240 graph
               steps of the 80k and the 1M dam break from the seed-0 spawn
               bitwise the same rollout on the plain plan, with the same
               counters;
  3. kernels — each kernel against its plain torch version on the same
               inputs, at the main path's shape, with errors and times: the
               FP32 kernels (csrc/pbf_window.cu) and the six tensor-core
               instantiations (csrc/pbf_tc.cu) on the 80k dam break
               mid-collapse (step 60) and settled (step 480, the heaviest
               own-chunks), each launched twice for bitwise-equal output,
               the scratch's counters back at 0, each lambda and project
               form beside the least time of work.py's flops for the pairs
               within h; then the same checks at own 32, 128 and 256 (step
               60) with a 40-step rollout at each, and on restricted plans
               (each plan's kernels bitwise the plain plan's), as rank 0 of
               two sees them (density forms on own keys plus one ring,
               project forms on own keys), the masked chunks' rows as
               JAX's rule writes them;
  4. oracle  — 3 window-backend steps against the all-pairs dense backend;
  5. main    — the 80k dam break rolled out 240 steps after a 240-step
               settle chunk (the Rollout replays its CUDA graph: the launch
               counts show the replays ran the geometry's two kernels
               solver_iters times a step, finalize once and nothing else):
               stats, launch counts; then the same with every tensor-core
               switch on (with its steps/s), and two short rollouts with
               {mxu_sum} and {mxu_rd2, mxu_proj}, so that each tensor-core
               instantiation runs on a path; then the graph against the
               eager loop in both geometries ([graph]): 240 graph steps
               bitwise 240 eager Stepper.step calls from one settled state,
               20 eager steps and 20 graph steps under
               torch.cuda.set_sync_debug_mode("error"); then the sharded
               paths (parallel/sharded.py): one rank (its fast path) bitwise
               against the Stepper for 3 steps, then its graph rollout
               bitwise the eager ShardedStepper loop for 240 more, with the
               graph's rate; two gloo ranks sharing the card (NCCL refuses
               two ranks on one card), against the Stepper at step 3, by
               the population discriminator at step 23 and by their density
               diagnostics at steps 3, 23 and 243; and the cell backend at
               80k against the window backend, its one-rank sharded rollout
               (a graph) bitwise the eager loop, then on a table that
               overflows (the runner, whose cell rollout is a graph, exits
               2); and the single-device cell and dense rollouts as CUDA
               graphs ([backends]), each bitwise its eager loop, with its
               graph's rate: the 80k cell rollout on that table over 10
               steps from the spawn; the cell backend at 2048 on a table
               sized from the window state at step 240, 240 steps, and 20
               under the sync-debug mode; dense at 2048, 40 steps;
  6. settle  — the settle gate (core/settle.py): the 8k dam break run 2000
               steps must come to rest (mean dense rho within 5 % of rho0,
               max speed < 0.5, nothing escaped, stats [0, 0, 0], no NaN),
               in the default geometry and with every tensor-core switch
               on, each also with one work item a chunk (a witness whose
               sums differ from the geometry's only in their order);
  7. cli     — the runner (pdb_sph_tpu_torch.cli.main) in-process on the
               card: the 80k dam break with metrics, frames, a GIF and a
               checkpoint; a resume of it that ends on a partial chunk; the
               80k blowup; and a short 80k dam break with
               PBF_MXU_SUM/RD2/PROJ=1 in the environment; each run captures
               one graph, allocates one pair-kernel scratch, its
               diagnostics included, and launches the kernels its geometry
               does;
  8. scale   — the JAX package's large single-device rows
               (benchmarks/bench_matrix.py:96-143), each in a box scaled to
               the reference's number density ([scale] lines): the kernels
               on the 1M dam break (wall 4.64) at step 60 (all nine forms
               against their plain versions, the pairs within h by the
               FP32 and the tensor-core rd2, and rho of 4096 sampled
               particles against a brute-force sum over all 1M, within
               DENSE_RHO_RTOL); the 1M dam break rolled out 240 graph steps
               after a settle chunk, in the default geometry and with every
               switch on (mean rho within 1 % of the default's), and the 2M
               dam break (wall 5.85): peak memory, stats, box, escapes, the
               final diagnostics, and the rate of each but the 1M default
               geometry (the cell dam1m.rollout); the 1M blowup through
               1040 steps, diagnostics every 80; the runner at 1M as the
               README's command, frames, GIF and checkpoint, then its
               resume to step 100; and the one-rank sharded fast path at
               1M.

On a machine with four cards, `python3 chip_smoke.py --ranks 4` runs
phases 1-2, then only the [nccl] phases: the sharded rollout on NCCL ranks,
one card each, a CUDA graph whose collectives replay with it, at the JAX
package's multi-device configuration (benchmarks/bench_multichip.py:62-70,
the 1M dam break). It exits non-zero when torch sees fewer cards. The nine
forms against their plain versions on rank 1 of D = 4's restricted plans
of that row (the plan and both restricted plans bitwise the plain plan's);
for D = 2 and D = 4, through launch.rollout_ranks: 3 steps against the
single-card Stepper, the population at step 23 and the mean
density at steps 3, 23 and 243; then 240 graph steps bitwise 240 eager
ShardedStepper steps; 20 graph steps under set_sync_debug_mode("error");
the graph's steps/s and the line of bench_multichip.py's fields, also for
D = 1. At D = 4 also: the 2M dam break (wall 5.85), every tensor-core
switch, the cell backend at 80k against the window backend, and the
runner on four cards with frames, GIF and checkpoint and the JAX package's
tier flags (--retier-at 240 --retier-maxlanes 49152 --retier-geom
cc_d=512), then its resume past the re-tier, a forced ghost overflow on
the compact tier (it falls back) and a forced migration overflow (rc 2);
each rank of the runner captures one graph and allocates one pair-kernel
scratch a tier. [tiers], the JAX package's two-tier flow
(parallel/sharded.py:244-292), at D = 2 and 4: rollout_ranks re-tiers at
step 243 and runs 240 more steps on the compact tier; from the step-243
state each tier runs 240 graph steps (slots, peak memory, balance,
stats), the compact tier's graph bitwise its eager loop, both tiers in
lockstep (bitwise while their slab bounds agree); at D = 4 the nine forms
on rank 1's compact-tier local set and plans against their plain
versions. Last, after the runner, [soak], tests/test_sharded_soak.py's
invariants (parallel/soak.py) on the cards at D = 4 after every chunk
(active counts sum to n, no overflow, no NaN, every rank's bounds row the
same, every slab at least 2 z-rows + 2 cells wide, the bounds spanning the
grid; the boundaries moving, max/mean of the loads within 2.0 for the dam
and 3.0 for the blowup after the first chunk, the final state finite and
in the box), each rank's stages with their seconds: the 1M dam break of
[nccl] through a re-tier after 243 steps and 1920 compact-tier steps, and
the 1M blowup with [nccl]'s table through 1040 spawn-tier steps in chunks
of 80; each final mean density within 1 % of a one-card graph Rollout's
at the same step; K1 lambda, K2 and K1 rho on rank 1's local set at each
last state against their plain versions. The mode ends with its own
kernels line.

Every path (phases 5, 6 and 7's runs, the sharded rollouts, phase 8's
rollouts and runs) is driven with the kernel launch counts set to 0 just
before it and read just after, and held to what its geometry launches in
that many steps (_launches); the two ranks count in their own processes
and report their counts. A graph's launches count once per replay; the
eager warm-up step before its capture launches for real and counts too
(WARMUP_STEPS).

The line before the last is a JSON object with each kernel's launches
(`launches_from` names the phases they were counted in: the FP32 solve
kernels' from phase 5 and the sharded rollouts, the rho output's from
phase 7's runs and the two ranks' diagnostics, the all-switches tensor-core kernels' from phases 5-7, the
four one-switch instantiations' from phase 5's short rollouts; phase 8's
paths add to the kernels they run), error and times at both steps, on the restricted
plans, at each other own and on the 1M dam break; the
`[done]` line before it gives the script's seconds. Its last entry is
the finalize kernel's: its launches on the main paths (phase 5's
rollouts, the fast path, the two ranks and phase 8's runs), bitwise the
chain (max_abs_err 0), its ms and the chain's at 80k and 1M at both
steps, and its byte bound (52 B a particle); then the plan's two
kernels', with their launches on the same paths and a plan's ms against
the plain plan's at 80k and 1M. The last line is
{"ok": true, "device": {...}}. Without a card, or without the package beside it, the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch

N_MAIN = 80_000        # the flagship dam break
SETTLE_STEPS = 60      # kernel-vs-plain inputs: mid-collapse state
SETTLED_STEP = 480     # and the settled state, with the heaviest chunks
N_ORACLE = 2048
ROLLOUT_STEPS = 240
# the eager step a graph rollout's first call runs before its capture
WARMUP_STEPS = 1
# the Jacobi iterations of a step: config.SimConfig.solver_iters in every
# configuration here, each a launch of the density and the project kernel
SOLVER_ITERS = 3
# [graph]: steps under the sync-debug mode
SYNC_STEPS = 20
# the one-switch geometries' rollouts: each runs its two instantiations
SHORT_STEPS = 40
REPS = 20
PLAIN_REPS = 5  # the FP32 plain versions take ~0.2 s each
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
# than that plain version lies to the plain FP32 form. In a larger box the
# ulp of |p|^2 <= 3 wall^2 grows, and the atol with it (_tc_lambda_atol).
# The project forms with mxu_proj keep TC_POS_ATOL; where a check asks for
# the witness (_proj_witness), rows beyond it pass only if the kernel lies
# no farther from the form's float64 evaluation than its FP32 plain
# version does, plus TC_POS_ATOL: both are then roundings of one function.
TC_LAMBDA_RTOL, TC_LAMBDA_ATOL = 1e-4, 1e-6
TC_POS_ATOL = 1e-5
TC_SEPARATION = 10
TC_PLAIN_REPS = 3  # the plain tensor-core forms take ~0.5 s each
SETTLE_N, SETTLE_GATE_STEPS = 8192, 2000
# the settle gate's witness geometry: segments longer than any chunk's
# candidates, so one work item a chunk
WITNESS_SEG = 1 << 20
# the runner's runs: 80k dam break, its resume (chunks 20, 20 and a
# partial 10), the 80k blowup
CLI_STEPS, CLI_RESUME_STEPS, CLI_EVERY, CLI_RENDER = 240, 50, 20, 120
# window vs dense over 3 steps (tests/test_pallas.py:45-55)
ORACLE_RTOL, ORACLE_ATOL = 1e-4, 1e-5

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
# the own values beside the default 64 that the kernels are built for, each
# checked at step 60 and rolled out C2_STEPS steps
C2_OWNS = (32, 128, 256)
C2_STEPS = 40
C2_REPS = 5
# the sharded paths: 3 steps against the single-device step, then a
# rollout; two ranks share the card as gloo ranks (NCCL refuses two ranks
# on one card), tolerances of __graft_entry__.py:89-104
SHARD_STEPS, SHARD_ROLLOUT = 3, 240
SHARD_RTOL, SHARD_ATOL = 1e-4, 2e-5
# the population discriminator, at the horizon it was made for (the
# dryrun's 12 + 8 steps): a missing ghost band moves most boundary-band
# particles, the order of the sums a few percent of all
POP_STEPS = 20
POP_MAX_DEV, POP_TOL, POP_FRAC = 5e-2, 2e-5, 0.05
# the chunks of a multi-rank run against the Stepper, on gloo and on NCCL:
# they end at steps 3, 23 (the population) and 243
RANK_CHUNKS = (SHARD_STEPS, POP_STEPS, SHARD_ROLLOUT - POP_STEPS)
RANK_MARKS = (SHARD_STEPS, SHARD_STEPS + POP_STEPS,
              SHARD_STEPS + SHARD_ROLLOUT)
# past it the order of the sums alone spreads every trajectory, so the
# ranks are held by their density diagnostics against the single device's:
# mean rho within this share. A particle within h of the slab boundary
# whose ghosts went missing would count part of its neighbours only, and
# the share of such particles would pull the mean down by a few percent.
# The max |rho/rho0 - 1| is printed, not held: one splashed particle with
# no neighbour reads ~1 in one trajectory and not in the other
DENS_MEAN_RTOL = 0.01
RANKS_TIMEOUT_S = 600
# the cell backend against the window backend over 3 steps (ROADMAP
# "Parity method"); its table sized from the spawn with this slack
CELL_STEPS, CELL_SLACK = 3, 1.5
# [backends]: the 80k cell rollout as a graph on that table against the
# eager loop; a cell step there took 1477 device ms on an NVIDIA H100 80GB
# HBM3 at 700 W (plain torch, ~38k kernels over 1504 rows x 27 x 256^2
# pairs a pass), so the run is short. The dense rollout at N_ORACLE as a
# graph
CELL_GRAPH_STEPS = 10
DENSE_GRAPH_STEPS = 40
# [scale]: the JAX package's large single-device rows
# (benchmarks/bench_matrix.py:96-143), each in a box scaled to keep the
# reference's number density (wall = 2 (n / 80k)^(1/3)): row -> (scene,
# n, wall)
SCALE_ROWS = {"dam1m": ("dam_break", 1_000_000, 4.64),
              "dam2m": ("dam_break", 2_000_000, 5.85),
              "blowup1m": ("blowup", 1_000_000, 4.64)}
# a dam row: one settle chunk, then a rollout
SCALE_SETTLE, SCALE_STEPS = 240, 240
# the JAX rows' in-box test (bench_matrix.py:81): [-0.25, wall + 0.25]^3
BOX_MARGIN = 0.25
# the blowup row: JAX settles it 1000 steps, then times a 20-step chunk
# (bench_matrix.py:137-138); diagnostics every BLOWUP_EVERY steps
BLOWUP_STEPS, BLOWUP_EVERY = 1040, 80
# the sampled dense oracle at 1M: rho of ORACLE_SAMPLES seeded-random
# particles against a brute-force sum over all n, ORACLE_BATCH at a time.
# The kernel adds ~50 float32 terms in another order (~1e-6 relative); a
# neighbour within 0.9 h adds more than 1.4e-4 of rho0
ORACLE_SAMPLES, ORACLE_SEED, ORACLE_BATCH = 4096, 0, 32
DENSE_RHO_RTOL = 1e-4
# the runner at 1M as the README's command (--grid-width 29), then a resume
# to step 100 in chunks of SCALE_CLI_CHUNK, the last one partial
SCALE_CLI_STEPS, SCALE_CLI_RESUME, SCALE_CLI_CHUNK = 60, 40, 30
# [nccl] (--ranks): the JAX package's multi-device configuration
# (benchmarks/bench_multichip.py:62-70), not cut: the 1M dam break in the
# box of its number density, grid_width 40, a cell table of 4096 x 256, seed
# 0; the 2M row beside it at D = 4. row -> (n, wall)
NCCL_ROWS = {"dam1m": (1_000_000, 4.64), "dam2m": (2_000_000, 5.85)}
NCCL_TABLE = dict(grid_width=40, max_occupied_cells=4096, cell_capacity=256)
NCCL_DS = (2, 4)
# after the correctness chunks (RANK_CHUNKS), from their last step: graph
# vs eager over NCCL_STEPS steps each, NCCL_SYNC_STEPS graph steps under the
# sync-debug mode
NCCL_STEPS, NCCL_SYNC_STEPS = 240, 20
# the restricted plans at the row's size: this rank of D = 4, whose band has
# ghosts on both sides; and the rank whose compact-tier local set [tiers]
# checks the nine forms on
NCCL_RESTRICTED_RANK = TIER_RANK = 1
# every switch at D = 4: rollouts of this many steps from the spawn, in the
# default geometry, with every switch, and in the one-switch geometries
NCCL_SWITCH_STEPS = 40
# the runner on the cards: steps, record and frame cadence, the re-tier
# step (with the JAX tier flags of docs/SCALING.md:176-179), then a resume
# past it ending on a partial chunk; the forced-overflow runs from the
# run's checkpoint
NCCL_CLI_STEPS, NCCL_CLI_EVERY, NCCL_CLI_RENDER = 300, 20, 100
NCCL_CLI_RETIER, NCCL_CLI_RESUME, NCCL_CLI_CHUNK = 240, 40, 30
NCCL_CLI_FORCED_STEPS = 60
JAX_TIER_FLAGS = ["--retier-maxlanes", "49152", "--retier-geom", "cc_d=512"]
# [soak] (--ranks): the invariants of tests/test_sharded_soak.py after every
# chunk, on SOAK_D NCCL ranks at the 1M multi-device row: the dam break
# (NCCL_ROWS, NCCL_TABLE) through a re-tier after its first chunk, then 8 x
# NCCL_STEPS compact-tier steps (2163 in all); the blowup (SCALE_ROWS'
# blowup1m with NCCL_TABLE) on the spawn tier at the one-card blowup1m's
# horizon and cadence. scene -> (chunks, the chunk that re-tiers, the
# imbalance limit of test_sharded_soak.py:51-57). Each final mean density
# is held against a one-card graph rollout's (DENS_MEAN_RTOL); K1 lambda,
# K2 and K1 rho on rank SOAK_RANK's local set at each leg's last state
SOAK_D, SOAK_RANK = 4, 1
SOAK_TIMEOUT_S = 300   # a leg's ranks: ~1 minute expected
SOAK_LEGS = {
    "dam_break": ((RANK_MARKS[-1],) + (NCCL_STEPS,) * 8, 1, 2.0),
    "blowup": ((BLOWUP_EVERY,) * (BLOWUP_STEPS // BLOWUP_EVERY), None, 3.0),
}
# where each rank of the runner leaves what it counted, and which overflow
# it forces on the compact tier
RANK_COUNTS_ENV = "CHIP_SMOKE_RANK_COUNTS"
RANK_FORCE_ENV = "CHIP_SMOKE_RANK_FORCE"


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cards = smi.splitlines()
    print("\n".join(cards))
    if len(cards) == 1:
        card = cards[0]
    elif len(set(cards)) == 1:
        card = f"{len(cards)} x {cards[0]}"
    else:
        card = "; ".join(cards)
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


def _peaks() -> dict | None:
    """The card's published peaks from the benchmark's table
    (pbfbench/peaks.json), or None for a card it does not list."""
    from pbfbench import work

    return work.peaks(torch.cuda.get_device_name(0))


def _least_ms(name: str, pairs: int | None) -> float | None:
    """The least ms of one launch of kernel `name` on data with `pairs`
    ordered pairs within h (pbfbench/work.py's count): the flops work.py
    charges those pairs in the pass the kernel computes, at the card's FP32
    peak. None for K1 rho's diagnostic density, which work.py does not
    count, for a plan whose pairs it does not count (restricted plans, a
    rank's local set: `pairs` None) and for a card without a peak."""
    from pbfbench import work

    peak = _peaks()
    if name == "density_rho" or pairs is None or peak is None:
        return None
    flops = (work.LAMBDA_FLOPS_PER_PAIR if name.startswith("density")
             else work.PROJECT_FLOPS_PER_PAIR)
    return 1e3 * pairs * flops / peak["fp32_flop_per_s"]


def _least_txt(bound: float | None, pairs: int | None, ms: float) -> str:
    if bound is None:
        return ""
    return (f"; bound {1e3 * bound:.2f} us for {pairs} pairs within h "
            f"(pbfbench/work.py), {100 * bound / ms:.1f} % of it")


def _pairs(cfg, p4, n: int) -> int:
    """The ordered pairs within h, self included, of the first n rows:
    pbfbench/work.py's census, the pair work of a pass on these rows."""
    from pbfbench import work

    return work.pairs_within(p4[:n, :3], cfg.h)


def _finalize_rows(device, n: int = 1024, nonfinite: bool = True):
    """(p, last) on `device`: rows past each of the six walls, moving out
    of and into the box, v == 0 rows (tests/test_torch_ops.py's), and with
    `nonfinite` NaN and +-inf in p and in last and a NaN velocity at the
    wall x = 0."""
    import numpy as np
    from pdb_sph_tpu_torch.ops import collide

    rng = np.random.default_rng(2)
    last = (rng.random((n, 3)) * 2.0).astype(np.float32)
    p = (rng.random((n, 3)) * 3.0 - 0.5).astype(np.float32)
    for k, (axis, upper) in enumerate(collide._WALL_ORDER):
        rows = slice(k * 64, (k + 1) * 64)
        p[rows, axis] = 2.2 if upper else -0.2
        last[rows, axis] = np.where(np.arange(64) % 2, 1.0,
                                    2.4 if upper else -0.4)
    last[-4:] = p[-4:]
    if nonfinite:
        p[400, 1], p[401, 0], p[402, 2] = np.nan, np.inf, -np.inf
        last[403, 0], last[404, 2] = np.nan, -np.inf
        p[405, 0], last[405, 0] = -0.2, np.nan
        # NaN velocities at an upper wall and at a later wall's axis
        p[406, 2], last[406, 2] = 2.2, np.nan
        p[407, 1], last[407, 0] = -0.2, np.inf
    return (torch.from_numpy(p).to(device), torch.from_numpy(last).to(device))


def _finalize_check(cfg, p, last) -> list[str]:
    """The kernel against the plain chain on the same card tensors in both
    collide modes: the faults found (coordinates whose bits differ, a flag
    other than the old finite check's, a launch not counted once)."""
    import dataclasses

    from pdb_sph_tpu_torch.ops import collide, cuda_pbf

    bad = []
    for strict in (False, True):
        c = dataclasses.replace(cfg, strict_reference_collide=strict)
        before = cuda_pbf.LAUNCHES["finalize"]
        got = collide.finalize(c, p, last)
        if cuda_pbf.LAUNCHES["finalize"] != before + 1 \
                or not isinstance(got, collide.Finalized):
            bad.append(f"strict {strict}: the kernel did not run once")
        want = collide.finalize_ref(c, p, last)
        for name, a, b in zip("xv", got, want):
            diff = int((a.view(torch.int32) != b.view(torch.int32)).sum())
            if diff:
                bad.append(f"strict {strict}: {diff} coordinates of {name} "
                           "differ from the chain's bits")
        flag, old = int(got.nonfinite), int(collide.nonfinite(*want))
        if flag != old or int(collide.nonfinite(*got)) != old:
            bad.append(f"strict {strict}: flag {flag}, old check {old}")
    return bad


def _graph_ms(fn, reps: int = REPS) -> float:
    """Device ms a call of `fn`, from `reps` calls captured into one CUDA
    graph and replayed between two CUDA events."""
    from pdb_sph_tpu_torch.ops import cuda_pbf

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with cuda_pbf.captured_launches(), torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    g.reset()
    return ms


def phase_finalize(device) -> dict:
    """The finalize kernel bit for bit against the plain chain
    (_finalize_check) on the wall rows, then on the inputs of the step's
    own finalize (the solve buffer's rows, and a contiguous copy) on the
    80k and the 1M dam break at steps 60 and 480, each timed beside its
    byte bound; the step's non-finite stat on the dense backend. Returns
    {(n, step): (kernel ms, chain ms, bound ms)}."""
    import dataclasses

    import pdb_sph_tpu_torch as pbf
    from pdb_sph_tpu_torch.core import step as core_step
    from pdb_sph_tpu_torch.ops import collide

    bad = []
    cfg = pbf.default_config(n=N_MAIN)
    for nonfinite in (False, True):
        p, last = _finalize_rows(device, nonfinite=nonfinite)
        buf = torch.zeros((p.shape[0] + 64, 4), device=device)
        buf[:p.shape[0], :3] = p
        for layout, q in (("rows", p),
                          ("stride-4 rows", buf[:p.shape[0], :3])):
            bad += [f"wall rows ({layout}, non-finite rows {nonfinite}): {b}"
                    for b in _finalize_check(cfg, q, last)]
    print(f"[finalize] the wall rows (1024, past each wall out and in, "
          f"v == 0, NaN and inf in p and last, NaN velocities at walls), "
          f"contiguous and stride-4 rows, both collide modes: kernel bitwise "
          f"the chain and its flag the old check's: {not bad}")

    times, seen, real = {}, [], core_step.finalize
    peak = _peaks()

    def record(c, p, last):
        seen.append((p, last))
        return real(c, p, last)

    _, n1m, wall1m = SCALE_ROWS["dam1m"]
    for n, wall in ((N_MAIN, 2.0), (n1m, wall1m)):
        cfg = pbf.default_config(n=n, wall=wall)
        stepper = pbf.make_step(cfg, "window", device=device)
        rollout = pbf.make_rollout(cfg, "window", SETTLE_STEPS,
                                   device=device)
        state = rollout(pbf.spawn(cfg, "dam_break", seed=0, device=device))
        for step in (SETTLE_STEPS, SETTLED_STEP):
            if step > int(state.step):
                state = rollout(state, step - int(state.step))
            core_step.finalize = record
            try:
                stepper.step(state)
            finally:
                core_step.finalize = real
            p, last = seen.pop()
            if p.stride(0) != 4:
                bad.append(f"n {n} step {step}: the step's p has row stride "
                           f"{p.stride(0)}, not the solve buffer's 4")
            for layout, q in (("stride-4 rows", p), ("rows", p.contiguous())):
                bad += [f"n {n} step {step} ({layout}): {b}"
                        for b in _finalize_check(cfg, q, last)]
            kernel = _graph_ms(lambda: collide.finalize(cfg, p, last))
            chain = _graph_ms(lambda: collide.nonfinite(
                *collide.finalize_ref(cfg, p, last)))
            bound = (52 * n / peak["hbm_byte_per_s"] * 1e3 if peak
                     else None)
            times[(n, step)] = (kernel, chain, bound)
            bound_txt = ("" if bound is None else
                         f"; bound 52 B x n / "
                         f"{peak['hbm_byte_per_s'] / 1e12:g} TB/s = "
                         f"{bound * 1e3:.2f} us ({100 * bound / kernel:.1f} "
                         f"% of it)")
            print(f"[finalize] dam n={n} step {step}: the step's own inputs "
                  f"(stride-4 rows and a contiguous copy), both modes, "
                  f"bitwise the chain: "
                  f"{not any(f'n {n} step {step}' in b for b in bad)}; "
                  f"kernel {kernel:.4f} ms a call (its flag's memset "
                  f"included) against the chain and finite check {chain:.4f} "
                  f"ms ({chain / kernel:.1f}x){bound_txt}")
        del stepper, rollout, state, p, last
        torch.cuda.empty_cache()

    # the step's stats[2], the flag, on the dense backend (plain all-pairs
    # solve, so a non-finite state touches no pair kernel)
    cfg = pbf.default_config(n=N_ORACLE)
    cases = {"all finite": (False, None), "NaN in x": (False, ("x", 7, 1)),
             "inf in v": (False, ("v", 7, 0)),
             "strict NaN velocity at a wall": (True, ("x", 7, 0))}
    values = {"NaN in x": float("nan"), "inf in v": float("inf"),
              "strict NaN velocity at a wall": float("-inf")}
    got = {}
    for case, (strict, plant) in cases.items():
        c = dataclasses.replace(cfg, strict_reference_collide=strict)
        st = pbf.spawn(c, "dam_break", seed=0, device=device)
        if plant is not None:
            name, row, axis = plant
            t = getattr(st, name).clone()
            t[row, axis] = values[case]
            st = st._replace(**{name: t})
        out, stats = core_step.step_fn(c, "dense", st, with_stats=True)
        old = int(collide.nonfinite(out.x, out.v))
        got[case] = stats.tolist()
        if got[case] != [0, 0, int(plant is not None)] or old != got[case][2]:
            bad.append(f"dense step, {case}: stats {got[case]}, old finite "
                       f"check {old}")
    print(f"[finalize] the step's stats on the dense backend at "
          f"{N_ORACLE}: {got}")
    if bad:
        raise AssertionError("finalize: " + "; ".join(bad))
    return times


@contextlib.contextmanager
def _plain_plan():
    """Inside the context the step, the sharded step and the diagnostics
    build the plain plan (cuda_pbf.build_plan_ref, work_table_ref) on the
    card, as the port did before csrc/pbf_plan.cu: the plan kernels'
    yardstick."""
    from pdb_sph_tpu_torch.ops import cuda_pbf

    real = cuda_pbf.build_plan, cuda_pbf.work_table
    cuda_pbf.build_plan = cuda_pbf.build_plan_ref
    cuda_pbf.work_table = cuda_pbf.work_table_ref
    try:
        yield
    finally:
        cuda_pbf.build_plan, cuda_pbf.work_table = real


def _plan_faults(tag: str, got, want) -> list[str]:
    """The fields of plan (or table) `got` whose dtype, shape or bits are
    not `want`'s."""
    bad = []
    for name, a, b in zip(getattr(want, "_fields", range(len(want))), got,
                          want):
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            bad.append(f"{tag}: {name} differs ({a.dtype} {tuple(a.shape)} "
                       f"vs {b.dtype} {tuple(b.shape)})")
    return bad


ITEM_COUNTERS = ("pair_items", "chunk_items_max")


def _item_counters(device) -> dict:
    """The work table's two counters, zeroed, as Stepper.counters holds
    them."""
    return {k: torch.zeros((), dtype=torch.int64, device=device)
            for k in ITEM_COUNTERS}


def _counter_faults(tag: str, got: dict, want: dict) -> list[str]:
    """The counters of `got` whose value is not `want`'s."""
    return [f"{tag}: counter {k} {int(got[k])} against {int(want[k])}"
            for k in want if int(got[k]) != int(want[k])]


def _check_plan(cfg, sorted_cid, keeps=(), tag: str = "") -> list[str]:
    """The plan kernels against the plain plan on the same card tensor,
    every WindowPlan field bit for bit, twice (the same bits again), each
    call one launch of each kernel, the second adding into the work-item
    counters as the plain plan does; then restrict_plan on each mask of
    `keeps`, with the work table's kernel against the plain one. The
    faults found."""
    from pdb_sph_tpu_torch.ops import cuda_pbf

    bad = []
    before = dict(cuda_pbf.LAUNCHES)
    counted = _item_counters(sorted_cid.device)
    got = cuda_pbf.build_plan(cfg, sorted_cid)
    again = cuda_pbf.build_plan(cfg, sorted_cid, counted)
    done = {k: cuda_pbf.LAUNCHES[k] - before[k] for k in before}
    if _nonzero(done) != {"plan": 2, "work_table": 2}:
        bad.append(f"{tag}: two plans launched {_nonzero(done)}")
    plain = _item_counters(sorted_cid.device)
    want = cuda_pbf.build_plan_ref(cfg, sorted_cid, plain)
    bad += _plan_faults(f"{tag} plan", got, want)
    bad += _plan_faults(f"{tag} plan again", again, got)
    bad += _counter_faults(f"{tag} plan", counted, plain)
    for i, keep in enumerate(keeps):
        r = cuda_pbf.restrict_plan(cfg, got, keep)
        with _plain_plan():
            r_want = cuda_pbf.restrict_plan(cfg, want, keep)
        bad += _plan_faults(f"{tag} restricted {i}", r, r_want)
    return bad


def phase_plan(device) -> dict:
    """The plan kernels (csrc/pbf_plan.cu) bit for bit against the plain
    plan (_check_plan): on the sorted cell ids of the 80k dam break at
    steps 0, 60 and 480 and of the 1M dam break at step 60, at own 32, 64,
    128 and 256, with rank 0 of D = 2's restricted plans at 80k step 60;
    the work table on 31,250 synthetic chunks (the 2M row's count) with
    and without stretched segments and with empty chunks, the work-item
    counters with it; each plan's ms in a graph against the plain plan's;
    then a 240-step graph rollout of the 80k and the 1M dam break from the
    seed-0 spawn, bitwise the same rollout on the plain plan, with the
    same plan-candidate and work-item counters and the launches of
    _launches. Returns {n: (kernel ms, plain ms)} at step 60 in the
    default geometry."""
    import dataclasses

    import numpy as np

    import pdb_sph_tpu_torch as pbf
    from pdb_sph_tpu_torch.core.step import sort_cells
    from pdb_sph_tpu_torch.geometry import KernelGeometry
    from pdb_sph_tpu_torch.ops import cuda_pbf, hashgrid
    from pdb_sph_tpu_torch.parallel import sharded

    bad, times = [], {}
    _, n1m, wall1m = SCALE_ROWS["dam1m"]
    rows = ((N_MAIN, 2.0, (0, SETTLE_STEPS, SETTLED_STEP)),
            (n1m, wall1m, (SETTLE_STEPS,)))
    for n, wall, steps in rows:
        cfg = pbf.default_config(n=n, wall=wall)
        rollout = pbf.make_rollout(cfg, "window", SETTLE_STEPS,
                                   device=device)
        state = pbf.spawn(cfg, "dam_break", seed=0, device=device)
        for step in steps:
            if step > int(state.step):
                state = rollout(state, step - int(state.step))
            cid = hashgrid.cell_ids(cfg, state.x)
            for own in (32, 64, 128, 256):
                c = dataclasses.replace(cfg, geom=KernelGeometry(own=own))
                sorted_cid, _ = sort_cells(c, cid)
                keeps = ()
                if n == N_MAIN and step == SETTLE_STEPS:
                    b = sharded.initial_bounds(c, 2, state=state)
                    keeps = sharded.chunk_keep(c, sorted_cid, int(b[0]),
                                               int(b[1]))
                bad += _check_plan(c, sorted_cid, keeps,
                                   f"n {n} step {step} own {own}")
            if step == SETTLE_STEPS:
                sorted_cid, _ = sort_cells(cfg, cid)
                times[n] = (
                    _graph_ms(lambda: cuda_pbf.build_plan(cfg, sorted_cid)),
                    _graph_ms(lambda: cuda_pbf.build_plan_ref(cfg,
                                                              sorted_cid)))
                print(f"[plan] dam n={n} step {step}: kernels "
                      f"{times[n][0]:.4f} ms a plan in a graph, the plain "
                      f"plan {times[n][1]:.4f} ms "
                      f"({times[n][1] / times[n][0]:.1f}x)")
        print(f"[plan] dam n={n} steps {list(steps)}, own 32-256"
              + (", rank 0 of D = 2's restricted plans at step "
                 f"{SETTLE_STEPS}" if n == N_MAIN else "")
              + ": every field bitwise the plain plan's: "
              + str(not any(f"n {n} " in b for b in bad)))
        del rollout, state
        torch.cuda.empty_cache()

    cfg = pbf.default_config(n=N_MAIN)
    chunks, seg = 31_250, cfg.geom.seg
    rng = np.random.default_rng(0)
    for scale in (4, 40):
        cand = rng.integers(0, scale * seg, size=chunks)
        cand[rng.choice(chunks, 500, replace=False)] = 0
        cand[7] = 200_000
        cand = torch.from_numpy(cand).to(device)
        counted, plain = _item_counters(device), _item_counters(device)
        got = cuda_pbf.work_table(cfg, cand, counted)
        want = cuda_pbf.work_table_ref(cfg, cand, plain)
        bad += _plan_faults(f"table {chunks} chunks to {scale} seg", got,
                            want)
        bad += _counter_faults(f"table {chunks} chunks to {scale} seg",
                               counted, plain)
        print(f"[plan] work table of {chunks} synthetic chunks (up to "
              f"{scale} x seg candidates, 500 empty): seg_len "
              f"{int(got[0])} (seg {seg}), {int(got[1][-1])} items, "
              f"{int(counted['chunk_items_max'])} the most of one chunk, "
              f"bitwise the plain table and its counters: "
              f"{not any(f'to {scale} seg' in b for b in bad)}")

    for n, wall, _ in rows:
        cfg = pbf.default_config(n=n, wall=wall)
        st = pbf.spawn(cfg, "dam_break", seed=0, device=device)
        outs = []
        for plain in (False, True):
            cuda_pbf.reset_launches()
            with _plain_plan() if plain else contextlib.nullcontext():
                rollout = pbf.make_rollout(cfg, "window", ROLLOUT_STEPS,
                                           with_stats=True, device=device)
                out, stats = rollout(st)
            torch.cuda.synchronize()
            launches = dict(cuda_pbf.LAUNCHES)
            outs.append((out, stats, {
                k: int(rollout.stepper.counters[k])
                for k in ("plan_candidates", *ITEM_COUNTERS)}))
            want = _launches(ROLLOUT_STEPS + WARMUP_STEPS)
            if plain:
                want = {k: v for k, v in want.items()
                        if k not in ("plan", "work_table")}
            try:
                _check_launches(f"[plan] n {n} plain {plain}", launches,
                                want)
            except AssertionError as e:
                bad.append(str(e))
            del rollout
        (a, sa, ca), (b, sb, cb) = outs
        same = all(torch.equal(x, y) for x, y in zip(a, b)) \
            and torch.equal(sa, sb) and ca == cb
        print(f"[plan] dam n={n}: {ROLLOUT_STEPS} graph steps from the "
              f"seed-0 spawn on the plan kernels bitwise the same rollout on "
              f"the plain plan (state, stats {sa.tolist()}, counters "
              f"{ca}): {same}")
        if not same:
            bad.append(f"n {n}: the rollout left the plain plan's bits")
        del outs, a, b, st
        torch.cuda.empty_cache()
    if bad:
        raise AssertionError("plan: " + "; ".join(bad))
    return times


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


def _rd2_census(cfg, p4, plan, n: int, head: str) -> None:
    """The (real own row, candidate) pairs of `plan` within h by the FP32
    distance and by the tensor-core forms' rd2, (|o|^2 - 2 o.c) + |c|^2
    with the bf16 split dot: taken from absolute coordinates, its error
    grows with |p|^2, that is with the box. Prints both counts, the pairs
    only one of them counts and the two rd2's largest and mean difference
    on the pairs both count."""
    from pdb_sph_tpu_torch.ops import cuda_pbf

    h2 = torch.tensor(float(cfg.h2), dtype=torch.float32, device=p4.device)
    zero = torch.zeros((), dtype=torch.int64, device=p4.device)
    fp32, split, both = zero.clone(), zero.clone(), zero.clone()
    diff_max = torch.zeros((), dtype=torch.float32, device=p4.device)
    diff_sum = torch.zeros((), dtype=torch.float64, device=p4.device)
    for (row0, mine, _, rd2, mask, _), (_, _, _, rs, _, _) in zip(
            cuda_pbf._pair_blocks(cfg, p4, plan, n),
            cuda_pbf._pair_blocks(cfg, p4, plan, n, split_rd2=True)):
        rows = row0 + torch.arange(mine.shape[0] * mine.shape[1],
                                   device=p4.device).view(mine.shape[:2])
        real = mask & (rows < n)[..., None]
        a, b = (rd2 < h2) & real, (rs < h2) & real
        diff = torch.where(a & b, (rs - rd2).abs(), torch.zeros_like(rd2))
        fp32 += a.sum()
        split += b.sum()
        both += (a & b).sum()
        diff_max = torch.maximum(diff_max, diff.amax())
        diff_sum += diff.double().sum()
    fp32, split, both = int(fp32), int(split), int(both)
    print(f"{head} rd2 of the tensor-core forms (split dot from absolute "
          f"coordinates, |p|^2 <= 3 wall^2 = {3 * cfg.wall ** 2:.2f}) vs the "
          f"FP32 distance, n={n}: {fp32} pairs within h by FP32, {split} by "
          f"the split form; {fp32 - both} only by FP32 and {split - both} "
          f"only by the split form ({100 * (fp32 + split - 2 * both) / fp32:.3f}"
          f" % of the FP32 pairs); |rd2 difference| on the pairs both count "
          f"max {float(diff_max):.3e}, mean {float(diff_sum) / both:.3e} "
          f"(h^2 = {cfg.h2:g})")


def _dense_oracle(cfg, p4, plan, n: int, head: str) -> float:
    """rho of ORACLE_SAMPLES seeded-random particles from the rho kernel
    against a brute-force sum over all n particles (the kernels' clamped
    rd2, the poly6 terms summed in float64), in batches on the card. A
    neighbour the plan missed shows as a step in a particle's error; the
    order of the kernel's float32 sums only as noise, ~1e-6. Raises above
    DENSE_RHO_RTOL; returns the largest relative error."""
    from pdb_sph_tpu_torch.ops import cuda_pbf
    from pdb_sph_tpu_torch.ops.smoothing import EPS

    rho = cuda_pbf.density_rho(cfg, p4, plan, n)[:n, 3]
    gen = torch.Generator(device="cpu").manual_seed(ORACLE_SEED)
    idx = torch.randperm(n, generator=gen)[:ORACLE_SAMPLES].to(p4.device)
    x = p4[:n, :3]
    h2 = torch.tensor(float(cfg.h2), dtype=torch.float32, device=p4.device)
    eps = torch.tensor(EPS, dtype=torch.float32, device=p4.device)
    want = []
    for i in range(0, idx.numel(), ORACLE_BATCH):
        q = x[idx[i:i + ORACLE_BATCH]]
        d = [q[:, None, a] - x[None, :, a] for a in range(3)]
        rd2 = torch.fmax(torch.fmin(d[0] * d[0] + d[1] * d[1] + d[2] * d[2],
                                    h2), eps)
        t = (h2 - rd2).double()
        want.append((t * t * t).sum(dim=1))
    want = torch.cat(want) * cfg.poly6_coeff
    rel = (rho[idx].double() - want).abs() / want
    worst = float(rel.max())
    print(f"{head} sampled dense oracle: rho of {idx.numel()} particles "
          f"(seed {ORACLE_SEED}) from the rho kernel vs a brute-force sum "
          f"over all {n} in float64: max rel err {worst:.3e}, median "
          f"{float(rel.median()):.3e}, {int((rel > 1e-6).sum())} above 1e-6 "
          f"(gate {DENSE_RHO_RTOL:g}); oracle mean rho {float(want.mean()):.2f}")
    if not worst <= DENSE_RHO_RTOL:
        raise AssertionError(f"rho kernel vs the dense oracle: {worst:.3e}")
    return worst


def _masked_rows(plan, n: int, own: int) -> torch.Tensor:
    """The real rows of the own-chunks a plan gives no candidates: on a
    restricted plan, the masked chunks' rows."""
    lens = (plan.ranges[..., 1] - plan.ranges[..., 0]).sum(dim=1)
    return (lens == 0).repeat_interleave(own)[:n]


def _check_masked(name: str, out: torch.Tensor, src: torch.Tensor, plan,
                  n: int, cfg) -> int:
    """Rows of masked chunks, written as JAX's rule has it: the density
    forms lambda from zero sums (1 / relaxation_eps) with the positions
    carried, rho 0, the project forms the row unchanged. Raises on a
    wrong row; returns how many masked rows there are."""
    rows = _masked_rows(plan, n, cfg.geom.own)
    got, was = out[:n][rows], src[:n][rows]
    if name.startswith("density_rho"):
        want = torch.cat([was[:, :3], torch.zeros_like(was[:, 3:])], 1)
    elif name.startswith("density"):
        lam0 = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(
            float(cfg.relaxation_eps), dtype=torch.float32)
        want = torch.cat([was[:, :3],
                          lam0.to(was.device).expand(was.shape[0], 1)], 1)
    else:
        want = was
    if not torch.equal(got, want):
        raise AssertionError(f"{name} wrote masked rows wrongly")
    return int(rows.sum())


def _fp32_kernels(cfg, p4, plan, n: int, step: int, plain_reps: int,
                  plan_p=None, reps: int = REPS, tag: str = "",
                  head: str = "[kernels]",
                  pairs: int | None = None) -> tuple[dict, torch.Tensor]:
    """K1 lambda, K2 and K1 rho against their plain versions on one state:
    errors within the tolerances, two launches bitwise equal, the rows of
    masked chunks as JAX writes them, times beside their bounds (_least_ms
    of `pairs`, _pairs of these rows; None where work.py does not count
    the plan's pairs). K1 runs on `plan`, K2 on `plan_p` (default `plan`).
    Returns ({counter: (max|err|, ms, plain ms or None, bound ms or None)},
    K1's output)."""
    from pdb_sph_tpu_torch.ops import cuda_pbf
    from pdb_sph_tpu_torch.utils.timing import cuda_ms

    plan_p = plan if plan_p is None else plan_p
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
    p_k = cuda_pbf.project_pass(cfg, d_k, plan_p, n, scratch=scratch)
    p_r = cuda_pbf.project_pass_ref(cfg, d_k, plan_p, n)
    pos_err = (p_k[:n, :3] - p_r[:n, :3]).abs()
    pos_max = float(pos_err.max())
    move = float((p_r[:n, :3] - d_k[:n, :3]).abs().max())

    # the diagnostic rho, through K1's kernel with the rho output
    r_k = cuda_pbf.density_rho(cfg, p4, plan, n, scratch=scratch)
    r_r = cuda_pbf.density_rho_ref(cfg, p4, plan, n)
    rho_err = (r_k[:n, 3] - r_r[:n, 3]).abs()
    rho_bad = int((rho_err > RHO_RTOL * r_r[:n, 3].abs()).sum())
    rho_rel = float((rho_err / r_r[:n, 3].abs().clamp_min(1e-30)).max())
    if not torch.equal(r_k[:n, :3], p4[:n, :3]):
        raise AssertionError("rho kernel changed the positions it carries")
    masked = [_check_masked("density_lambda", d_k, p4, plan, n, cfg),
              _check_masked("project", p_k, d_k, plan_p, n, cfg),
              _check_masked("density_rho", r_k, p4, plan, n, cfg)]

    # a second launch of each gives the same bits: the combine is fixed
    again = {
        "density_lambda": (cuda_pbf.density_pass(cfg, p4, plan, n,
                                                 scratch=scratch), d_k),
        "project": (cuda_pbf.project_pass(cfg, d_k, plan_p, n,
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
            lambda: cuda_pbf.project_pass(cfg, d_k, plan_p, n, buf, scratch),
            lambda: cuda_pbf.project_pass_ref(cfg, d_k, plan_p, n, buf)),
        "density_rho": (
            lambda: cuda_pbf.density_rho(cfg, p4, plan, n, buf, scratch),
            lambda: cuda_pbf.density_rho_ref(cfg, p4, plan, n, buf)),
    }
    errs = {"density_lambda": float(lam_err.max()), "project": pos_max,
            "density_rho": float(rho_err.max())}
    mean_c, max_c = _candidates(plan)
    items = int(plan.seg_prefix[-1])
    print(f"{head}{tag} n={n} after {step} steps; candidates/chunk "
          f"mean {mean_c:.1f} max {max_c}; {items} work items of <= "
          f"{int(plan.seg_len)} candidates; masked rows (lambda, project, "
          f"rho) {masked}, written as JAX's rule has it; "
          f"lambda max|err| {float(lam_err.max()):.3e} max rel "
          f"{lam_rel:.3e} (tol {LAMBDA_ATOL:g} + {LAMBDA_RTOL:g}|ref|, "
          f"{lam_bad} outside); positions max|err| {pos_max:.3e} (atol "
          f"{POS_ATOL:g}; largest move {move:.3e}); rho max|err| "
          f"{float(rho_err.max()):.3e} max rel {rho_rel:.3e} (rtol "
          f"{RHO_RTOL:g}, {rho_bad} outside); two launches bitwise equal: "
          f"{'all' if not unequal else 'not ' + ', '.join(unequal)}")
    out = {}
    for name, (kernel, plain) in runs.items():
        k_ms = cuda_ms(kernel, reps)
        r_ms = cuda_ms(plain, plain_reps) if plain_reps else None
        plain_txt = (f"plain {r_ms:.4f} ms (median of {plain_reps})"
                     if r_ms is not None else "plain not timed here")
        bound = _least_ms(name, pairs)
        print(f"{head}{tag} {KERNELS[name][0]} at step {step}: kernel "
              f"{k_ms:.4f} ms (median of {reps}, CUDA events), {plain_txt}"
              + _least_txt(bound, pairs, k_ms))
        out[name] = (errs[name], k_ms, r_ms, bound)
    if lam_bad or not pos_max <= POS_ATOL or rho_bad:
        raise AssertionError(f"a kernel disagrees with its plain version at "
                             f"step {step}{tag}")
    if unequal:
        raise AssertionError(f"two launches differ at step {step}{tag}: "
                             f"{unequal}")
    return out, d_k


def phase_kernels(device, n: int = N_MAIN) -> tuple[dict, object]:
    """Each kernel against its plain version on the dam break at steps 60
    and 480. Returns ({counter: (max|err|, ms, plain ms, bound ms, ms at
    step 480, bound ms at step 480)}, the state at step 60)."""
    import pdb_sph_tpu_torch as pbf

    cfg = pbf.default_config(n=n)
    g = cfg.geom
    print(f"[kernels] tensor-core layout at own {g.own}: "
          f"{g.tc_m_tiles} m16 tile(s) a warp, {g.tc_col_groups} warp(s) "
          f"splitting each stage's candidates, {g.tc_smem_bytes} bytes of "
          f"shared memory (kProjMma)")
    state = pbf.spawn(cfg, "dam_break", seed=0, device=device)
    state = pbf.make_rollout(cfg, "window", SETTLE_STEPS, device=device)(state)
    state60 = state
    p4, plan = _sorted_p4(cfg, state.x)
    _rd2_census(cfg, p4, plan, n, "[kernels]")
    pairs = _pairs(cfg, p4, n)
    mid, d_k = _fp32_kernels(cfg, p4, plan, n, SETTLE_STEPS, PLAIN_REPS,
                             pairs=pairs)
    mid.update(_tc_kernels(cfg, p4, d_k, plan, n, SETTLE_STEPS,
                           TC_PLAIN_REPS, pairs=pairs))
    state = pbf.make_rollout(cfg, "window", SETTLED_STEP - SETTLE_STEPS,
                             device=device)(state)
    p4, plan = _sorted_p4(cfg, state.x)
    pairs = _pairs(cfg, p4, n)
    settled, d_k = _fp32_kernels(cfg, p4, plan, n, SETTLED_STEP, 0,
                                 pairs=pairs)
    settled.update(_tc_kernels(cfg, p4, d_k, plan, n, SETTLED_STEP, 0,
                               pairs=pairs))
    return {k: (max(v[0], settled[k][0]), *v[1:], settled[k][1],
                settled[k][3]) for k, v in mid.items()}, state60


def _tc_lambda_atol(wall: float) -> float:
    """TC_LAMBDA_ATOL, reckoned above from the ulp of |p|^2 <= 12 at wall
    2, at a box of `wall`: times the ulp of 3 wall^2 over the ulp of 12 (1
    at wall 2, 8 at the 1M rows' 4.64)."""
    return TC_LAMBDA_ATOL * math.ulp(3.0 * wall * wall) / math.ulp(12.0)


def _proj_witness(cfg, src, plan, n: int, got, want, err) -> dict:
    """The second witness for a project form with mxu_proj whose kernel
    lies beyond TC_POS_ATOL of its FP32 plain version: the plain version
    evaluated in float64 (the same bf16 splits, every sum without float32
    rounding). `got`, `want` (n, 3) are the kernel's and the FP32 plain
    version's positions, `err` their difference. Returns the largest
    distance of each from the float64 form, over every row and over the
    rows beyond TC_POS_ATOL, the pairs of those rows (and of all rows)
    that the float32 split rd2 puts on the other side of h^2 than the
    float64 one does, and `ok`: the kernel no farther from the float64
    form than the plain version, plus TC_POS_ATOL."""
    from pdb_sph_tpu_torch.ops import cuda_pbf

    w64 = cuda_pbf.project_pass_ref(cfg, src.double(), plan, n)[:n, :3]
    dk = (got.double() - w64).abs().amax(-1)
    dp = (want.double() - w64).abs().amax(-1)
    beyond = (err > TC_POS_ATOL).any(-1)
    flips = torch.zeros(n, dtype=torch.int64, device=src.device)
    h2 = float(cuda_pbf.f32(cfg.h2))
    for (row0, _, _, rd2, mask, _), (_, _, _, rd64, _, _) in zip(
            cuda_pbf._pair_blocks(cfg, src, plan, n, split_rd2=True),
            cuda_pbf._pair_blocks(cfg, src.double(), plan, n,
                                  split_rd2=True)):
        per_row = (((rd2 < h2) != (rd64 < h2)) & mask).sum(-1).reshape(-1)
        rows = per_row[:max(0, min(n - row0, per_row.numel()))]
        flips[row0:row0 + rows.numel()] = rows
    out = {"plain_vs_f64": float(dp.max()), "kernel_vs_f64": float(dk.max()),
           "rows_beyond": int(beyond.sum()),
           "plain_vs_f64_beyond": float(dp[beyond].max()) if beyond.any()
           else 0.0,
           "kernel_vs_f64_beyond": float(dk[beyond].max()) if beyond.any()
           else 0.0,
           "flips_beyond": int(flips[beyond].sum()),
           "flips": int(flips.sum())}
    out["ok"] = out["kernel_vs_f64"] <= out["plain_vs_f64"] + TC_POS_ATOL
    return out


def _tc_kernels(cfg, p4, d_fp, plan, n: int, step: int,
                plain_reps: int, plan_p=None, reps: int = REPS,
                tag: str = "", head: str = "[kernels]",
                pairs: int | None = None,
                witnesses: dict | None = None) -> dict:
    """The six tensor-core instantiations against their plain versions on
    one state; the project forms take the FP32 kernel's lambda, as the FP32
    project kernel does, and run on `plan_p` (default `plan`). Each
    launched twice for bitwise-equal output, the scratch's counters back at
    0 after, the rows of masked chunks as JAX writes them. `pairs` as in
    _fp32_kernels. With `witnesses` (a dict it fills by counter), a project
    form with mxu_proj also gets _proj_witness, which decides its rows
    beyond TC_POS_ATOL. Returns {counter: (max|err|, ms, plain ms or None,
    bound ms or None)}."""
    import dataclasses

    from pdb_sph_tpu_torch.ops import cuda_pbf
    from pdb_sph_tpu_torch.utils.timing import cuda_ms

    plan_p = plan if plan_p is None else plan_p
    fp32 = {"density": cuda_pbf.density_pass_ref(cfg, p4, plan, n)[:n, 3],
            "project": cuda_pbf.project_pass_ref(cfg, d_fp, plan_p,
                                                 n)[:n, :3]}
    scratch = cuda_pbf.alloc_scratch(cfg, p4.shape[0], p4.device)
    buf = torch.empty_like(p4)
    out, bad = {}, []
    for name, switches in TC_FORMS.items():
        tcfg = dataclasses.replace(
            cfg, geom=dataclasses.replace(cfg.geom, **switches))
        density = name.startswith("density")
        src = p4 if density else d_fp
        kplan = plan if density else plan_p
        wrapper = cuda_pbf.density_pass if density else cuda_pbf.project_pass
        plain = (cuda_pbf.density_pass_ref if density
                 else cuda_pbf.project_pass_ref)
        cuda_pbf.reset_launches()
        got = wrapper(tcfg, src, kplan, n, scratch=scratch)
        again = wrapper(tcfg, src, kplan, n, scratch=scratch)
        torch.cuda.synchronize()
        launches = cuda_pbf.LAUNCHES[name]
        equal = torch.equal(got, again)
        counters = int(scratch.counters.abs().sum())
        want = plain(tcfg, src, kplan, n)
        cols = slice(3, 4) if density else slice(0, 3)
        kept = slice(0, 3) if density else slice(3, 4)
        if not torch.equal(got[:n, kept], src[:n, kept]):
            raise AssertionError(f"{name} changed the columns it carries")
        masked = _check_masked(name, got, src, kplan, n, cfg)
        g, w = got[:n, cols], want[:n, cols]
        err = (g - w).abs()
        form = float((w.squeeze(-1) - fp32["density" if density
                                           else "project"]).abs().max())
        if density:
            atol = _tc_lambda_atol(cfg.wall)
            n_bad = int((err > atol + TC_LAMBDA_RTOL * w.abs()).sum())
            tol = f"{atol:g} + {TC_LAMBDA_RTOL:g}|ref|"
            if atol != TC_LAMBDA_ATOL:
                wall2 = int((err > TC_LAMBDA_ATOL
                             + TC_LAMBDA_RTOL * w.abs()).sum())
                tol += f"; {wall2} outside the wall-2 atol {TC_LAMBDA_ATOL:g}"
        else:
            n_bad = int((err > TC_POS_ATOL).sum())
            tol = f"atol {TC_POS_ATOL:g}"
            if witnesses is not None and switches.get("mxu_proj"):
                wit = witnesses[name] = _proj_witness(tcfg, src, kplan, n,
                                                      g, w, err)
                tol += (f"; float64 witness: kernel {wit['kernel_vs_f64']:.3e}"
                        f" and plain {wit['plain_vs_f64']:.3e} from it, on "
                        f"the {wit['rows_beyond']} rows beyond the atol "
                        f"{wit['kernel_vs_f64_beyond']:.3e} and "
                        f"{wit['plain_vs_f64_beyond']:.3e}; pairs across h "
                        f"between float32 and float64 rd2 "
                        f"{wit['flips_beyond']} on those rows, "
                        f"{wit['flips']} in all; kernel within plain + "
                        f"{TC_POS_ATOL:g} of it: {wit['ok']}")
                if wit["ok"]:
                    n_bad = 0
        k_ms = cuda_ms(lambda: wrapper(tcfg, src, kplan, n, buf, scratch),
                       reps)
        r_ms = (cuda_ms(lambda: plain(tcfg, src, kplan, n, buf), plain_reps)
                if plain_reps else None)
        plain_txt = (f"plain {r_ms:.4f} ms (median of {plain_reps})"
                     if r_ms is not None else "plain not timed here")
        bound = _least_ms(name, pairs)
        print(f"{head}{tag} {KERNELS[name][0]} at step {step}: max|err| "
              f"{float(err.max()):.3e} vs plain (tol {tol}, {n_bad} "
              f"outside); plain form vs plain FP32 form max|diff| "
              f"{form:.3e}; kernel {k_ms:.4f} ms (median of {reps}, CUDA "
              f"events), {plain_txt}{_least_txt(bound, pairs, k_ms)}; "
              f"checked launches {launches}, two launches bitwise equal "
              f"{equal}, counters after {counters}, masked rows {masked}")
        other = switches.get("mxu_rd2") or switches.get("mxu_proj")
        if n_bad or launches != 2 or not equal or counters \
                or (other and TC_SEPARATION * float(err.max()) > form):
            bad.append(name)
        out[name] = (float(err.max()), k_ms, r_ms, bound)
    if bad:
        raise AssertionError(f"tensor-core kernels disagree with their plain "
                             f"versions, differ between two launches, left "
                             f"counters nonzero or did not launch at step "
                             f"{step}{tag}: {bad}")
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


def phase_main(device, card: str, geom=None, n: int = N_MAIN,
               steps: int = ROLLOUT_STEPS) -> dict:
    """The rollout in `geom` (None: the default geometry); its launches.
    Prints its steps/s in every geometry but the default one, whose rate
    is the cell dam80k.rollout's."""
    import pdb_sph_tpu_torch as pbf
    from pdb_sph_tpu_torch.ops import cuda_pbf
    from pdb_sph_tpu_torch.utils.timing import fence

    cfg = pbf.default_config(n=n, **({} if geom is None else {"geom": geom}))
    rollout = pbf.make_rollout(cfg, "window", steps, with_stats=True,
                               device=device)
    scratch = rollout.stepper.scratch
    ptrs = [t.data_ptr() for t in scratch]
    state = pbf.spawn(cfg, "dam_break", seed=0, device=device)
    state, settle_stats = rollout(state)

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
    rate = ("" if geom is None else
            f" in {secs:.4f} s = {steps / secs:.2f} steps/s on {card}")
    print(f"[main] dam_break n={n} {_geom_name(cfg.geom)}: {steps} steps"
          f"{rate}; stats {stats.tolist()} (settle {settle_stats.tolist()});"
          f" finite {finite}; escaped {escaped}; launches {launches}")
    if not finite or escaped or stats.tolist() != [0, 0, 0] \
            or settle_stats.tolist() != [0, 0, 0]:
        raise AssertionError("main path state or stats are wrong")
    _check_launches(f"[main] {_geom_name(cfg.geom)}", launches,
                    _launches(steps, geom=cfg.geom))

    if rollout.stepper.scratch is not scratch \
            or [t.data_ptr() for t in scratch] != ptrs \
            or scratch.counters.any():
        raise AssertionError("the rollout replaced the Stepper's scratch or "
                             "left its counters nonzero")
    return launches


def _eager_steps(stepper, state, steps: int):
    """`steps` eager Stepper.step calls from `state`, stats summed: the
    loop a Rollout ran before its graph."""
    total = torch.zeros((3,), dtype=torch.int32, device=state.x.device)
    for _ in range(steps):
        state, stats = stepper.step(state, with_stats=True)
        total += stats
    return state, total


def phase_graph(device, geom=None, n: int = N_MAIN) -> None:
    """The graph rollout against the eager Stepper loop in `geom` (None:
    the default geometry), from one state settled ROLLOUT_STEPS steps:
    ROLLOUT_STEPS steps of each bitwise equal (x, v, ids, step, stats),
    the graph's launches exactly the geometry's; SYNC_STEPS eager steps
    and SYNC_STEPS graph steps under torch.cuda.set_sync_debug_mode
    ("error")."""
    import pdb_sph_tpu_torch as pbf
    from pdb_sph_tpu_torch.ops import cuda_pbf
    from pdb_sph_tpu_torch.utils.timing import fence

    cfg = pbf.default_config(n=n, **({} if geom is None else {"geom": geom}))
    name = _geom_name(cfg.geom)
    rollout = pbf.make_rollout(cfg, "window", ROLLOUT_STEPS, with_stats=True,
                               device=device)
    stepper = rollout.stepper
    state, _ = rollout(pbf.spawn(cfg, "dam_break", seed=0, device=device))

    cuda_pbf.reset_launches()
    g, g_stats = rollout(state)
    fence(device)
    launches = dict(cuda_pbf.LAUNCHES)
    e, e_stats = _eager_steps(stepper, state, ROLLOUT_STEPS)
    equal = {f: torch.equal(a, b) for f, a, b in zip(g._fields, g, e)}
    equal["stats"] = torch.equal(g_stats, e_stats)

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        s, _ = _eager_steps(stepper, state, SYNC_STEPS)
        rollout(s, SYNC_STEPS)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()

    print(f"[graph] {name} n={n}: {ROLLOUT_STEPS} graph steps vs "
          f"{ROLLOUT_STEPS} eager Stepper.step steps from step "
          f"{int(state.step)}: bitwise equal {equal}; graph launches "
          f"{_nonzero(launches)}; {SYNC_STEPS} eager and {SYNC_STEPS} graph "
          f"steps under set_sync_debug_mode('error') without a sync")
    if not all(equal.values()):
        raise AssertionError(f"{name}: the graph left the eager loop's bits: "
                             f"{equal}")
    _check_launches(f"[graph] {name}", launches,
                    _launches(ROLLOUT_STEPS, geom=cfg.geom))


def _geom_name(geom) -> str:
    from pdb_sph_tpu_torch.geometry import KernelGeometry

    on = [k for k in ALL_SWITCHES if getattr(geom, k)]
    if geom.seg != KernelGeometry.seg:
        on.append(f"seg={geom.seg}")
    return "+".join(on) if on else "default geometry"


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def _launches(steps: int, rho: int = 0, geom=None, ranks: int = 1) -> dict:
    """The kernel launches of `steps` steps in `geom` (None: the default
    geometry) on a rank of `ranks`, by LAUNCHES' keys, the ones it never
    makes left out: its density and project kernels SOLVER_ITERS times a
    step, finalize once a step, the rho kernel `rho` times (once a
    diagnostic record), the plan's two kernels once a step and once a
    diagnostic record, and at ranks > 1 the work table's twice more a step
    (the density and the project pass's restricted plans). A graph's
    eager warm-up step counts among the steps (WARMUP_STEPS). The one
    place that says what a step launches."""
    from pdb_sph_tpu_torch.geometry import KernelGeometry

    geom = geom or KernelGeometry()
    density = ("density_tc" + "_rd2" * geom.mxu_rd2 + "_sum" * geom.mxu_sum
               if geom.mxu_rd2 or geom.mxu_sum else "density_lambda")
    project = ("project_tc" + "_proj" * geom.mxu_proj
               + "_sum" * geom.mxu_sum
               if geom.mxu_proj or geom.mxu_sum else "project")
    return _nonzero({density: SOLVER_ITERS * steps,
                     project: SOLVER_ITERS * steps, "finalize": steps,
                     "density_rho": rho, "plan": steps + rho,
                     "work_table": steps + rho + 2 * steps * (ranks > 1)})


def _check_launches(tag: str, launches: dict, want: dict) -> None:
    """Raise unless `launches` are `want` (_launches) kernel by kernel,
    and no other kernel launched."""
    if _nonzero(launches) != want:
        raise AssertionError(f"{tag}: launches {_nonzero(launches)}, "
                             f"expected {want}")


def phase_settle(device, geom=None) -> dict:
    """The settle gate on the card: the precision check of the kernels, in
    `geom` (None: the default geometry). Returns its launches."""
    from pdb_sph_tpu_torch.core import settle
    from pdb_sph_tpu_torch.geometry import KernelGeometry
    from pdb_sph_tpu_torch.ops import cuda_pbf

    cuda_pbf.reset_launches()
    r = settle.settle_check(device, n=SETTLE_N, steps=SETTLE_GATE_STEPS,
                            geom=geom)
    launches = dict(cuda_pbf.LAUNCHES)
    name = _geom_name(geom or KernelGeometry())
    for line in settle.format_result(r).splitlines():
        print(f"[settle] {name}: {line}")
    print(f"[settle] {name}: {SETTLE_GATE_STEPS / r['seconds']:.2f} steps/s; "
          f"launches {launches}")
    # the gate's one diagnostic record after its rollout
    _check_launches(f"[settle] {name}", launches,
                    _launches(SETTLE_GATE_STEPS + WARMUP_STEPS, rho=1,
                              geom=geom))
    if not r["ok"]:
        raise AssertionError(f"SETTLE CHECK ({name}): FAIL")
    return launches


@contextlib.contextmanager
def _counting(owner, attr: str):
    """Count the calls of `owner.attr` (a function or a method) inside the
    context; yields a one-element list that holds the count."""
    real, calls = getattr(owner, attr), [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    setattr(owner, attr, counted)
    try:
        yield calls
    finally:
        setattr(owner, attr, real)


def _cli_run(argv: list[str], metrics: str, geom=None,
             head: str = "[cli]") -> tuple[list[dict], dict]:
    """One in-process run of the runner; (its JSONL records, the kernel
    launches it made). Raises unless it exits 0, launched the kernels of
    `geom` (_launches; None: the default geometry) with its diagnostics'
    and no other, captured one CUDA graph and allocated one pair-kernel
    scratch (its diagnostics take the rollout's)."""
    from pdb_sph_tpu_torch import cli
    from pdb_sph_tpu_torch.ops import cuda_pbf

    cuda_pbf.reset_launches()
    with _counting(cuda_pbf, "alloc_scratch") as scratches, \
            _counting(torch.cuda.CUDAGraph, "capture_begin") as captures:
        rc = cli.main(argv + ["--device", "cuda", "--metrics", metrics])
    launches = dict(cuda_pbf.LAUNCHES)
    if rc != 0:
        raise AssertionError(f"cli exited {rc}: {argv}")
    if scratches != [1] or captures != [1]:
        raise AssertionError(f"{argv}: {captures[0]} graph captures and "
                             f"{scratches[0]} scratch allocations, not 1 "
                             "each")
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
    print(f"{head} {' '.join(argv)}: rc 0, last step {prog[-1]['step']}, "
          f"{records[-1]['particle_steps_per_sec']:.1f} particle-steps/s "
          f"({records[-1]['steps_per_sec']:.2f} steps/s, "
          f"{records[-1]['wall_seconds']:.3f} s, frames and GIF included; "
          f"median chunk {chunk_rate:.2f} steps/s); {len(diag)} diagnostic "
          f"records (last: mean rho {last.get('mean_density', 0):.1f}, max "
          f"err {last.get('max_density_err', 0):.4f}, maxv "
          f"{last.get('max_speed', 0):.4f}); one graph capture, one "
          f"pair-kernel scratch; launches {launches}")
    want = set(_launches(1, rho=1, geom=geom))
    if set(_nonzero(launches)) != want:
        raise AssertionError(f"{argv}: launches {_nonzero(launches)}, not "
                             f"of the kernels {sorted(want)}")
    return records, launches


def phase_cli(device, out_dir: str) -> tuple[int, dict]:
    """The runner on the card; returns the rho kernel's launches and those
    of the run with the tensor-core switches in the environment."""
    import pdb_sph_tpu_torch as pbf
    from pdb_sph_tpu_torch.geometry import KernelGeometry
    from pdb_sph_tpu_torch.io import checkpoint

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

    # the tensor-core forms through the environment, as a user sets them
    tc_ck = os.path.join(out_dir, "dam_tc.npz")
    saved = {k: os.environ.get(k) for k in MXU_ENV}
    os.environ.update({k: "1" for k in MXU_ENV})
    try:
        _, l_tc = _cli_run(
            ["--scene", "dam_break", "--n", str(N_MAIN), "--steps",
             str(CLI_TC_STEPS), *every, "--checkpoint", tc_ck],
            os.path.join(out_dir, "dam_tc.jsonl"),
            geom=KernelGeometry(**ALL_SWITCHES))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    cfg, _ = checkpoint.load(tc_ck, device)
    print(f"[cli] PBF_MXU_SUM/RD2/PROJ=1: checkpoint geometry {cfg.geom}")
    if not all(getattr(cfg.geom, k) for k in ALL_SWITCHES):
        raise AssertionError(f"checkpoint lost the switches: {cfg.geom}")
    rho = l_dam["density_rho"] + l_res["density_rho"] + l_bl["density_rho"]
    return rho + l_tc["density_rho"], l_tc


def phase_c2(device, state60, n: int = N_MAIN) -> dict:
    """Every FP32 and tensor-core form at own 32, 128 and 256 against its
    plain version on the step-60 state (two launches bitwise equal,
    counters back at 0), and a C2_STEPS-step rollout at each whose stats
    read [0, 0, 0]. Returns {own: {counter: ms}}."""
    import pdb_sph_tpu_torch as pbf
    from pdb_sph_tpu_torch.geometry import KernelGeometry
    from pdb_sph_tpu_torch.ops import cuda_pbf

    out = {}
    for own in C2_OWNS:
        cfg = pbf.default_config(n=n, geom=KernelGeometry(own=own))
        tag = f" own {own}:"
        p4, plan = _sorted_p4(cfg, state60.x)
        pairs = _pairs(cfg, p4, n)
        fp, d_k = _fp32_kernels(cfg, p4, plan, n, SETTLE_STEPS, 0,
                                reps=C2_REPS, tag=tag, pairs=pairs)
        fp.update(_tc_kernels(cfg, p4, d_k, plan, n, SETTLE_STEPS, 0,
                              reps=C2_REPS, tag=tag, pairs=pairs))
        rollout = pbf.make_rollout(cfg, "window", C2_STEPS, with_stats=True,
                                   device=device)
        cuda_pbf.reset_launches()
        st, stats = rollout(pbf.spawn(cfg, "dam_break", seed=0,
                                      device=device))
        launches = {k: v for k, v in cuda_pbf.LAUNCHES.items() if v}
        finite = bool(torch.isfinite(st.x).all())
        print(f"[c2] own {own}: {C2_STEPS}-step rollout stats "
              f"{stats.tolist()}, finite {finite}, launches {launches}")
        if stats.tolist() != [0, 0, 0] or not finite:
            raise AssertionError(f"own {own}: rollout stats are wrong")
        _check_launches(f"[c2] own {own}", launches,
                        _launches(C2_STEPS + WARMUP_STEPS, geom=cfg.geom))
        out[own] = {k: v[1] for k, v in fp.items()}
    return out


def phase_restricted(device, state60, cfg=None, D: int = 2, rank: int = 0,
                     head: str = "[kernels]") -> dict:
    """The nine forms on restricted plans, as rank `rank` of D sees them
    (default: rank 0 of D = 2 on the flagship dam break): the sorted
    step-60 state of `cfg` with the chunks outside the rank's key band
    masked (own keys plus one ring for the density forms, own keys for the
    project forms). Returns {counter: ms}: pbfbench/work.py counts no pairs
    of a restricted plan, so no bound."""
    import pdb_sph_tpu_torch as pbf
    from pdb_sph_tpu_torch.core.step import sort_cells
    from pdb_sph_tpu_torch.ops import cuda_pbf, hashgrid
    from pdb_sph_tpu_torch.parallel import sharded

    cfg = cfg or pbf.default_config(n=N_MAIN)
    n = cfg.n
    b = sharded.initial_bounds(cfg, D, state=state60)
    p4, plan = _sorted_p4(cfg, state60.x)
    sorted_cid, _ = sort_cells(cfg, hashgrid.cell_ids(cfg, state60.x))
    keep_d, keep_p = sharded.chunk_keep(cfg, sorted_cid, int(b[rank]),
                                        int(b[rank + 1]))
    plan_d = cuda_pbf.restrict_plan(cfg, plan, keep_d)
    plan_p = cuda_pbf.restrict_plan(cfg, plan, keep_p)
    bad = _check_plan(cfg, sorted_cid, (keep_d, keep_p),
                      f"rank {rank} of {D}")
    if bad:
        raise AssertionError(f"{head} restricted plans: {bad}")
    print(f"{head} restricted: rank {rank} of {D}, n={n} wall={cfg.wall} "
          f"grid_width {cfg.grid_width}, zx-keys [{b[rank]}, "
          f"{b[rank + 1]}): {int(keep_d.sum())} of {keep_d.numel()} chunks "
          f"kept for the density forms, {int(keep_p.sum())} for the project "
          "forms; the plan and both restricted plans bitwise the plain "
          "plan's")
    tag = " restricted:"
    fp, d_k = _fp32_kernels(cfg, p4, plan_d, n, SETTLE_STEPS, 0,
                            plan_p=plan_p, tag=tag, head=head)
    fp.update(_tc_kernels(cfg, p4, d_k, plan_d, n, SETTLE_STEPS, 0,
                          plan_p=plan_p, tag=tag, head=head))
    return {k: v[1] for k, v in fp.items()}


def phase_fastpath(device, card: str, n: int = N_MAIN, wall: float = 2.0,
                   head: str = "[fastpath]") -> dict:
    """The one-rank sharded path (D = 1, its fast path) at the flagship
    size: SHARD_STEPS steps bit for bit the Stepper's; then a
    SHARD_ROLLOUT-step rollout (its first call: the warm-up step, the
    capture and the replays) with stats [n, 0, 0, 0, 0], bit for bit the
    eager ShardedStepper loop aggregated as the JAX rollout does, and the
    graph's steps/s on a second call; returns the rollout's launches."""
    import pdb_sph_tpu_torch as pbf
    from pdb_sph_tpu_torch.ops import cuda_pbf
    from pdb_sph_tpu_torch.parallel import sharded
    from pdb_sph_tpu_torch.utils.timing import fence

    cfg = pbf.default_config(n=n, wall=wall)
    st = pbf.spawn(cfg, "dam_break", seed=0, device=device)
    pcfg = sharded.ParallelConfig.create(cfg, 1, state=st)
    # one rank holds n rounded up to 128 slots (1,000,064 at 1M); a step
    # sorts the inactive ones after every particle
    if pcfg.capacity != -(-n // 128) * 128:
        raise AssertionError(f"one rank's capacity {pcfg.capacity}, n {n}")
    sst = sharded.distribute(cfg, pcfg, st, device=device)
    step = sharded.make_sharded_step(cfg, pcfg, device=device)
    stepper = pbf.make_step(cfg, "window", device=device)
    ref = st
    for _ in range(SHARD_STEPS):
        sst, _, _ = step(sst)
        ref = stepper(ref)
        if not (torch.equal(sst.x[:n], ref.x) and torch.equal(sst.v[:n], ref.v)
                and torch.equal(sst.ids[:n], ref.ids)
                and bool((sst.ids[n:] < 0).all())):
            raise AssertionError("the one-rank path left the Stepper's bits")
    rollout = sharded.make_sharded_rollout(cfg, pcfg, None, "window",
                                           SHARD_ROLLOUT, device)
    cuda_pbf.reset_launches()
    got, stats, diag = rollout(sst)
    launches = dict(cuda_pbf.LAUNCHES)

    e, e_stats, e_diag = sst, [], []
    for _ in range(SHARD_ROLLOUT):
        e, s, dg = step.step(e)
        e_stats.append(s)
        e_diag.append(dg)
    want_stats = torch.stack(e_stats).sum(0)
    want_stats[0] = e_stats[-1][0]
    want_diag = torch.stack(e_diag).amax(0)
    same = (all(torch.equal(a, b) for a, b in zip(got, e))
            and torch.equal(stats[0], want_stats)
            and torch.equal(diag[0], want_diag))
    fence(device)
    t0 = time.perf_counter()
    rollout(sst)
    fence(device)
    graph_s = time.perf_counter() - t0

    d = sharded.make_sharded_diagnostics(
        cfg, pcfg, scratch=rollout.stepper.work.scratch)(got)[0].tolist()
    print(f"{head} D=1 n={n} wall={wall}: {SHARD_STEPS} steps bitwise equal "
          f"to the Stepper; {SHARD_ROLLOUT} more steps: graph ShardedRollout "
          f"{SHARD_ROLLOUT / graph_s:.2f} steps/s on {card} (a second call); "
          f"x, v, ids, bounds, stats and diag bitwise the eager "
          f"ShardedStepper loop: {same}; stats {stats.tolist()}, diag "
          f"{diag.tolist()}; mean rho {d[0]:.1f} max err {d[1]:.4f}; "
          f"launches {_nonzero(launches)}")
    if not same:
        raise AssertionError("the one-rank graph rollout left the eager "
                             "ShardedStepper loop's bits")
    # diag: [max speed, escaped, nonfinite], each the most of any step
    if stats.tolist() != [[n, 0, 0, 0, 0]] or diag[0, 1:].any():
        raise AssertionError("one-rank rollout stats are wrong")
    _check_launches(f"{head} D=1", launches,
                    _launches(SHARD_ROLLOUT + WARMUP_STEPS, geom=cfg.geom))
    return launches


def _population(x, ref) -> tuple[float, float]:
    """(max |dx|, share of coordinates off by more than POP_TOL)."""
    dev = (x - ref).abs()
    return float(dev.max()), float((dev > POP_TOL).float().mean())


def _stepper_refs(device, cfg, marks, keep: int | None = None):
    """The single-device Stepper's reference at each of `marks`: the
    positions in id order and the diagnostics' mean and max density; and a
    copy of the state at step `keep` (None when `keep` is None)."""
    import pdb_sph_tpu_torch as pbf

    stepper = pbf.make_step(cfg, "window", device=device)
    ref, refs, kept = pbf.spawn(cfg, "dam_break", seed=0, device=device), \
        {}, None
    for i in range(1, marks[-1] + 1):
        ref = stepper(ref)
        if i == keep:
            kept = type(ref)(*(t.clone() if torch.is_tensor(t) else t
                               for t in ref))
        if i in marks:
            d = pbf.diagnostics_fn(cfg, ref, stepper.scratch)
            refs[i] = (_unsorted_x(ref).cpu(), float(d.mean_density),
                       float(d.max_density_err))
    return refs, kept


def phase_two_ranks(device, card: str, cfg=None, D: int = 2,
                    comm: str = "gloo", devices=None, refs=None,
                    head: str = "[ranks]", compact_steps: int = 0):
    """D ranks through launch.rollout_ranks, one rollout a rank, each with
    its kernels on restricted plans: by default two gloo ranks sharing the
    card at the flagship size, the exchange staged through pinned host
    memory (an eager loop); with comm "nccl" and a card a rank in
    `devices`, NCCL ranks whose rollout is a CUDA graph. Against the
    single-device Stepper (`refs` of _stepper_refs, made here when None):
    the first chunk's SHARD_STEPS steps at the parity tolerances; the
    population discriminator of __graft_entry__.py at its horizon (step
    SHARD_STEPS + POP_STEPS), the last check of positions, since past it
    the order of the sums alone spreads every trajectory; and after each
    chunk, up to the end of the SHARD_ROLLOUT-step rollout, the ranks'
    density diagnostics (K1 rho over each rank's particles and ghosts):
    their mean against the single device's diagnostics_fn. With
    `compact_steps`, rollout_ranks then re-tiers (collect,
    ParallelConfig.compact, distribute, a new rollout and graph) and runs
    that many steps more on the compact tier, held by the density at its
    end (`refs` must reach that step). Stats: no overflow, every particle,
    nothing escaped, no NaN, in every chunk. Returns (the ranks' summed
    launches, the collected state at the end of RANK_CHUNKS)."""
    import pdb_sph_tpu_torch as pbf
    from pdb_sph_tpu_torch.parallel import launch, sharded
    from pdb_sph_tpu_torch.parallel.comm import Group

    cfg = cfg or pbf.default_config(n=N_MAIN)
    n = cfg.n
    devices = list(devices or [str(device)] * D)
    chunks, marks = list(RANK_CHUNKS), RANK_MARKS
    retier = None
    if compact_steps:
        retier = len(chunks)
        chunks.append(compact_steps)
        marks = (*marks, marks[-1] + compact_steps)
    if refs is None:
        refs, _ = _stepper_refs(device, cfg, marks)
    st = pbf.spawn(cfg, "dam_break", seed=0, device=device)
    pcfg = sharded.ParallelConfig.create(cfg, D, state=st)
    # a graph's first call adds its eager warm-up step, on each tier
    warm = WARMUP_STEPS * sharded.captures(torch.device(devices[0]),
                                           Group(0, D, comm))
    warm_steps = warm * (1 + bool(compact_steps))
    got, ranks = launch.rollout_ranks(
        cfg, st, D, chunks, "window", devices=devices, comm=comm,
        timeout_s=RANKS_TIMEOUT_S, retier=retier)
    err3 = float((got[0][0].x - refs[marks[0]][0]).abs().max())
    pop = _population(got[1][0].x, refs[marks[1]][0])
    dens = []
    for (_, s, _, _, dg, _), m in zip(got, marks):
        w = s[:, 0].double()
        dens.append((m, float((dg[:, 0].double() * w).sum() / w.sum()),
                     float(dg[:, 1].max()), refs[m][1], refs[m][2]))
    launches = {k: sum(r[k] for r in ranks) for k in ranks[0]}
    where = (f"sharing {card}" if len(set(devices)) == 1
             else f"one card each, {card}")
    tier = ""
    if compact_steps:
        compact = sharded.ParallelConfig.compact(cfg, D, state=got[2][0],
                                                 prior=pcfg)
        tier = (f"; then the re-tier at step {marks[-2]} to the compact "
                f"tier, capacities "
                f"{[compact.capacity, compact.mig_capacity, compact.ghost_capacity]}"
                f", and {compact_steps} steps on it")
    print(f"{head} D={D} {comm} ranks {where}, n={n} wall={cfg.wall} "
          f"grid_width {cfg.grid_width}, capacities (slots, migration, "
          f"ghosts) {[pcfg.capacity, pcfg.mig_capacity, pcfg.ghost_capacity]}"
          f": step {marks[0]} "
          f"max|dx| vs Stepper {err3:.3e} (rtol {SHARD_RTOL:g}, atol "
          f"{SHARD_ATOL:g}); step {marks[1]} population vs Stepper: max dev "
          f"{pop[0]:.3e} (< {POP_MAX_DEV:g}), {100 * pop[1]:.2f} % of "
          f"coordinates off by > {POP_TOL:g} (< {100 * POP_FRAC:g} %); "
          "density diagnostics (mean rho, max |rho/rho0 - 1|) of the ranks "
          "vs the Stepper's: "
          + "; ".join(f"step {m} {a:.2f} vs {b:.2f}, {e:.4f} vs {f:.4f}"
                      for m, a, e, b, f in dens)
          + f" (the means within {100 * DENS_MEAN_RTOL:g} %); stats by "
          f"chunk {[g[1].tolist() for g in got]}; launches a rank "
          f"{[_nonzero(r) for r in ranks]}{tier}")
    torch.testing.assert_close(got[0][0].x, refs[marks[0]][0],
                               rtol=SHARD_RTOL, atol=SHARD_ATOL)
    for _, s, d, _, dg, _ in got:
        if (s[:, 1:].sum() or int(s[:, 0].sum()) != n or d[:, 1:].sum()
                or dg[:, 4].sum()):
            raise AssertionError(f"{head} D={D} stats are wrong: "
                                 f"{s.tolist()}, {d.tolist()}, {dg.tolist()}")
    if not (pop[0] < POP_MAX_DEV and pop[1] < POP_FRAC):
        raise AssertionError(f"{head} D={D}: population differs from the "
                             f"single device at step {marks[1]}")
    for m, a, _, b, _ in dens:
        if not abs(a - b) <= DENS_MEAN_RTOL * b:
            raise AssertionError(f"{head} D={D}: mean density at step {m} "
                                 "differs from the single device's")
    for r in ranks:
        _check_launches(f"{head} D={D}", r,
                        _launches(marks[-1] + warm_steps, rho=len(chunks),
                                  ranks=D))
    return launches, got[len(RANK_CHUNKS) - 1][0]


def _cell_table(cfg, x: torch.Tensor) -> tuple[dict, int, int]:
    """The cell table of phase_cell for positions x: (max_occupied_cells
    CELL_SLACK x the occupied cells rounded up to 8, and cell_capacity =
    block CELL_SLACK x the fullest cell's count rounded up to a power of
    two from 16; the occupied cells; the fullest cell's count)."""
    from pdb_sph_tpu_torch.ops import hashgrid

    _, counts = torch.unique(hashgrid.cell_ids(cfg, x), return_counts=True)
    cap = 16
    while cap < CELL_SLACK * int(counts.max()):
        cap *= 2
    occ = -(-int(CELL_SLACK * counts.numel()) // 8) * 8
    return (dict(max_occupied_cells=occ, cell_capacity=cap, block=cap),
            counts.numel(), int(counts.max()))


def phase_cell(device, out_dir: str, n: int = N_MAIN) -> None:
    """The cell backend at the flagship size: CELL_STEPS steps against the
    window backend, with a table sized so nothing overflows; the one-rank
    sharded rollout on it, a graph, bitwise the eager ShardedStepper loop
    over CELL_STEPS steps; then a table with a third of the rows, whose
    drops table_overflow counts and on which the runner exits 2."""
    import dataclasses

    import pdb_sph_tpu_torch as pbf
    from pdb_sph_tpu_torch import cli
    from pdb_sph_tpu_torch.io import checkpoint
    from pdb_sph_tpu_torch.parallel import sharded

    cfg0 = pbf.default_config(n=n)
    st = pbf.spawn(cfg0, "dam_break", seed=0, device=device)
    table, cells, fullest = _cell_table(cfg0, st.x)
    cfg = dataclasses.replace(cfg0, **table)
    occ, cap = table["max_occupied_cells"], table["cell_capacity"]
    cell = pbf.make_step(cfg, "cell", device=device)
    win = pbf.make_step(cfg, "window", device=device)
    # each cell step starts from the window backend's state: a particle
    # that one backend bounces off the floor and the other, 1e-7 away, does
    # not keeps cd = 0.3 of its velocity in one run only (ops/collide.py),
    # which a rolled comparison carries into later positions (~5e-5 by
    # step 3 of the 80k dam break on an H100)
    b, err = st, 0.0
    for _ in range(CELL_STEPS):
        a, stats = cell.step(b, with_stats=True)
        if stats.tolist() != [0, 0, 0]:
            raise AssertionError(f"cell step stats {stats.tolist()}")
        b = win(b)
        xa, xb = _unsorted_x(a), _unsorted_x(b)
        err = max(err, float((xa - xb).abs().max()))
        torch.testing.assert_close(xa, xb, rtol=ORACLE_RTOL,
                                   atol=ORACLE_ATOL)
    print(f"[cell] n={n}: {cells} occupied cells, at most "
          f"{fullest} a cell; table max_occupied_cells {occ}, "
          f"cell_capacity {cap}; {CELL_STEPS} steps, each from the window "
          f"backend's state, stats [0, 0, 0]; max|dx| vs "
          f"window {err:.3e} (rtol {ORACLE_RTOL:g}, atol {ORACLE_ATOL:g})")

    pcfg = sharded.ParallelConfig.create(cfg, 1, state=st)
    sst = sharded.distribute(cfg, pcfg, st, device=device)
    roll = sharded.make_sharded_rollout(cfg, pcfg, None, "cell", CELL_STEPS,
                                        device)
    got, stats, diag = roll(sst)
    want, w_stats, w_diag = _eager_sharded(roll.stepper, sst, CELL_STEPS)
    same = (all(torch.equal(a, b) for a, b in zip(got, want))
            and torch.equal(stats, w_stats) and torch.equal(diag, w_diag))
    print(f"[cell] one-rank sharded rollout: graph {roll.graphed}; "
          f"{CELL_STEPS} steps bitwise the eager ShardedStepper loop: {same};"
          f" stats {stats.tolist()}, diag {diag.tolist()}")
    if not roll.graphed or not same or stats[:, 1:].any() \
            or diag[:, 1:].any():
        raise AssertionError("the one-rank cell rollout is not a graph, or "
                             "left the eager loop's bits")
    del roll, got, want

    small = dataclasses.replace(cfg, max_occupied_cells=occ // 3)
    _, stats = pbf.make_step(small, "cell", device=device).step(
        st, with_stats=True)
    os.makedirs(out_dir, exist_ok=True)
    ck = os.path.join(out_dir, "cell_small.npz")
    checkpoint.save(ck, small, st)
    metrics = os.path.join(out_dir, "cell_small.jsonl")
    if os.path.exists(metrics):
        os.remove(metrics)
    with _counting(torch.cuda.CUDAGraph, "capture_begin") as captures:
        rc = cli.main(["--resume", ck, "--steps", "1", "--chunk", "1",
                       "--backend", "cell", "--device", "cuda",
                       "--metrics-every", "0", "--metrics", metrics])
    with open(metrics) as f:
        last = json.loads(f.readlines()[-1])
    print(f"[cell] max_occupied_cells {occ // 3}: table_overflow "
          f"{int(stats[0])} in one step; the runner (--backend cell, "
          f"{captures[0]} graph capture) exits {rc}, its last record {last}")
    if not int(stats[0]) > 0 or rc != 2 or not last.get("n_overflow"):
        raise AssertionError("the small table did not overflow, or the "
                             "runner did not exit 2 on it")
    if captures != [1]:
        raise AssertionError(f"the runner's cell rollout captured "
                             f"{captures[0]} graphs, not 1")


def phase_backends(device, card: str, n: int = N_MAIN) -> None:
    """The single-device rollouts of the other backends as CUDA graphs, as
    the JAX rollout scans every backend, each from its spawn against
    Stepper.step calls, bitwise (x, v, ids, step, stats), stats [0, 0, 0],
    then the graph's steps/s over a second call: the cell backend at n on
    phase_cell's table, CELL_GRAPH_STEPS steps (the falling dam
    compresses, and its fullest cell soon outgrows that table's capacity);
    the cell backend at N_ORACLE on the table of phase_cell's rule from
    the window backend's state ROLLOUT_STEPS steps on, ROLLOUT_STEPS steps
    from it, then SYNC_STEPS graph steps under set_sync_debug_mode
    ("error"); the dense backend at N_ORACLE, DENSE_GRAPH_STEPS steps."""
    import dataclasses

    import pdb_sph_tpu_torch as pbf
    from pdb_sph_tpu_torch.utils.timing import fence

    def graph_vs_eager(cfg, backend: str, state, steps: int):
        rollout = pbf.make_rollout(cfg, backend, steps, with_stats=True,
                                   device=device)
        g, g_stats = rollout(state)
        e, e_stats = _eager_steps(rollout.stepper, state, steps)
        equal = {f: torch.equal(a, b) for f, a, b in zip(g._fields, g, e)}
        equal["stats"] = torch.equal(g_stats, e_stats)
        fence(device)
        t0 = time.perf_counter()
        rollout(state)
        fence(device)
        rate = steps / (time.perf_counter() - t0)
        head = f"[backends] {backend} n={cfg.n}"
        print(f"{head}: the Rollout is a graph {rollout.graphed}; {steps} "
              f"graph steps from step {int(state.step)} vs {steps} eager "
              f"Stepper.step steps: bitwise equal {equal}, stats "
              f"{g_stats.tolist()}; graph {rate:.3f} steps/s on {card} (a "
              f"second call)")
        if not rollout.graphed or not all(equal.values()) \
                or g_stats.tolist() != [0, 0, 0]:
            raise AssertionError(f"{head}: not a graph, or it left the eager "
                                 f"loop's bits, or counted overflow")
        return rollout, g

    cfg0 = pbf.default_config(n=n)
    st = pbf.spawn(cfg0, "dam_break", seed=0, device=device)
    table, _, _ = _cell_table(cfg0, st.x)
    graph_vs_eager(dataclasses.replace(cfg0, **table), "cell", st,
                   CELL_GRAPH_STEPS)

    cfg0 = pbf.default_config(n=N_ORACLE)
    st = pbf.make_rollout(cfg0, "window", ROLLOUT_STEPS, device=device)(
        pbf.spawn(cfg0, "dam_break", seed=0, device=device))
    table, cells, fullest = _cell_table(cfg0, st.x)
    print(f"[backends] cell n={N_ORACLE}: the window backend's state at step "
          f"{int(st.step)} has {cells} occupied cells, at most {fullest} a "
          f"cell: table {table['max_occupied_cells']} x "
          f"{table['cell_capacity']}")
    rollout, g = graph_vs_eager(dataclasses.replace(cfg0, **table), "cell",
                                st, ROLLOUT_STEPS)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rollout(g, SYNC_STEPS)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"[backends] cell n={N_ORACLE}: {SYNC_STEPS} graph steps under "
          f"set_sync_debug_mode('error') without a sync")

    graph_vs_eager(cfg0, "dense", pbf.spawn(cfg0, "dam_break", seed=0,
                                            device=device),
                   DENSE_GRAPH_STEPS)


def _in_box(x: torch.Tensor, wall: float) -> bool:
    """Every particle within the JAX rows' box, [-0.25, wall + 0.25]^3."""
    return bool(((x >= -BOX_MARGIN) & (x <= wall + BOX_MARGIN)).all())


def phase_scale_kernels(device, row: str = "dam1m") -> dict:
    """The kernels at a large row's size, on its dam break at step 60: all
    nine forms against their plain versions (two launches bitwise equal,
    counters back at 0), each timed beside its bound; the pairs within h
    by the FP32 and the tensor-core rd2; the sampled dense oracle. Returns
    {counter: (max|err|, ms, bound ms or None)}."""
    import pdb_sph_tpu_torch as pbf

    scene, n, wall = SCALE_ROWS[row]
    cfg = pbf.default_config(n=n, wall=wall)
    state = pbf.spawn(cfg, scene, seed=0, device=device)
    state = pbf.make_rollout(cfg, "window", SETTLE_STEPS, device=device)(state)
    p4, plan = _sorted_p4(cfg, state.x)
    del state
    head = f"[scale] {row} kernels:"
    _rd2_census(cfg, p4, plan, n, head)
    pairs = _pairs(cfg, p4, n)
    fp, d_k = _fp32_kernels(cfg, p4, plan, n, SETTLE_STEPS, 0, head=head,
                            pairs=pairs)
    fp.update(_tc_kernels(cfg, p4, d_k, plan, n, SETTLE_STEPS, 0, head=head,
                          pairs=pairs))
    _dense_oracle(cfg, p4, plan, n, head)
    return {k: (v[0], v[1], v[3]) for k, v in fp.items()}


def phase_scale_rollout(device, card: str, row: str, geom=None) -> dict:
    """A large row's dam break through the graph rollout in `geom` (None:
    the default geometry): one settle chunk, then SCALE_STEPS steps, their
    steps/s unless a cell times this configuration (the 1M row in the
    default geometry is dam1m.rollout's); stats [0, 0, 0] over every step,
    finite, in the JAX row's box, nothing escaped, the geometry's kernels
    launched as many times as its steps need and nothing else; the peak
    memory allocated from the spawn on. Returns its launches, the step and
    the final diagnostics."""
    import pdb_sph_tpu_torch as pbf
    from pdb_sph_tpu_torch.ops import cuda_pbf
    from pdb_sph_tpu_torch.utils.timing import fence

    scene, n, wall = SCALE_ROWS[row]
    steps = SCALE_STEPS
    cfg = pbf.default_config(n=n, wall=wall,
                             **({} if geom is None else {"geom": geom}))
    name = _geom_name(cfg.geom)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    cuda_pbf.reset_launches()
    rollout = pbf.make_rollout(cfg, "window", SCALE_SETTLE, with_stats=True,
                               device=device)
    state, total = rollout(pbf.spawn(cfg, scene, seed=0, device=device))

    before = dict(cuda_pbf.LAUNCHES)
    fence(device)
    t0 = time.perf_counter()
    state, stats = rollout(state, steps)
    fence(device)
    secs = time.perf_counter() - t0
    total += stats
    timed = {k: cuda_pbf.LAUNCHES[k] - before[k] for k in before}
    d = pbf.diagnostics_fn(cfg, state, rollout.stepper.scratch)
    diag = {"mean_density": float(d.mean_density),
            "max_density_err": float(d.max_density_err),
            "max_speed": float(d.max_speed), "n_escaped": int(d.n_escaped),
            "nan": bool(d.nan_detected)}
    fence(device)
    peak = torch.cuda.max_memory_allocated(device)
    launches = dict(cuda_pbf.LAUNCHES)
    x, v = state.x, state.v
    finite = bool(torch.isfinite(x).all() and torch.isfinite(v).all())
    boxed = _in_box(x, wall)
    rate = ("" if row == "dam1m" and geom is None else
            f" in {secs:.4f} s = {steps / secs:.2f} steps/s = "
            f"{n * steps / secs:.1f} particle-steps/s on {card}")
    print(f"[scale] {row} {scene} n={n} wall={wall} {name}: "
          f"{steps} graph steps after a {SCALE_SETTLE}-step settle chunk"
          f"{rate}; peak memory allocated {peak / 2 ** 30:.3f} GiB; stats "
          f"over every step {total.tolist()}; finite {finite}; in "
          f"[-{BOX_MARGIN}, wall + {BOX_MARGIN}]^3 {boxed}; at step "
          f"{int(state.step)}: mean rho {diag['mean_density']:.2f}, max "
          f"|rho/rho0 - 1| {diag['max_density_err']:.4f}, max speed "
          f"{diag['max_speed']:.4f}, escaped {diag['n_escaped']}; launches "
          f"of those steps {_nonzero(timed)}")
    if total.tolist() != [0, 0, 0] or not finite or not boxed \
            or diag["n_escaped"] or diag["nan"]:
        raise AssertionError(f"{row} {name}: state or stats are wrong")
    _check_launches(f"[scale] {row} {name}", timed,
                    _launches(steps, geom=cfg.geom))
    return {"launches": launches, "step": int(state.step), **diag}


def phase_scale_blowup(device, card: str, row: str = "blowup1m") -> dict:
    """A large row's blowup through the explosion and the recovery:
    BLOWUP_STEPS graph steps in chunks of BLOWUP_EVERY, the diagnostics
    after each; stats [0, 0, 0] over every step, finite, in the box,
    nothing escaped at any record; the heaviest chunk's candidates and the
    segment length the work table chose at the spawn. Returns its
    launches."""
    import pdb_sph_tpu_torch as pbf
    from pdb_sph_tpu_torch.ops import cuda_pbf
    from pdb_sph_tpu_torch.utils.timing import fence

    scene, n, wall = SCALE_ROWS[row]
    cfg = pbf.blowup_config(n=n, wall=wall)
    state = pbf.spawn(cfg, scene, seed=0, device=device)
    p4, plan = _sorted_p4(cfg, state.x)
    mean_c, max_c = _candidates(plan)
    items, seg_len = int(plan.seg_prefix[-1]), int(plan.seg_len)
    chunks = plan.ranges.shape[0]
    del p4, plan
    print(f"[scale] {row} n={n} wall={wall} at the spawn: candidates/chunk "
          f"mean {mean_c:.1f} max {max_c}; the work table chose seg_len "
          f"{seg_len} (geometry's seg {cfg.geom.seg}) for {items} items "
          f"over {chunks} chunks (capacity "
          f"{cuda_pbf.ITEMS_PER_CHUNK * chunks})")
    rollout = pbf.make_rollout(cfg, "window", BLOWUP_EVERY, with_stats=True,
                               device=device)
    cuda_pbf.reset_launches()
    total = torch.zeros((3,), dtype=torch.int32, device=device)
    records = []
    fence(device)
    t0 = time.perf_counter()
    for _ in range(BLOWUP_STEPS // BLOWUP_EVERY):
        state, stats = rollout(state)
        total += stats
        d = pbf.diagnostics_fn(cfg, state, rollout.stepper.scratch)
        records.append((int(state.step), float(d.mean_density),
                        float(d.max_speed), int(d.n_escaped),
                        bool(d.nan_detected)))
    fence(device)
    secs = time.perf_counter() - t0
    launches = dict(cuda_pbf.LAUNCHES)
    finite = bool(torch.isfinite(state.x).all()
                  and torch.isfinite(state.v).all())
    boxed = _in_box(state.x, wall)
    print(f"[scale] {row} n={n} wall={wall}: {BLOWUP_STEPS} graph steps in "
          f"{secs:.3f} s, diagnostics every {BLOWUP_EVERY} included "
          f"({BLOWUP_STEPS / secs:.2f} steps/s) on {card}; stats over every "
          f"step {total.tolist()}; finite {finite}; in box {boxed}; (step, "
          f"mean rho, max speed): "
          + ", ".join(f"({s}, {r:.1f}, {vmax:.3f})"
                      for s, r, vmax, _, _ in records)
          + f"; launches { {k: c for k, c in launches.items() if c} }")
    if total.tolist() != [0, 0, 0] or not finite or not boxed \
            or any(e or nan for *_, e, nan in records):
        raise AssertionError(f"{row}: state, stats or escapes are wrong")
    _check_launches(f"[scale] {row}", launches,
                    _launches(BLOWUP_STEPS + WARMUP_STEPS * rollout.graphed,
                              rho=len(records), geom=cfg.geom))
    return launches


def phase_scale_cli(device, out_dir: str, row: str = "dam1m") -> dict:
    """The runner at a large row's size as the README's command, with
    metrics, frames, a GIF and a checkpoint; then its resume to step
    SCALE_CLI_STEPS + SCALE_CLI_RESUME, ending on a partial chunk; each run
    rc 0, one graph capture, one scratch, every record's counters 0.
    Returns their summed launches."""
    scene, n, wall = SCALE_ROWS[row]
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    ck, fr = os.path.join(out_dir, "ck.npz"), os.path.join(out_dir, "fr")
    head = f"[scale] {row} cli:"
    _, l_run = _cli_run(
        ["--scene", scene, "--n", str(n), "--wall", str(wall),
         "--grid-width", "29", "--steps", str(SCALE_CLI_STEPS),
         "--metrics-every", str(CLI_EVERY), "--render-every", str(CLI_EVERY),
         "--width", "320", "--height", "240", "--out", fr, "--gif",
         os.path.join(out_dir, "run.gif"), "--checkpoint", ck],
        os.path.join(out_dir, "run.jsonl"), head=head)
    want_png = [f"frame_{s:06d}.png"
                for s in range(0, SCALE_CLI_STEPS + 1, CLI_EVERY)]
    if sorted(os.listdir(fr)) != want_png:
        raise AssertionError(f"{row} runner frames {sorted(os.listdir(fr))}")
    resumed, l_res = _cli_run(
        ["--resume", ck, "--steps", str(SCALE_CLI_RESUME), "--chunk",
         str(SCALE_CLI_CHUNK), "--metrics-every", str(SCALE_CLI_CHUNK)],
        os.path.join(out_dir, "resume.jsonl"), head=head)
    steps = [r["step"] for r in resumed if r["event"] == "progress"]
    last = SCALE_CLI_STEPS + SCALE_CLI_RESUME
    if steps != [SCALE_CLI_STEPS + SCALE_CLI_CHUNK, last]:
        raise AssertionError(f"{row} resume progress steps {steps}")
    return {k: l_run[k] + l_res[k] for k in l_run}


# ---------------------------------------------------------------------------
# [nccl] (--ranks N): the sharded rollout on NCCL ranks, one card each. The
# rank functions live at module level: a spawned rank imports this script
# again to find them.
# ---------------------------------------------------------------------------

def _nccl_cfg(n: int, wall: float):
    import pdb_sph_tpu_torch as pbf

    return pbf.default_config(n=n, wall=wall, **NCCL_TABLE)


def _eager_sharded(stepper, sst, steps: int):
    """`steps` eager ShardedStepper.step calls from `sst`, aggregated as
    the rollout does and gathered: the loop the graph is held against."""
    from pdb_sph_tpu_torch.parallel import sharded

    acc = (torch.zeros((5,), dtype=torch.int32, device=sst.x.device),
           torch.zeros((3,), dtype=torch.float32, device=sst.x.device))
    for _ in range(steps):
        sst, stats, diag = stepper.step(sst)
        sharded._aggregate(acc, stats, diag)
    return (sst, *stepper.gather(*acc))


def _weighted_density(stats: torch.Tensor, dens: torch.Tensor) -> float:
    """The ranks' mean rho weighted by their particles, as the runner
    weighs them."""
    w = stats[:, 0].double().clamp_min(1)
    return float((dens[:, 0].double() * w).sum() / w.sum())


def _rank_window(job: dict, group, device):
    """(cfg, pcfg, the spawn distributed on this rank) of a job's row."""
    import pdb_sph_tpu_torch as pbf
    from pdb_sph_tpu_torch.parallel import sharded

    cfg = _nccl_cfg(job["n"], job["wall"])
    state = pbf.spawn(cfg, "dam_break", seed=0, device="cpu")
    pcfg = sharded.ParallelConfig.create(cfg, group.size, state=state)
    return cfg, pcfg, sharded.distribute(cfg, pcfg, state, group, device)


def _nccl_main(group, device, job: dict, res: dict) -> None:
    """Graph against eager on the job's row, from the state after the
    rollout's first chunk (its warm-up step and capture): bitwise, under
    the sync-debug mode; then the graph's steps/s twice, and
    bench_multichip's fields."""
    from pdb_sph_tpu_torch.ops import cuda_pbf
    from pdb_sph_tpu_torch.parallel import sharded
    from pdb_sph_tpu_torch.utils.timing import fence

    cfg, pcfg, sst0 = _rank_window(job, group, device)
    roll = sharded.make_sharded_rollout(cfg, pcfg, group, "window", 1,
                                        device)
    if not roll.graphed:
        raise AssertionError("the NCCL ranks' ShardedRollout is not a graph")
    diag = sharded.make_sharded_diagnostics(cfg, pcfg, group, "window",
                                            roll.stepper.work.scratch)
    base, _, _ = roll(sst0, job["start"])

    steps = job["steps"]
    cuda_pbf.reset_launches()
    g, gs, gd = roll(base, steps)
    res["graph_launches"] = _nonzero(cuda_pbf.LAUNCHES)
    e, es, ed = _eager_sharded(roll.stepper, base, steps)
    same = {f: torch.equal(a, b) for f, a, b in zip(g._fields, g, e)}
    same.update(stats=torch.equal(gs, es), diag=torch.equal(gd, ed))
    cg, ce = sharded.collect(g, group), sharded.collect(e, group)
    same["collected"] = all(torch.equal(a, b) for a, b in zip(cg[:3], ce[:3]))
    res["bitwise"] = same
    del e, cg, ce
    torch.cuda.synchronize(device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        roll(base, job["sync_steps"])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize(device)

    rates = []
    for _ in range(2):
        fence(device)
        t0 = time.perf_counter()
        roll(base, steps)
        fence(device)
        rates.append(steps / (time.perf_counter() - t0))
    res["rates"] = rates
    dens = diag(g)
    res["bench"] = {
        "step": job["start"] + steps,
        "per_shard_active": gs[:, 0].tolist(),
        "overflows": gs[:, 1:].sum(dim=0).tolist(),
        "max_speed": float(gd[:, 0].max()),
        "n_escaped": int(gd[:, 1].sum()), "nan": int(gd[:, 2].sum()),
        "mean_density": _weighted_density(gs, dens),
        "max_density_err": float(dens[:, 1].max()),
        "slab_bounds": g.bounds[1:].tolist()}


def _nccl_switches(group, device, job: dict, res: dict) -> None:
    """NCCL_SWITCH_STEPS steps from the spawn in the default geometry and
    in each tensor-core geometry, each on its own rollout."""
    import dataclasses

    from pdb_sph_tpu_torch.geometry import KernelGeometry
    from pdb_sph_tpu_torch.ops import cuda_pbf
    from pdb_sph_tpu_torch.parallel import sharded

    cfg, pcfg, sst0 = _rank_window(job, group, device)
    out = {}
    for switches in ({}, ALL_SWITCHES, *ONE_SWITCH_GEOMS):
        gcfg = dataclasses.replace(cfg, geom=KernelGeometry(**switches))
        roll = sharded.make_sharded_rollout(gcfg, pcfg, group, "window", 1,
                                            device)
        cuda_pbf.reset_launches()
        s, stats, sdiag = roll(sst0, job["switch_steps"])
        launches = _nonzero(cuda_pbf.LAUNCHES)
        dens = sharded.make_sharded_diagnostics(
            gcfg, pcfg, group, "window", roll.stepper.work.scratch)(s)
        out[_geom_name(gcfg.geom)] = {
            "switches": switches, "launches": launches,
            "stats": stats.tolist(), "diag": sdiag.tolist(),
            "mean_density": _weighted_density(stats, dens),
            "max_speed": float(sdiag[:, 0].max())}
        del roll, s
        torch.cuda.empty_cache()
    res["switches"] = out


def _nccl_large(group, device, job: dict, res: dict) -> None:
    """The large row: one settle chunk (its first call warms up and
    captures), SCALE_STEPS graph steps timed; stats over every step, the
    box, the peak memory of this rank."""
    from pdb_sph_tpu_torch.parallel import sharded
    from pdb_sph_tpu_torch.utils.timing import fence

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    cfg, pcfg, sst = _rank_window(job, group, device)
    roll = sharded.make_sharded_rollout(cfg, pcfg, group, "window", 1,
                                        device)
    sst, s1, d1 = roll(sst, job["settle"])
    fence(device)
    t0 = time.perf_counter()
    sst, s2, d2 = roll(sst, job["steps"])
    fence(device)
    secs = time.perf_counter() - t0
    dens = sharded.make_sharded_diagnostics(
        cfg, pcfg, group, "window", roll.stepper.work.scratch)(sst)
    st = sharded.collect(sst, group)
    fence(device)
    res["large"] = {
        "secs": secs,
        "stats": [s1.tolist(), s2.tolist()],
        "max_speed": float(torch.maximum(d1, d2)[:, 0].max()),
        "n_escaped": int((d1 + d2)[:, 1].sum()),
        "nan": int((d1 + d2)[:, 2].sum()),
        "finite": bool(torch.isfinite(st.x).all()
                       and torch.isfinite(st.v).all()),
        "in_box": _in_box(st.x, cfg.wall), "n": int(st.x.shape[0]),
        "mean_density": _weighted_density(s2, dens),
        "max_density_err": float(dens[:, 1].max()),
        "slab_bounds": sst.bounds[1:].tolist(),
        "peak_gib": torch.cuda.max_memory_allocated(device) / 2 ** 30}


def _nccl_cell(group, device, job: dict, res: dict) -> None:
    """The cell backend against the window backend, each step from the
    window backend's state (phase_cell's method), both as graphs."""
    import dataclasses

    import pdb_sph_tpu_torch as pbf
    from pdb_sph_tpu_torch.parallel import sharded

    cfg = dataclasses.replace(pbf.default_config(n=job["n"]),
                              **job["table"])
    state = pbf.spawn(cfg, "dam_break", seed=0, device="cpu")
    pcfg = sharded.ParallelConfig.create(cfg, group.size, state=state)
    b = sharded.distribute(cfg, pcfg, state, group, device)
    win, cell = (sharded.make_sharded_rollout(cfg, pcfg, group, backend, 1,
                                              device)
                 for backend in ("window", "cell"))
    errs, stats = [], []
    for _ in range(job["steps"]):
        a, s, _ = cell(b, 1)
        b, _, _ = win(b, 1)
        xa, xb = (sharded.collect(t, group).x for t in (a, b))
        bad = ~torch.isclose(xa, xb, rtol=ORACLE_RTOL, atol=ORACLE_ATOL)
        errs.append([float((xa - xb).abs().max()), int(bad.sum())])
        stats.append(s.tolist())
    res["cell"] = {"graphed": [win.graphed, cell.graphed], "errs": errs,
                   "stats": stats}


def _record_local_plans(path: str):
    """Patch the sharded step so that its next window solve saves, at
    `path`, what its first density and project passes run on: the rank's
    local set sorted and padded to whole chunks (rows (n_pad, 4), the
    invalid slots 0, as the solve writes them), its row count and the
    restricted plans' tensors. Returns the function that undoes the patch."""
    from pdb_sph_tpu_torch.ops import cuda_pbf
    from pdb_sph_tpu_torch.parallel import sharded

    real_set, real_plans, seen = sharded._local_set, sharded._window_plans, []

    def local_set(*args):
        out = real_set(*args)
        seen.append(out)
        return out

    def window_plans(cfg, cid, z_bounds):
        out = real_plans(cfg, cid, z_bounds)
        if len(seen) == 1:
            combined, ok, _ = seen[0]
            order, _, plan_d, plan_p = out
            n = combined.shape[0]
            p4 = torch.zeros((cuda_pbf.pad_to_chunks(cfg, n), 4),
                             dtype=torch.float32, device=combined.device)
            p4[:n, :3] = torch.where(ok[order][:, None], combined[order], 0.0)
            torch.save({"p4": p4.cpu(), "n": n,
                        "valid": int(ok.sum()),
                        **{f"{k}_{f}": getattr(pl, f).cpu()
                           for k, pl in (("d", plan_d), ("p", plan_p))
                           for f in ("ranges", "seg_prefix", "seg_len")}},
                       path)
            seen.append(None)
        return out

    sharded._local_set, sharded._window_plans = local_set, window_plans

    def undo():
        sharded._local_set, sharded._window_plans = real_set, real_plans
    return undo


def _tier_run(group, device, cfg, pcfg, st, job: dict) -> tuple:
    """One tier from the state `st`: its rollout's first call (warm-up,
    capture, job["steps"] replays); (the rollout, its density diagnostics,
    its first state, the result of the steps, the tier's figures)."""
    from pdb_sph_tpu_torch.ops import cuda_pbf
    from pdb_sph_tpu_torch.parallel import sharded

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    s0 = sharded.distribute(cfg, pcfg, st, group, device)
    roll, dens = sharded.tier_programs(cfg, pcfg, group, "window", 1, device)
    if not roll.graphed:
        raise AssertionError("the NCCL ranks' ShardedRollout is not a graph")
    cuda_pbf.reset_launches()
    g, gs, gd = roll(s0, job["steps"])
    launches = _nonzero(cuda_pbf.LAUNCHES)
    act = gs[:, 0].double()
    return roll, dens, s0, (g, gs, gd), {
        "slots": pcfg.capacity + 2 * pcfg.ghost_capacity,
        "capacity": pcfg.capacity, "ghost_capacity": pcfg.ghost_capacity,
        "mig_capacity": pcfg.mig_capacity, "launches": launches,
        "peak_gib": torch.cuda.max_memory_allocated(device) / 2 ** 30,
        "stats": gs.tolist(), "diag": gd.tolist(),
        "balance": float(act.min() / act.mean())}


def _lockstep(group, rolls: dict, steps: int) -> dict:
    """Both tiers' rollouts one step at a time from their first states:
    the states are bitwise equal while the slab bounds are (every op of the
    step but the move rule sees the valid slots alone); the first step
    whose bounds differ, and 3 steps later the largest position difference
    and whether it is within the step-3 tolerance."""
    from pdb_sph_tpu_torch.parallel import sharded

    (ra, a), (rb, b) = rolls["spawn"], rolls["compact"]
    out = {"bounds_part_at": None, "bitwise_through": 0}

    def same(a, b) -> bool:
        # the particles fill the first slots of either tier, in one order
        m = b.x.shape[0]
        mine = (all(torch.equal(s[:m], t) for s, t in zip(a[:3], b[:3]))
                and bool((a.ids[m:] < 0).all()))
        return bool(group.all_gather(torch.tensor(
            [int(mine)], dtype=torch.int32, device=a.x.device)).all())

    for i in range(1, steps + 1):
        a, _, _ = ra(a, 1)
        b, _, _ = rb(b, 1)
        if out["bounds_part_at"] is None:
            if not torch.equal(a.bounds, b.bounds):
                out["bounds_part_at"] = i
                out["bounds"] = [a.bounds[1:].tolist(), b.bounds[1:].tolist()]
            elif same(a, b):
                out["bitwise_through"] = i
        elif i == out["bounds_part_at"] + SHARD_STEPS - 1:
            xa, xb = (sharded.collect(t, group).x for t in (a, b))
            out["max_dx_3_after"] = float((xa - xb).abs().max())
            out["close_3_after"] = bool(torch.allclose(
                xa, xb, rtol=SHARD_RTOL, atol=SHARD_ATOL))
            break
    return out


def _nccl_tiers(group, device, job: dict, res: dict) -> None:
    """The two tiers of the JAX package's flow from one state (the
    collected state of the correctness chunks' end): the spawn tier
    (ParallelConfig.create of it) and the compact tier (.compact of it,
    prior the spawn tier), each distributed from that state and run
    job["steps"] graph steps, then freed (ShardedRollout.release) before
    the next tier allocates; the density of both final states; the compact
    tier's graph against its eager loop; then on rollouts built anew, both
    alive, the tiers in lockstep (_lockstep).
    With job["plans"], the compact tier's first step also leaves the local
    set and plans of rank job["plans_rank"] there."""
    from pdb_sph_tpu_torch import interop
    from pdb_sph_tpu_torch.parallel import sharded
    from pdb_sph_tpu_torch.utils.timing import fence

    cfg = _nccl_cfg(job["n"], job["wall"])
    st = interop.state_from_numpy(*torch.load(job["state"]), 0, "cpu")
    tiers = {"spawn": sharded.ParallelConfig.create(cfg, group.size,
                                                    state=st)}
    tiers["compact"] = sharded.ParallelConfig.compact(
        cfg, group.size, state=st, prior=tiers["spawn"])
    out, finals = {}, {}
    for name, pcfg in tiers.items():
        roll, dens, s0, (g, gs, gd), out[name] = _tier_run(
            group, device, cfg, pcfg, st, job)
        finals[name] = [t.cpu() for t in sharded.collect(g, group)[:3]]
        out[name]["mean_density"] = _weighted_density(gs, dens(g))
        if name == "compact":
            e, es, ed = _eager_sharded(roll.stepper, s0, job["steps"])
            same = {f: torch.equal(a, b) for f, a, b in zip(g._fields, g, e)}
            same.update(stats=torch.equal(gs, es), diag=torch.equal(gd, ed))
            out["graph_vs_eager"] = same
            del e, es, ed
            if job.get("plans"):
                undo = _record_local_plans(job["plans"]) \
                    if group.rank == job["plans_rank"] else (lambda: None)
                try:
                    roll.stepper.step(s0)
                finally:
                    undo()
        roll.release()
        del roll, dens, s0, g
        fence(device)
        out[name]["allocated_after_release_gib"] = \
            torch.cuda.memory_allocated(device) / 2 ** 30
    out["final_bitwise"] = all(torch.equal(a, b) for a, b in
                               zip(finals["spawn"], finals["compact"]))
    out["final_max_dx"] = float((finals["spawn"][0]
                                 - finals["compact"][0]).abs().max())
    del finals

    rolls = {}
    for name, pcfg in tiers.items():
        s0 = sharded.distribute(cfg, pcfg, st, group, device)
        roll = sharded.make_sharded_rollout(cfg, pcfg, group, "window", 1,
                                            device)
        roll(s0, 1)  # warm-up step and capture
        rolls[name] = (roll, s0)
    out["lockstep"] = _lockstep(group, rolls, job["steps"])
    for roll, _ in rolls.values():
        roll.release()
    res["tiers"] = out


def _nccl_rank(group, device, workdir: str, job: dict) -> None:
    """One NCCL rank of an [nccl] run: the parts `job` names, then this
    rank's results in rank{r}.json."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res: dict = {"card": torch.cuda.get_device_name(device)}
    _nccl_main(group, device, job, res)
    if "tiers" in job:
        _nccl_tiers(group, device, job["tiers"], res)
    if "switch_steps" in job:
        _nccl_switches(group, device, job, res)
    if "large" in job:
        _nccl_large(group, device, job["large"], res)
    if "cell" in job:
        _nccl_cell(group, device, job["cell"], res)
    with open(os.path.join(workdir, f"rank{group.rank}.json"), "w") as f:
        json.dump(res, f)


def _counted_mesh_rank(group, device, workdir, *job) -> None:
    """A rank of the sharded runner (cli._mesh_rank) that counts its graph
    captures and pair-kernel scratches and leaves them, with its kernel
    launches, in the directory RANK_COUNTS_ENV names; rank 0 also leaves
    there the state each re-tier sizes its tier from (retier{i}.pt). With
    RANK_FORCE_ENV set, every compact tier is forced to overflow: "ghost"
    gives it a quarter of its ghost capacity (the exchange then truncates
    for real), "migration" adds one to its migration column every step."""
    import dataclasses

    from pdb_sph_tpu_torch import cli
    from pdb_sph_tpu_torch.ops import cuda_pbf
    from pdb_sph_tpu_torch.parallel import sharded

    counts_dir, force = os.environ[RANK_COUNTS_ENV], \
        os.environ.get(RANK_FORCE_ENV, "")
    real_compact, real_step = (sharded.ParallelConfig.compact,
                               sharded._shard_step)
    compact_tiers = []

    def compact(cfg, n_devices, state, **kw):
        if group.rank == 0:
            torch.save(tuple(t.cpu() for t in state[:3]), os.path.join(
                counts_dir, f"retier{len(compact_tiers)}.pt"))
        pcfg = real_compact(cfg, n_devices, state, **kw)
        if force == "ghost":
            pcfg = dataclasses.replace(pcfg, ghost_capacity=max(
                128, pcfg.ghost_capacity // 4 // 128 * 128))
        compact_tiers.append(pcfg)
        return pcfg

    def step(cfg, pcfg, *rest):
        out = real_step(cfg, pcfg, *rest)
        if force == "migration" and any(pcfg is c for c in compact_tiers):
            stats = out[4].clone()
            stats[1] += 1
            out = (*out[:4], stats, out[5])
        return out

    sharded.ParallelConfig.compact = staticmethod(compact)
    sharded._shard_step = step
    with _counting(cuda_pbf, "alloc_scratch") as scratches, \
            _counting(torch.cuda.CUDAGraph, "capture_begin") as captures:
        cli._mesh_rank(group, device, workdir, *job)
    with open(os.path.join(counts_dir, f"rank{group.rank}.json"), "w") as f:
        json.dump({"captures": captures[0], "scratches": scratches[0],
                   "launches": cuda_pbf.LAUNCHES}, f)


def _bench_line(row: str, D: int, n: int, rate: float, bench: dict) -> str:
    """bench_multichip.py's fields (benchmarks/bench_multichip.py:114-127)
    of one run of the row on D cards."""
    act = bench["per_shard_active"]
    return json.dumps({
        "metric": f"particle_steps_per_sec_{n}_dam_break_{D}dev",
        "value": rate * n, "unit": "particle-steps/s", "steps_per_sec": rate,
        "devices": D, "per_shard_active": act,
        "balance_min_over_mean": min(act) / (sum(act) / len(act)),
        "overflows": bench["overflows"], "max_speed": bench["max_speed"],
        "n_escaped": bench["n_escaped"],
        "max_density_err": bench["max_density_err"],
        "slab_bounds": bench["slab_bounds"]})


def phase_nccl_single(device, card: str) -> None:
    """The row on one card, the one-rank fast path as a graph: the
    correctness marks' steps, then NCCL_STEPS graph steps timed twice;
    bench_multichip.py's line for D = 1."""
    import pdb_sph_tpu_torch as pbf
    from pdb_sph_tpu_torch.parallel import sharded
    from pdb_sph_tpu_torch.utils.timing import fence

    n, wall = NCCL_ROWS["dam1m"]
    cfg = _nccl_cfg(n, wall)
    st = pbf.spawn(cfg, "dam_break", seed=0, device=device)
    pcfg = sharded.ParallelConfig.create(cfg, 1, state=st)
    roll = sharded.make_sharded_rollout(cfg, pcfg, None, "window", 1, device)
    start = RANK_MARKS[-1]
    sst, _, _ = roll(sharded.distribute(cfg, pcfg, st, device=device), start)
    rates = []
    for _ in range(2):
        fence(device)
        t0 = time.perf_counter()
        g, gs, gd = roll(sst, NCCL_STEPS)
        fence(device)
        rates.append(NCCL_STEPS / (time.perf_counter() - t0))
    dens = sharded.make_sharded_diagnostics(
        cfg, pcfg, scratch=roll.stepper.work.scratch)(g)
    bench = {"per_shard_active": gs[:, 0].tolist(),
             "overflows": gs[:, 1:].sum(dim=0).tolist(),
             "max_speed": float(gd[:, 0].max()),
             "n_escaped": int(gd[:, 1].sum()),
             "max_density_err": float(dens[:, 1].max()),
             "slab_bounds": g.bounds[1:].tolist()}
    rate = statistics.median(rates)
    print(f"[nccl] dam1m D=1 (the one-rank fast path, a graph) on {card}: "
          f"graph {rates[0]:.2f}, {rates[1]:.2f} steps/s over {NCCL_STEPS} "
          f"steps from step {start}")
    print(f"[nccl] bench_multichip line D=1: "
          f"{_bench_line('dam1m', 1, n, rate, bench)}")
    if gs[:, 1:].any() or gd[:, 1:].any():
        raise AssertionError(f"dam1m D=1: stats {gs.tolist()} {gd.tolist()}")


def _nccl_run(D: int, job: dict, timeout_s: float = RANKS_TIMEOUT_S):
    """`job` on D NCCL ranks, cards 0 .. D-1: each rank's results."""
    from pdb_sph_tpu_torch.parallel import launch

    with tempfile.TemporaryDirectory(prefix="nccl_") as workdir:
        launch.run(_nccl_rank, D, [f"cuda:{r}" for r in range(D)],
                   comm="nccl", timeout_s=timeout_s, workdir=workdir,
                   args=(job,))
        ranks = []
        for r in range(D):
            with open(os.path.join(workdir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    return ranks


def phase_nccl(card: str, D: int, extra: dict | None = None) -> list[dict]:
    """The row on D NCCL ranks, one card each, after phase_two_ranks has
    held them against the Stepper: the graph bitwise the eager loop, the
    sync-debug steps, the graph's rates, bench_multichip's line; `extra`
    adds the D = 4 parts. Returns the ranks' results."""
    n, wall = NCCL_ROWS["dam1m"]
    start = RANK_MARKS[-1]
    job = {"row": "dam1m", "n": n, "wall": wall, "start": start,
           "steps": NCCL_STEPS, "sync_steps": NCCL_SYNC_STEPS,
           **(extra or {})}
    ranks = _nccl_run(D, job)
    r0 = ranks[0]
    head = f"[nccl] dam1m D={D}"
    rates = r0["rates"]
    print(f"{head}: {NCCL_STEPS} graph steps vs {NCCL_STEPS} eager "
          f"ShardedStepper steps from step {start}, bitwise equal "
          f"on every rank: {[r['bitwise'] for r in ranks]}; "
          f"{NCCL_SYNC_STEPS} graph steps under set_sync_debug_mode('error') "
          f"on every rank without a sync; graph {rates[0]:.2f}, "
          f"{rates[1]:.2f} steps/s (rank 0's clock, fenced) on {card}")
    rate = statistics.median(rates)
    print(f"[nccl] bench_multichip line D={D}: "
          f"{_bench_line('dam1m', D, n, rate, r0['bench'])}; mean rho "
          f"{r0['bench']['mean_density']:.2f} at step {r0['bench']['step']}")
    if not all(all(r["bitwise"].values()) for r in ranks):
        raise AssertionError(f"{head}: the graph left the eager loop's bits")
    for r in ranks:
        _check_launches(f"{head} graph", r["graph_launches"],
                        _launches(NCCL_STEPS, ranks=D))
    b = r0["bench"]
    if any(b["overflows"]) or b["n_escaped"] or b["nan"] \
            or sum(b["per_shard_active"]) != n:
        raise AssertionError(f"{head}: bench stats {b}")
    return ranks


def phase_tiers(card: str, D: int, ranks: list[dict], n: int,
                failures: list) -> dict:
    """The [tiers] part of the D ranks' results: each tier's figures a
    rank, then the checks, whose failures go to `failures`: the compact
    tier's graph bitwise its eager loop on every rank; the two tiers from
    one state bitwise equal while their slab bounds agree, within the
    step-3 tolerance 3 steps after the move rule parts them (mig_capacity,
    the largest strip it donates, is the one capacity an op of the step
    reads), and their final mean density within DENS_MEAN_RTOL of each
    other (bitwise when the bounds never part); zero overflow and every
    particle on both tiers; the compact tier smaller than the spawn tier on
    every rank, in slots and in peak memory. Returns the compact tier's
    launches summed over the ranks."""
    head = f"[tiers] dam1m D={D}"
    r0 = ranks[0]["tiers"]
    steps = NCCL_STEPS
    lock = r0["lockstep"]
    part = lock["bounds_part_at"]
    dens = [r0[t]["mean_density"] for t in ("spawn", "compact")]
    share = abs(dens[1] - dens[0]) / dens[0]
    parted = ("the slab bounds agree through all of them" if part is None
              else f"the slab bounds part at step {part} (spawn, compact: "
                   f"{lock['bounds']}), and {SHARD_STEPS} steps on the "
                   f"positions differ by max {lock['max_dx_3_after']:.3e} "
                   f"(within rtol {SHARD_RTOL:g} atol {SHARD_ATOL:g}: "
                   f"{lock['close_3_after']})")
    print(f"{head} on {card}: from the collected state at step "
          f"{RANK_MARKS[-1]}, each tier distributed from it and run {steps} "
          f"graph steps; in lockstep the two tiers' states are bitwise "
          f"equal through step {lock['bitwise_through']} of {steps}: "
          f"{parted}; final "
          f"states bitwise equal {r0['final_bitwise']} (max|dx| "
          f"{r0['final_max_dx']:.3e}), mean rho spawn {dens[0]:.2f}, "
          f"compact {dens[1]:.2f} ({100 * share:.4f} %); compact-tier graph "
          f"vs {steps} eager steps bitwise on every rank: "
          f"{[all(r['tiers']['graph_vs_eager'].values()) for r in ranks]}")
    total: dict = {}
    for r, res in enumerate(ranks):
        t = res["tiers"]
        for name in ("spawn", "compact"):
            e = t[name]
            print(f"{head} rank {r} {name} tier: local slots {e['slots']} "
                  f"(capacity {e['capacity']} + 2 x ghosts "
                  f"{e['ghost_capacity']}), migration {e['mig_capacity']}; "
                  f"peak memory allocated {e['peak_gib']:.3f} GiB, "
                  f"{e['allocated_after_release_gib']:.3f} GiB after its "
                  f"release; balance_min_over_mean {e['balance']:.6f}; "
                  f"this rank's stats {e['stats'][r]}; launches "
                  f"{e['launches']}")
        for k, v in t["compact"]["launches"].items():
            total[k] = total.get(k, 0) + v
    bad = []
    for r, res in enumerate(ranks):
        t = res["tiers"]
        if not all(t["graph_vs_eager"].values()):
            bad.append(f"rank {r}: the compact tier's graph left its eager "
                       f"loop's bits {t['graph_vs_eager']}")
        a, b = t["spawn"], t["compact"]
        if not (b["slots"] < a["slots"] and b["peak_gib"] < a["peak_gib"]):
            bad.append(f"rank {r}: the compact tier is not smaller")
        if _nonzero(b["launches"]) != _launches(steps + WARMUP_STEPS,
                                                ranks=D):
            bad.append(f"rank {r}: compact launches {b['launches']}")
    for name in ("spawn", "compact"):
        st = torch.tensor(r0[name]["stats"])
        if st[:, 1:].sum() or int(st[:, 0].sum()) != n \
                or torch.tensor(r0[name]["diag"])[:, 1:].sum():
            bad.append(f"{name}: stats {r0[name]['stats']}")
    if part is None:
        if lock["bitwise_through"] != steps or not r0["final_bitwise"]:
            bad.append("the tiers' bounds agree but their states differ")
    elif lock["bitwise_through"] != part - 1 or not lock["close_3_after"] \
            or not share <= DENS_MEAN_RTOL:
        bad.append(f"the tiers differ beyond the move rule's part: {lock}")
    if bad:
        print(f"{head} FAILED: {bad}")
        failures.append(f"{head}: {bad}")
    return total


def _load_local_plans(device, path: str, head: str) -> tuple:
    """(rows, row count, density plan, project plan) that
    _record_local_plans saved at `path`, on `device`; raises if a window
    reaches a padding row."""
    from pdb_sph_tpu_torch.ops import cuda_pbf

    z = torch.load(path)
    p4, n = z["p4"].to(device), z["n"]
    plan_d, plan_p = (cuda_pbf.WindowPlan(
        ranges=z[f"{k}_ranges"].to(device),
        n_overflow=torch.zeros((), dtype=torch.int32, device=device),
        seg_prefix=z[f"{k}_seg_prefix"].to(device),
        seg_len=z[f"{k}_seg_len"].to(device)) for k in ("d", "p"))
    lens = (plan_d.ranges[..., 1] - plan_d.ranges[..., 0]).sum(dim=1)
    print(f"{head}: {n} rows ({z['valid']} valid, the rest padding), "
          f"{lens.numel()} chunks, {int((lens > 0).sum())} with candidates "
          f"for the density forms; no window reaches the padding: "
          f"{int(plan_d.ranges[..., 1].max()) <= z['valid']}")
    if int(plan_d.ranges[..., 1].max()) > z["valid"] \
            or int(plan_p.ranges[..., 1].max()) > z["valid"]:
        raise AssertionError(f"{head}: a window reaches a padding row")
    return p4, n, plan_d, plan_p


def phase_tier_kernels(device, cfg, path: str, D: int, rank: int,
                       witnesses: dict) -> dict:
    """The nine forms on the local set and restricted plans that rank
    `rank` of D built at the compact tier's first step (saved at `path` by
    _record_local_plans): against their plain versions at the restricted
    checks' tolerances, the project forms with mxu_proj with the float64
    witness (_proj_witness, into `witnesses`), two launches bitwise equal,
    the counters back at 0, each timed (no bound: work.py counts no pairs
    of a rank's local set). Returns {counter: (max|err|, ms, plain ms,
    None)}."""
    head = f"[tiers] dam1m D={D}"
    p4, n, plan_d, plan_p = _load_local_plans(
        device, path, f"{head} compact tier, rank {rank}'s local set at "
                      f"step {RANK_MARKS[-1]}")
    tag = f" compact tier rank {rank}:"
    fp, d_k = _fp32_kernels(cfg, p4, plan_d, n, RANK_MARKS[-1], 1,
                            plan_p=plan_p, tag=tag, head=head)
    fp.update(_tc_kernels(cfg, p4, d_k, plan_d, n, RANK_MARKS[-1], 1,
                          plan_p=plan_p, tag=tag, head=head,
                          witnesses=witnesses))
    return fp


def _check_switches(card: str, ranks: list[dict]) -> None:
    from pdb_sph_tpu_torch.geometry import KernelGeometry

    base = ranks[0]["switches"]["default geometry"]
    for name, s in ranks[0]["switches"].items():
        share = abs(s["mean_density"] - base["mean_density"]) \
            / base["mean_density"]
        stats = torch.tensor(s["stats"])
        print(f"[nccl] dam1m D={len(ranks)} {name}: {NCCL_SWITCH_STEPS} "
              f"graph steps from the spawn on {card}: stats "
              f"{s['stats']}; mean rho {s['mean_density']:.2f} vs the "
              f"default geometry's {base['mean_density']:.2f} "
              f"({100 * share:.3f} %, within {100 * DENS_MEAN_RTOL:g} %); "
              f"max speed {s['max_speed']:.4f}; launches a rank "
              f"{[r['switches'][name]['launches'] for r in ranks]}")
        if stats[:, 1:].sum() or not share <= DENS_MEAN_RTOL \
                or torch.tensor(s["diag"])[:, 1:].sum():
            raise AssertionError(f"[nccl] {name}: stats or density")
        want = _launches(NCCL_SWITCH_STEPS + WARMUP_STEPS,
                         geom=KernelGeometry(**s["switches"]),
                         ranks=len(ranks))
        for r in ranks:
            _check_launches(f"[nccl] {name}", r["switches"][name]["launches"],
                            want)


def _check_large(card: str, ranks: list[dict], n: int, wall: float) -> None:
    big = ranks[0]["large"]
    rate = SCALE_STEPS / big["secs"]
    stats = torch.tensor(big["stats"])
    print(f"[nccl] dam2m D={len(ranks)} n={n} wall={wall} on {card}: "
          f"{SCALE_STEPS} graph steps after a {SCALE_SETTLE}-step settle "
          f"chunk in {big['secs']:.4f} s = {rate:.2f} steps/s = {rate * n:.1f} "
          f"particle-steps/s (rank 0's clock); stats {big['stats']}; finite "
          f"{big['finite']}; in [-{BOX_MARGIN}, wall + {BOX_MARGIN}]^3 "
          f"{big['in_box']}; escaped {big['n_escaped']}; max speed "
          f"{big['max_speed']:.4f}; mean rho {big['mean_density']:.2f}, max "
          f"|rho/rho0 - 1| {big['max_density_err']:.4f}; slab bounds "
          f"{big['slab_bounds']}; peak memory allocated a rank "
          f"{[round(r['large']['peak_gib'], 3) for r in ranks]} GiB")
    if stats[:, :, 1:].sum() or int(stats[-1, :, 0].sum()) != n \
            or not big["finite"] or not big["in_box"] or big["n_escaped"] \
            or big["nan"] or big["n"] != n:
        raise AssertionError(f"[nccl] dam2m: state or stats are wrong: {big}")


def _check_cell(card: str, ranks: list[dict], n: int, table: dict) -> None:
    c = ranks[0]["cell"]
    print(f"[nccl] cell backend D={len(ranks)} n={n} on {card}, table "
          f"{table}: graphs (window, cell) {c['graphed']}; "
          f"{len(c['errs'])} steps, each from the window backend's state: "
          f"max|dx| vs window and coordinates outside rtol {ORACLE_RTOL:g} "
          f"atol {ORACLE_ATOL:g} {c['errs']}; stats {c['stats']}")
    if not all(c["graphed"]) or any(bad for _, bad in c["errs"]) \
            or any(sum(row[1:]) for s in c["stats"] for row in s):
        raise AssertionError("[nccl] the cell backend left the window's")


def _tier_caps(pcfg) -> list:
    return [pcfg.capacity, pcfg.ghost_capacity, pcfg.mig_capacity]


def phase_nccl_cli(card: str, D: int, out_dir: str,
                   failures: list) -> dict:
    """The runner on D cards at the row's size with the JAX tier flags:
    metrics, frames, a GIF and a checkpoint, the re-tier at
    NCCL_CLI_RETIER; its resume past --retier-at, which re-tiers at once
    and ends on a partial chunk; then from the run's checkpoint a compact
    tier whose ghost buffers overflow (it falls back to the spawn tier,
    rc 0) and one with forced migration overflow (rc 2). Each `retier`
    record's capacities are ParallelConfig.compact's on the state the
    rank saved at the re-tier; each tier a rank runs captures one graph
    and allocates one pair-kernel scratch (the programs of a tier are built
    at its first chunk, so a resume that re-tiers at once builds the
    compact tier alone), counted inside the rank. A run that fails a check
    adds to `failures`; the next run goes on. Returns the ranks' summed
    launches."""
    import pdb_sph_tpu_torch as pbf
    from pdb_sph_tpu_torch import cli, interop
    from pdb_sph_tpu_torch.parallel import sharded

    n, wall = NCCL_ROWS["dam1m"]
    cfg = _nccl_cfg(n, wall)
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    ck, fr = os.path.join(out_dir, "ck.npz"), os.path.join(out_dir, "fr")
    gif = os.path.join(out_dir, "run.gif")
    common = ["--devices", str(D), "--device", "cuda"]
    retier = ["--retier-at", str(NCCL_CLI_RETIER)]
    forced = ["--resume", ck, "--steps", str(NCCL_CLI_FORCED_STEPS),
              "--metrics-every", str(NCCL_CLI_EVERY), "--retier-at",
              str(NCCL_CLI_STEPS)]
    end = NCCL_CLI_STEPS
    # name -> (argv, forced overflow, rc, the steps of its progress
    # records, its events, graph captures = scratches a rank)
    runs = {
        "run": (["--scene", "dam_break", "--n", str(n), "--wall", str(wall),
                 "--grid-width", str(NCCL_TABLE["grid_width"]), "--steps",
                 str(end), "--metrics-every", str(NCCL_CLI_EVERY),
                 "--render-every", str(NCCL_CLI_RENDER), "--width", "320",
                 "--height", "240", "--out", fr, "--gif", gif,
                 "--checkpoint", ck, *retier, *JAX_TIER_FLAGS], "", 0,
                list(range(NCCL_CLI_EVERY, end + 1, NCCL_CLI_EVERY)),
                ["retier"], 2),
        "resume": (["--resume", ck, "--steps", str(NCCL_CLI_RESUME),
                    "--chunk", str(NCCL_CLI_CHUNK), "--metrics-every",
                    str(NCCL_CLI_CHUNK), *retier], "", 0,
                   [end + NCCL_CLI_CHUNK, end + NCCL_CLI_RESUME],
                   ["retier"], 1),
        "ghost_fallback": (forced, "ghost", 0,
                           list(range(end + NCCL_CLI_EVERY,
                                      end + NCCL_CLI_FORCED_STEPS + 1,
                                      NCCL_CLI_EVERY)),
                           ["retier", "tier_fallback"], 2),
        "migration_overflow": (forced, "migration", 2,
                               [end + NCCL_CLI_EVERY], ["retier"], 1)}
    total: dict = {}
    real = cli._mesh_rank
    for name, (argv, force, want_rc, steps, tier_events, tiers) in \
            runs.items():
        counts = os.path.join(out_dir, f"counts_{name}")
        os.makedirs(counts)
        metrics = os.path.join(out_dir, f"{name}.jsonl")
        os.environ[RANK_COUNTS_ENV] = counts
        os.environ[RANK_FORCE_ENV] = force
        cli._mesh_rank = _counted_mesh_rank
        try:
            t0 = time.perf_counter()
            rc = cli.main(argv + common + ["--metrics", metrics])
            secs = time.perf_counter() - t0
        finally:
            cli._mesh_rank = real
            os.environ.pop(RANK_COUNTS_ENV, None)
            os.environ.pop(RANK_FORCE_ENV, None)
        per_rank = []
        for r in range(D):
            with open(os.path.join(counts, f"rank{r}.json")) as f:
                per_rank.append(json.load(f))
        with open(metrics) as f:
            records = [json.loads(line) for line in f]
        prog = [r for r in records if r["event"] == "progress"]
        tier_recs = [r for r in records
                     if r["event"] in ("retier", "tier_fallback")]
        # a record off the diagnostics cadence carries no density
        dens = [p for p in prog if "mean_density" in p][-1]
        done = records[-1]
        print(f"[nccl] runner D={D} {name}: {' '.join(argv + common)}"
              f"{f' (forced {force} overflow on the compact tier)' if force else ''}"
              f": rc {rc} in {secs:.1f} s; steps {[p['step'] for p in prog]}; "
              f"{done.get('steps_per_sec', 0):.2f} steps/s over the run "
              f"({done.get('wall_seconds', 0):.3f} s, frames, GIF and "
              f"checkpoint included), median chunk "
              f"{statistics.median(p['steps_per_sec'] for p in prog):.2f} "
              f"steps/s on {card}; chunk rates by step "
              f"{[(p['step'], round(p['steps_per_sec'], 2)) for p in prog]}; "
              f"last record: active {prog[-1]['per_shard_active']}, "
              f"overflows {prog[-1]['overflows']}; mean rho "
              f"{dens['mean_density']:.2f} at step {dens['step']}; tier "
              f"records {[{k: v for k, v in t.items() if k != 'geom'} for t in tier_recs]}"
              f"; captures and scratches a rank "
              f"{[(c['captures'], c['scratches']) for c in per_rank]}")
        bad = []
        if rc != want_rc or [p["step"] for p in prog] != steps \
                or [t["event"] for t in tier_recs] != tier_events:
            bad.append(f"rc {rc}, steps {[p['step'] for p in prog]}, tier "
                       f"records {tier_recs}")
        if want_rc == 0 and done["event"] != "done":
            bad.append(f"last record {done}")
        if any(c["captures"] != tiers or c["scratches"] != tiers
               for c in per_rank):
            bad.append(f"not {tiers} captures and scratches a rank (one a "
                       f"tier): {per_rank}")
        # the state each retier record sized its tier from, as rank 0 saw
        # it, sized again here; the old tier is the spawn tier of the run's
        # start (the spawn, or the resumed checkpoint)
        retier_rec = tier_recs[0] if tier_recs else {"capacity": []}
        st = interop.state_from_numpy(*torch.load(
            os.path.join(counts, "retier0.pt")), 0, "cpu")
        old = sharded.ParallelConfig.create(
            cfg, D, state=pbf.spawn(cfg, "dam_break", seed=0, device="cpu")
            if name == "run" else st)
        want = _tier_caps(sharded.ParallelConfig.compact(cfg, D, state=st,
                                                         prior=old))
        if force == "ghost":
            want[1] = max(128, want[1] // 4 // 128 * 128)
        got = [list(x) for x in zip(retier_rec["capacity"],
                                    retier_rec.get("ghost_capacity", []),
                                    retier_rec.get("mig_capacity", []))]
        if got != [_tier_caps(old), want] or retier_rec.get("step") != (
                NCCL_CLI_RETIER if name == "run" else end) \
                or st.x.shape[0] != n:
            bad.append(f"retier record {retier_rec}, tiers "
                       f"{[_tier_caps(old), want]}")
        clean = prog if not force else prog[1:]
        if any(p["nan_detected"] or any(p["overflows"]) or p["n_escaped"]
               or sum(p["per_shard_active"]) != n for p in clean):
            bad.append("a record with NaN, overflow, escapes or lost "
                       "particles")
        if force and not any(prog[0]["overflows"]):
            bad.append("no overflow on the forced compact tier")
        if bad:
            print(f"[nccl] runner D={D} {name} FAILED: {bad}")
            failures.append(f"runner D={D} {name}: {bad}")
        for c in per_rank:
            for k, v in c["launches"].items():
                total[k] = total.get(k, 0) + v
    want_png = [f"frame_{s:06d}.png"
                for s in range(0, NCCL_CLI_STEPS + 1, NCCL_CLI_RENDER)]
    if sorted(os.listdir(fr)) != want_png or not os.path.getsize(gif):
        failures.append(f"runner D={D}: frames {sorted(os.listdir(fr))}")
    return total


def _soak_rank(group, device, workdir: str, plans: str, plans_rank: int,
                *args) -> None:
    """A rank of launch.rollout_ranks (launch._rollout_rank with `args`)
    that then takes one eager step from the state its last chunk left, rank
    `plans_rank` saving at `plans` the local set and plans its solve runs
    on (_record_local_plans), and releases the rollout. That step's
    launches come after the rank has written its counts. Each stage leaves
    a note (launch.note) with its seconds."""
    from pdb_sph_tpu_torch.parallel import launch
    from pdb_sph_tpu_torch.utils.timing import fence

    roll, sst = launch._rollout_rank(group, device, workdir, *args)
    undo = _record_local_plans(plans) if group.rank == plans_rank \
        else (lambda: None)
    try:
        roll.stepper.step(sst)
        fence(device)
        launch.note(workdir, group.rank, "the eager step from the last "
                                         "state")
    finally:
        undo()
        roll.release()
    del roll, sst
    launch.note(workdir, group.rank, "released the rollout")


def phase_soak(device, card: str, out_dir: str, failures: list
               ) -> tuple[dict, dict]:
    """[soak]: each leg of SOAK_LEGS on SOAK_D NCCL ranks, one card each,
    through the graph (launch.rollout_ranks' rank, _soak_rank), within
    SOAK_TIMEOUT_S; parallel.soak.check's invariants after every chunk, one
    line a chunk; each rank's stages with their seconds (launch.note); the
    final mean density against a one-card graph Rollout's from the same
    spawn at the same step (within DENS_MEAN_RTOL); each rank's launches,
    K1 lambda and K2 3 a step and its warm-up steps, K1 rho once a chunk;
    K1 lambda, K2 and K1 rho on rank SOAK_RANK's local set at the last
    state against their plain versions. Failures go to `failures`.
    Returns (the legs' launches summed over the ranks, {leg: the kernels'
    figures})."""
    import pdb_sph_tpu_torch as pbf
    from pdb_sph_tpu_torch.parallel import launch, soak

    D = SOAK_D
    total = dict.fromkeys(KERNELS, 0)
    kern = {}
    for scene, (chunks, retier, limit) in SOAK_LEGS.items():
        if scene == "dam_break":
            n, wall = NCCL_ROWS["dam1m"]
            cfg = _nccl_cfg(n, wall)
        else:
            _, n, wall = SCALE_ROWS["blowup1m"]
            cfg = pbf.blowup_config(n=n, wall=wall, **NCCL_TABLE)
        head = f"[soak] {scene} D={D}"
        st = pbf.spawn(cfg, scene, seed=0, device="cpu")
        plans = os.path.join(out_dir, f"soak_{scene}_plans.pt")
        arrays = tuple(t.numpy() for t in st[:3])
        with tempfile.TemporaryDirectory(prefix="soak_") as workdir:
            try:
                launch.run(_soak_rank, D, [f"cuda:{r}" for r in range(D)],
                           comm="nccl", timeout_s=SOAK_TIMEOUT_S,
                           workdir=workdir,
                           args=(plans, SOAK_RANK, cfg, arrays,
                                 list(chunks), "window", None, retier))
            except launch.RankFailure as e:
                print(f"{head} FAILED: {e}")
                failures.append(f"{head}: {e}")
                continue
            got, ranks = launch.read_chunks(workdir, D, len(chunks))
            for r in range(D):
                with open(os.path.join(workdir, f"notes{r}.txt")) as f:
                    print(f"{head} rank {r} stages (seconds from its start): "
                          + "; ".join(f.read().splitlines()))
        rows, bad = soak.check(cfg, D, st, got, chunks, retier, limit)
        for r, ch in zip(rows, got):
            print(f"{head} step {r['step']} {r['tier']} tier: "
                  f"balance_min_over_mean {r['balance']:.6f}, max/mean "
                  f"{r['imbalance']:.6f}, max speed {r['max_speed']:.4f}, "
                  f"mean rho {_weighted_density(ch.stats, ch.density):.2f}"
                  f", boundary moves {r['moves']}, narrowest slab "
                  f"{r['min_slab']} keys")
        steps = sum(chunks)
        tiers = 1 + (retier is not None)
        for r, counts in enumerate(ranks):
            try:
                _check_launches(f"{head} rank {r}", counts,
                                _launches(steps + WARMUP_STEPS * tiers,
                                          rho=len(chunks), ranks=D))
            except AssertionError as e:
                bad.append(str(e))
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v

        # the one-card graph rollout from the same spawn
        roll = pbf.make_rollout(cfg, "window", NCCL_STEPS, with_stats=True,
                                device=device)
        ref = type(st)(*(t.to(device) for t in st))
        sums = torch.zeros((3,), dtype=torch.int32, device=device)
        for done in range(0, steps, NCCL_STEPS):
            ref, s_k = roll(ref, min(NCCL_STEPS, steps - done))
            sums += s_k
        d = pbf.diagnostics_fn(cfg, ref, roll.stepper.scratch)
        ref_rho = float(d.mean_density)
        mine = _weighted_density(got[-1].stats, got[-1].density)
        share = abs(mine - ref_rho) / ref_rho
        if not share <= DENS_MEAN_RTOL or sums.tolist() != [0, 0, 0] \
                or int(ref.step) != steps:
            bad.append(f"mean rho {mine:.2f} vs one card's {ref_rho:.2f}, "
                       f"one card's stats {sums.tolist()}")
        print(f"{head} on {card}: n={n} wall={wall}, chunks {list(chunks)}"
              f", re-tier before chunk {retier}; {steps} steps; final mean "
              f"rho {mine:.2f} vs one card's graph Rollout {ref_rho:.2f} at "
              f"step {int(ref.step)} "
              f"({100 * share:.4f} %, within {100 * DENS_MEAN_RTOL:g} %; "
              f"one card's stats {sums.tolist()}, max speed "
              f"{float(d.max_speed):.4f}); "
              f"launches a rank {[_nonzero(c) for c in ranks]}; checks "
              + ("pass" if not bad else f"FAILED: {bad}"))
        del roll, ref
        torch.cuda.empty_cache()
        try:
            p4, n_loc, plan_d, plan_p = _load_local_plans(
                device, plans, f"{head} rank {SOAK_RANK}'s local set at "
                               f"step {steps}")
            kern[scene], _ = _fp32_kernels(
                cfg, p4, plan_d, n_loc, steps, 1, plan_p=plan_p,
                tag=f" rank {SOAK_RANK}, last state:", head=head)
            del p4, plan_d, plan_p
        except AssertionError as e:
            bad.append(f"the kernels: {e}")
        if bad:
            failures.append(f"{head}: {bad}")
    return total, kern


def main_ranks(n_ranks: int) -> int:
    """The [nccl] mode: phases 1-2, then the sharded rollout on NCCL ranks
    at D = 2 and D = `n_ranks` (the D = 4 parts at the largest), each with
    its [tiers] part; the kernels line of the mode's paths, each kernel
    measured on the compact tier's local set of rank TIER_RANK of D =
    `n_ranks`."""
    if torch.cuda.device_count() < n_ranks:
        print(f"chip_smoke: --ranks {n_ranks} needs {n_ranks} cards, torch "
              f"sees {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke_nccl")
    os.makedirs(out_dir, exist_ok=True)
    card = phase_device()
    phase_build()
    import pdb_sph_tpu_torch as pbf

    def mark(what: str) -> None:
        print(f"[time] {what}: {time.perf_counter() - t_start:.1f} s from "
              "the start of the script", flush=True)

    n, wall = NCCL_ROWS["dam1m"]
    cfg = _nccl_cfg(n, wall)
    refs, state60 = _stepper_refs(
        device, cfg, (*RANK_MARKS, RANK_MARKS[-1] + NCCL_STEPS),
        keep=SETTLE_STEPS)
    # the pair kernels on a rank's restricted plans at the row's size
    restricted = phase_restricted(device, state60, cfg, max(NCCL_DS),
                                  NCCL_RESTRICTED_RANK, head="[nccl] dam1m")
    del state60
    torch.cuda.empty_cache()
    phase_nccl_single(device, card)
    torch.cuda.empty_cache()
    mark("the one-card references, restricted plans and D = 1")

    # the cell table of phase_cell, sized from the 80k spawn
    cfg0 = pbf.default_config(n=N_MAIN)
    table, _, _ = _cell_table(cfg0, pbf.spawn(cfg0, "dam_break", seed=0,
                                              device=device).x)
    n2, wall2 = NCCL_ROWS["dam2m"]
    plans = os.path.join(out_dir, "tiers_plans.pt")
    # every path's launches, summed over its ranks, and of them the compact
    # tier's in [tiers]
    launches, compact = dict.fromkeys(KERNELS, 0), dict.fromkeys(KERNELS, 0)

    def add(into: dict, counts: dict) -> None:
        for k, v in counts.items():
            into[k] = into.get(k, 0) + v

    # the [tiers] checks and the runner's report their failures here, so
    # that one run shows every one of them; the script fails at its end
    failures: list = []
    tier_kern, witnesses = None, {}
    for D in sorted({*NCCL_DS, n_ranks}):
        if D > n_ranks:
            continue
        got, st = phase_two_ranks(device, card, cfg, D, "nccl",
                                  [f"cuda:{r}" for r in range(D)], refs,
                                  head="[nccl] dam1m",
                                  compact_steps=NCCL_STEPS)
        add(launches, got)
        mark(f"D = {D} rollout_ranks")
        state = os.path.join(out_dir, f"tiers_state_d{D}.pt")
        torch.save(tuple(t.cpu() for t in st[:3]), state)
        extra = {"tiers": {"n": n, "wall": wall, "state": state,
                           "steps": NCCL_STEPS}}
        if D == n_ranks:
            extra["tiers"].update(plans=plans, plans_rank=TIER_RANK)
            extra.update({
                "switch_steps": NCCL_SWITCH_STEPS,
                "large": {"row": "dam2m", "n": n2, "wall": wall2,
                          "settle": SCALE_SETTLE, "steps": SCALE_STEPS},
                "cell": {"n": N_MAIN, "table": table, "steps": CELL_STEPS}})
        ranks = phase_nccl(card, D, extra)
        for r in ranks:
            add(launches, r["graph_launches"])
        got = phase_tiers(card, D, ranks, n, failures)
        add(launches, got)
        add(compact, got)
        mark(f"D = {D} [nccl] ranks and [tiers]")
        if D == n_ranks:
            _check_switches(card, ranks)
            _check_large(card, ranks, n2, wall2)
            _check_cell(card, ranks, N_MAIN, table)
            for r in ranks:
                for s in r["switches"].values():
                    add(launches, s["launches"])
            try:
                tier_kern = phase_tier_kernels(device, cfg, plans, D,
                                               TIER_RANK, witnesses)
            except AssertionError as e:
                failures.append(f"[tiers] the nine forms: {e}")
            mark("[tiers] the nine forms")
    runner = phase_nccl_cli(card, n_ranks, os.path.join(out_dir, "cli"),
                            failures)
    add(launches, runner)
    print(f"[nccl] the runner's launches summed over ranks and runs: "
          f"{_nonzero(runner)}")
    mark("the runner")
    # last, so that a soak that stalls keeps nothing else from running;
    # card 0's cache goes first, for rank 0
    torch.cuda.empty_cache()
    soak, soak_kern = phase_soak(device, card, out_dir, failures)
    add(launches, soak)
    mark("[soak]")
    if failures:
        raise AssertionError(f"{len(failures)} checks failed: {failures}")
    origin = ("rollout_ranks with its compact chunk, the graph runs of "
              "[nccl], [tiers]' compact tier, the switch geometries, "
              "[soak]'s two legs, the runner's four runs; summed over the "
              "ranks")
    report = [
        {"name": KERNELS[k][0], "route": "cuda", "source": KERNELS[k][1],
         "replaces": KERNELS[k][2], "launches": launches[k],
         "launches_from": origin, "launches_compact_tier": compact[k],
         "max_abs_err": tier_kern[k][0], "ms": tier_kern[k][1],
         "plain_ms": tier_kern[k][2], "library_ms": None,
         "measured_on": f"the compact tier's local set of rank {TIER_RANK} "
                        f"of D = {n_ranks}, dam1m, step {RANK_MARKS[-1]}",
         "restricted_spawn_ms": restricted[k],
         "launches_soak": soak[k],
         "soak_last_state": {
             leg: dict(zip(("max_abs_err", "ms", "plain_ms"), figs[k]))
             for leg, figs in soak_kern.items() if k in figs},
         **({"float64_witness": witnesses[k]} if k in witnesses else {})}
        for k in KERNELS]
    if any(r["launches"] <= 0 for r in report):
        raise AssertionError(f"a kernel was not launched: {report}")
    print(f"[done] {time.perf_counter() - t_start:.1f} s from the start of "
          "the script")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=0,
                    help="run phases 1-2 and the [nccl] phases on this many "
                         "NCCL ranks, one card each (0: the one-card run)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import pdb_sph_tpu_torch  # noqa: F401  (fails before any output if absent)

    if args.ranks:
        return main_ranks(args.ranks)

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from pdb_sph_tpu_torch.geometry import KernelGeometry

    tc_geom = KernelGeometry(**ALL_SWITCHES)
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build")
    card = phase_device()
    phase_build()
    fin = phase_finalize(device)
    plan_ms = phase_plan(device)
    kern, state60 = phase_kernels(device)
    owns = phase_c2(device, state60)
    restricted = phase_restricted(device, state60)
    del state60
    phase_oracle(device)
    launches = phase_main(device, card)
    tc_main = phase_main(device, card, geom=tc_geom)
    short = {}
    for switches in ONE_SWITCH_GEOMS:
        got = phase_main(device, card, KernelGeometry(**switches),
                         steps=SHORT_STEPS)
        short.update({k: v for k, v in got.items() if k in TC_FORMS and v})
    phase_graph(device)
    phase_graph(device, geom=tc_geom)
    fast = phase_fastpath(device, card)
    ranks, _ = phase_two_ranks(device, card)
    phase_cell(device, os.path.join(build_dir, "chip_smoke_cell"))
    phase_backends(device, card)
    phase_settle(device)
    tc_settle = phase_settle(device, geom=tc_geom)
    phase_settle(device, geom=KernelGeometry(seg=WITNESS_SEG))
    phase_settle(device, geom=KernelGeometry(**ALL_SWITCHES, seg=WITNESS_SEG))
    rho, tc_cli = phase_cli(device, os.path.join(build_dir, "chip_smoke_cli"))

    scale_kern = phase_scale_kernels(device)
    dam1m = phase_scale_rollout(device, card, "dam1m")
    dam1m_tc = phase_scale_rollout(device, card, "dam1m", geom=tc_geom)
    share = abs(dam1m_tc["mean_density"] - dam1m["mean_density"]) \
        / dam1m["mean_density"]
    print(f"[scale] dam1m mean rho at step {dam1m['step']}: every switch on "
          f"{dam1m_tc['mean_density']:.2f} vs the default geometry "
          f"{dam1m['mean_density']:.2f} ({100 * share:.3f} %, within "
          f"{100 * DENS_MEAN_RTOL:g} %); max speed "
          f"{dam1m_tc['max_speed']:.4f} vs {dam1m['max_speed']:.4f}")
    if dam1m_tc["step"] != dam1m["step"] or not share <= DENS_MEAN_RTOL:
        raise AssertionError("dam1m: the tensor-core forms' mean density "
                             "left the default geometry's")
    dam2m = phase_scale_rollout(device, card, "dam2m")
    blowup = phase_scale_blowup(device, card)
    scale_cli = phase_scale_cli(
        device, os.path.join(build_dir, "chip_smoke_scale", "cli"))
    _, n1m, wall1m = SCALE_ROWS["dam1m"]
    fast1m = phase_fastpath(device, card, n1m, wall1m,
                            head="[scale] dam1m fastpath:")
    scale = [dam1m["launches"], dam1m_tc["launches"], dam2m["launches"],
             blowup, scale_cli, fast1m]

    # the solve kernels of the default geometry and of every switch on
    solve = [k for k in _launches(1) if k in KERNELS]
    tc_solve = [k for k in _launches(1, geom=tc_geom) if k in KERNELS]
    origin = {k: "phase 5 + sharded phases + [scale]" for k in solve}
    for k in solve:
        launches[k] += fast[k] + ranks[k]
    launches["density_rho"] = rho + ranks["density_rho"]
    origin["density_rho"] = ("phase 7 + the two ranks' diagnostics + "
                             "[scale]'s diagnostics and runner")
    for k in tc_solve:
        launches[k] = tc_main[k] + tc_settle[k] + tc_cli[k]
        origin[k] = "phases 5-7 + [scale] dam1m"
    for k in set(TC_FORMS) - set(tc_solve):
        launches[k] = short[k]
        origin[k] = f"phase 5 ({SHORT_STEPS}-step rollout)"
    for k in KERNELS:
        launches[k] += sum(run[k] for run in scale)
    # no single PyTorch call computes a windowed neighbour sum, so no
    # kernel has a library time
    report = [
        {"name": KERNELS[k][0], "route": "cuda", "source": KERNELS[k][1],
         "replaces": KERNELS[k][2], "launches": launches[k],
         "launches_from": origin[k], "max_abs_err": kern[k][0],
         "ms": kern[k][1], "plain_ms": kern[k][2],
         # the least time of pbfbench/work.py's flops (None for K1 rho)
         "bound_ms": kern[k][3], "library_ms": None,
         f"ms_step{SETTLED_STEP}": kern[k][4],
         f"bound_ms_step{SETTLED_STEP}": kern[k][5],
         "restricted_ms": restricted[k],
         "own_ms": {str(own): owns[own][k] for own in C2_OWNS},
         # the 1M dam break at step 60
         "ms_1m": scale_kern[k][1], "bound_ms_1m": scale_kern[k][2],
         "max_abs_err_1m": scale_kern[k][0]}
        for k in KERNELS
    ]
    # finalize: once a step on every path that steps; bitwise the chain
    # (phase_finalize raises otherwise), so its error is 0
    fin_runs = [launches, tc_main, fast, ranks, *scale]
    report.append({
        "name": "finalize_kernel", "route": "cuda",
        "source": "pdb_sph_tpu_torch/csrc/pbf_finalize.cu",
        "replaces": "none: the JAX package's finalize is plain XLA "
                    "(pdb_sph_tpu/ops/collide.py)",
        "launches": sum(run["finalize"] for run in fin_runs),
        "launches_from": "phase 5's two geometries, the fast paths, the "
                         "two ranks, [scale]'s rollouts, blowup and runner",
        "max_abs_err": 0.0, "ms": fin[(N_MAIN, SETTLE_STEPS)][0],
        "plain_ms": fin[(N_MAIN, SETTLE_STEPS)][1],
        "bound_ms": fin[(N_MAIN, SETTLE_STEPS)][2], "bound_by": "bytes",
        "library_ms": None,
        f"ms_step{SETTLED_STEP}": fin[(N_MAIN, SETTLED_STEP)][0],
        f"bound_ms_step{SETTLED_STEP}": fin[(N_MAIN, SETTLED_STEP)][2],
        "ms_1m": fin[(n1m, SETTLE_STEPS)][0],
        "plain_ms_1m": fin[(n1m, SETTLE_STEPS)][1],
        "bound_ms_1m": fin[(n1m, SETTLE_STEPS)][2], "bound_by_1m": "bytes",
        f"ms_1m_step{SETTLED_STEP}": fin[(n1m, SETTLED_STEP)][0]})
    # the plan's two kernels: once a step and a diagnostic record on every
    # path that steps the window backend; bitwise the plain plan
    # (phase_plan raises otherwise); ms of one plan, both kernels
    for kernel, key in (("plan_windows_kernel", "plan"),
                        ("work_table_kernel", "work_table")):
        report.append({
            "name": kernel, "route": "cuda",
            "source": "pdb_sph_tpu_torch/csrc/pbf_plan.cu",
            "replaces": "none: the JAX package's build_plan and "
                        "restrict_plan are plain XLA "
                        "(pdb_sph_tpu/ops/pallas_pbf.py:101-263)",
            "launches": sum(run.get(key, 0) for run in fin_runs),
            "launches_from": "phase 5's two geometries, the fast paths, "
                             "the two ranks, [scale]'s rollouts, blowup "
                             "and runner",
            "max_abs_err": 0.0, "plan_ms": plan_ms[N_MAIN][0],
            "plain_plan_ms": plan_ms[N_MAIN][1], "bound_by": "latency",
            "library_ms": None, "plan_ms_1m": plan_ms[n1m][0],
            "plain_plan_ms_1m": plan_ms[n1m][1]})
    if any(r["launches"] <= 0 for r in report):
        raise AssertionError(f"a kernel was not launched: {report}")
    print(f"[done] {time.perf_counter() - t_start:.1f} s from the start of "
          "the script")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
