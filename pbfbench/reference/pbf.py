"""The plain reference of a Position Based Fluids step, in plain torch.

One step of the solver that a configuration file states (Macklin and
Muller, "Position Based Fluids", SIGGRAPH 2013, as the CUDA solver of
github.com/jakymiws/pdb-sph writes it: src/FluidSimulator.cu:198-445):

    predict       v1 = (v + dt g) damp,  p = x + dt v1
    cell sort     cells of side h on the configuration's neighbour grid,
                  x fastest, each axis clamped into the grid; stable sort
    solve         `solver_iters` Jacobi iterations over the pairs within h
                  of the 27 cells around each particle's predicted cell:
                    rho_i  = poly6 sum_j (h^2 - r^2)^3
                    lam_i  = -(rho_i / rho0 - 1)
                             / (c^2 sum_j (h - r)^4 r^2 + eps_relax)
                    p_i   += -c sum_j (h - r)^2 (lam_i + lam_j + s_corr) d_ij
                  with d_ij = p_i - p_j, r = |d_ij|, c = spiky / rho0 (the
                  CUDA solver's gradient takes d_ij, not its unit vector)
    finalize      v = (p - x) / dt, then the six walls in the CUDA solver's
                  order (y low, y high, x low, z low, x high, z high), each
                  reading what the one before wrote: a particle past a wall
                  and moving out of the box is rewound by (1 - damp_c) t v
                  (t = its time since impact), mirrored in the wall, its
                  normal velocity reflected and all of it damped by damp_c;
                  then every coordinate is clamped into [0, wall]

It reads the configuration's constants only, and shares no code with the
program under test. Each pair's terms are float32, the precision the
configuration states; a particle's sums over its pairs are taken in float64
and rounded once, so that the reference's own rounding stays well below the
program's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import neighbours

# a particle this close to a wall when the wall is tested may bounce in one
# float32 rounding of its position and not in another: the bounce rewinds
# it by (1 - damp_c) t v, with t = (its overshoot) / (its normal velocity),
# which stays finite as both go to 0, so its position jumps by up to 70 % of
# the step's motion. 1e-5 is ten float32 units of a coordinate at 4.64, and
# ten times the sound program's usual gap from this reference
WALL_EPS = 1e-5


def f32(x: float) -> float:
    return float(np.float32(x))


class Constants:
    """The solver's constants from a configuration's fields, each rounded
    to float32 once."""

    def __init__(self, c: dict):
        self.n = int(c["n"])
        self.wall = f32(c["wall"])
        self.dt = f32(c["dt"])
        self.iters = int(c["solver_iters"])
        self.h = f32(c["h"])
        self.h2 = f32(c["h"] * c["h"])
        self.rho0 = c["rho0"]
        self.inv_rho0 = f32(1.0 / c["rho0"])
        self.eps_relax = f32(c["relaxation_eps"])
        self.s_corr = f32(c["s_corr"])
        self.gravity_step = f32(f32(c["dt"]) * f32(c["gravity"]))
        self.damp = f32(c["velocity_damp"])
        self.coll_damp = f32(c["collision_damp"])
        pi = c["kernel_pi"]
        h = c["h"]
        if c["use_reference_poly6_norm"]:
            self.poly6 = f32(4.0 / (pi * h ** 8))
        else:
            self.poly6 = f32(315.0 / (64.0 * math.pi * h ** 9))
        spiky = 45.0 / (pi * h ** 6)
        self.grad2 = f32((spiky / c["rho0"]) ** 2)
        self.k_proj = f32(-spiky / c["rho0"])
        self.strict = bool(c["strict_reference_collide"])
        # the neighbour grid: cells of side nb_cell >= h over the box and
        # four cells beyond it, within the configuration's outer grid
        nb = c["nb_cell_size"] if c["nb_cell_size"] > 0 else h
        extent = min(c["grid_width"] * c["cell_size"], c["wall"] + 4.0 * nb)
        self.inv_cell = f32(1.0 / nb)
        self.width = max(1, int(math.ceil(extent / nb - 1e-9)))


def predict(k: Constants, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    g = torch.tensor([0.0, k.gravity_step, 0.0], dtype=x.dtype,
                     device=x.device)
    v1 = (v + g) * k.damp
    return x + k.dt * v1


def cell_of(k: Constants, p: torch.Tensor) -> torch.Tensor:
    """(n,) int64 neighbour-grid cell of each position (a NaN coordinate
    counts as 0)."""
    w = k.width
    ijk = torch.nan_to_num(p * k.inv_cell, nan=0.0).clamp(0, w - 1).long()
    return ijk[:, 0] + w * (ijk[:, 1] + w * ijk[:, 2])


def _lambda(k: Constants, grid, q: torch.Tensor) -> torch.Tensor:
    n = q.shape[0]
    rho = torch.zeros(n, dtype=torch.float64, device=q.device)
    g2 = torch.zeros_like(rho)
    for i, _, _, rd2 in neighbours.near_pairs(grid, q, k.h2):
        t = k.h2 - rd2
        u = k.h - torch.sqrt(rd2)
        rho.index_add_(0, i, (t * t * t).double())
        g2.index_add_(0, i, (u * u * u * u * rd2).double())
    rho = k.poly6 * rho.float()
    c = rho * k.inv_rho0 - 1.0
    return -c / (k.grad2 * g2.float() + k.eps_relax)


def _project(k: Constants, grid, q: torch.Tensor,
             lam: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros((q.shape[0], 3), dtype=torch.float64, device=q.device)
    for i, j, d, rd2 in neighbours.near_pairs(grid, q, k.h2):
        u = k.h - torch.sqrt(rd2)
        s = u * u * (lam[i] + lam[j] + k.s_corr)
        acc.index_add_(0, i, (s[:, None] * d).double())
    return q + k.k_proj * acc.float()


def _walls(k: Constants, p: torch.Tensor, v: torch.Tensor):
    """(positions, velocities, whether each particle was within WALL_EPS of
    a wall when that wall was tested)."""
    at_wall = torch.zeros(p.shape[0], dtype=torch.bool, device=p.device)
    for axis, upper in ((1, False), (1, True), (0, False), (2, False),
                        (0, True), (2, True)):
        w = k.wall if upper else 0.0
        pa, va = p[:, axis], v[:, axis]
        at_wall |= (pa - w).abs() <= WALL_EPS
        past = pa > w if upper else pa < w
        if k.strict:
            hit = past & (va != 0)
        else:
            hit = past & (va > 0 if upper else va < 0)
        t = (pa - w) / torch.where(hit, va, torch.ones_like(va))
        rewound = p - v * ((1.0 - k.coll_damp) * t)[:, None]
        rewound[:, axis] = 2.0 * w - rewound[:, axis]
        flipped = v.clone()
        flipped[:, axis] = -flipped[:, axis]
        p = torch.where(hit[:, None], rewound, p)
        v = torch.where(hit[:, None], flipped * k.coll_damp, v)
    if not k.strict:
        p = p.clamp(0.0, k.wall)
    return p, v, at_wall


def step(config: dict, x: torch.Tensor, v: torch.Tensor,
         ids: torch.Tensor) -> dict:
    """One step from positions `x`, velocities `v` and particle ids `ids`
    (any order, float32, on any device). Returns the next state in cell
    order, as the CUDA solver leaves it: `x`, `v`, `ids`, `nonfinite` (a
    bool: some coordinate of x or v is not finite) and `at_wall` (each
    particle within WALL_EPS of a wall when the wall was tested)."""
    k = Constants(config)
    p = predict(k, x, v)
    cell = cell_of(k, p)
    cell, order = torch.sort(cell, stable=True)
    grid = neighbours.make_grid(cell, k.width)
    last = x[order]
    q = p[order]
    for _ in range(k.iters):
        q = _project(k, grid, q, _lambda(k, grid, q))
    v_new = (q - last) / k.dt
    x_new, v_new, at_wall = _walls(k, q, v_new)
    finite = bool(torch.isfinite(x_new).all() and torch.isfinite(v_new).all())
    return {"x": x_new, "v": v_new, "ids": ids[order], "nonfinite": not finite,
            "at_wall": at_wall}
