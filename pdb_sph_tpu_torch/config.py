"""Simulation configuration of the PyTorch port.

A field-for-field copy of `pdb_sph_tpu.config.SimConfig` with every derived
constant, so that the two packages compare field by field
(`tests/test_torch_config.py`). Only `geom` differs: it holds the launch
geometry of the CUDA kernels (`geometry.KernelGeometry`), built by
`geometry_from_env` when no `geom` is given, as in the JAX package.
`cell_capacity` and `max_occupied_cells` size the cell table of the `cell`
backend (`ops/hashgrid.py`), as in the JAX package; `block` configures the
JAX package's Pallas pair block, is inert here and is kept so that configs
carry across (`interop.config_from_fields`).

Importing this module must not import `pdb_sph_tpu`, whose package
`__init__` imports jax.
"""

from __future__ import annotations

import dataclasses
import math

from .geometry import KernelGeometry, geometry_from_env

# float32 pi of the CUDA reference's kernels (src/FluidSimulator.cu:234
# `float _pi = 3.141592f`)
REF_PI = 3.141592

SCENES = ("standard", "dam_break", "blowup")


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Every constant of the PBF solver (defaults: the reference's)."""

    n: int = 80_000
    cell_size: float = 0.2
    grid_width: int = 40

    dt: float = 0.0086
    solver_iters: int = 3

    h: float = 0.1
    rho0: float = 6378.0
    relaxation_eps: float = 600.0
    s_corr: float = 1e-4
    gravity: float = -9.8
    velocity_damp: float = 0.99
    collision_damp: float = 0.3
    wall: float = 2.0

    # the reference's 2-D poly6 norm 4/(pi h^8), self-consistent with rho0
    use_reference_poly6_norm: bool = True
    # reference wall test (`v != 0`, no final clamp); ops/collide.py
    strict_reference_collide: bool = False

    nb_cell_size: float = 0.0   # 0.0 -> h
    cell_capacity: int = 128    # cell-table slots per cell (`cell` backend)
    max_occupied_cells: int = 4096  # cell-table rows (`cell` backend)
    block: int = 128            # inert here (JAX Pallas pair block)

    # PBF_* environment variables are construct-time defaults only
    # (pdb_sph_tpu/config.py:85-91)
    geom: KernelGeometry = dataclasses.field(
        default_factory=geometry_from_env)

    @property
    def domain_extent(self) -> float:
        return self.grid_width * self.cell_size

    @property
    def nb_cell(self) -> float:
        return self.nb_cell_size if self.nb_cell_size > 0.0 else self.h

    @property
    def nb_domain_extent(self) -> float:
        """The internal neighbour grid covers the box plus four cells of
        margin; `cell_ids` clamps into it (pdb_sph_tpu/config.py:105-119)."""
        return min(self.domain_extent, self.wall + 4.0 * self.nb_cell)

    @property
    def nb_grid_width(self) -> int:
        return max(1, int(math.ceil(self.nb_domain_extent / self.nb_cell
                                    - 1e-9)))

    @property
    def num_nb_cells(self) -> int:
        w = self.nb_grid_width
        return w * w * w

    @property
    def h2(self) -> float:
        return self.h * self.h

    @property
    def inv_rho0(self) -> float:
        return 1.0 / self.rho0

    @property
    def poly6_coeff(self) -> float:
        h = self.h
        if self.use_reference_poly6_norm:
            return 4.0 / (REF_PI * h**8)
        return 315.0 / (64.0 * math.pi * h**9)

    @property
    def spiky_grad_coeff(self) -> float:
        return 45.0 / (REF_PI * self.h**6)

    @property
    def lambda_grad_coeff(self) -> float:
        return self.spiky_grad_coeff * self.inv_rho0

    def validate(self) -> None:
        if self.n <= 0:
            raise ValueError(f"n must be positive, got {self.n}")
        if self.h <= 0 or self.cell_size <= 0:
            raise ValueError("h and cell_size must be positive")
        if self.nb_cell < self.h:
            raise ValueError(
                f"nb_cell ({self.nb_cell}) must be >= h ({self.h}) so the "
                "27-cell stencil covers the full interaction radius"
            )
        if self.cell_capacity % self.block != 0:
            raise ValueError(
                f"cell_capacity ({self.cell_capacity}) must be a multiple of "
                f"block ({self.block})"
            )
        self.geom.validate()


def default_config(**overrides) -> SimConfig:
    cfg = SimConfig(**overrides)
    if "max_occupied_cells" not in overrides:
        occ = min(cfg.n, cfg.num_nb_cells)
        cfg = dataclasses.replace(
            cfg, max_occupied_cells=max(8, min(4096, -(-occ // 8) * 8))
        )
    cfg.validate()
    return cfg


def blowup_config(**overrides) -> SimConfig:
    overrides.setdefault("cell_capacity", 256)
    return default_config(**overrides)
