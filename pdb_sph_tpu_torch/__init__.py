"""pdb_sph_tpu_torch — the PyTorch / CUDA port of pdb_sph_tpu.

Position Based Fluids (Macklin & Muller, SIGGRAPH 2013) on one NVIDIA
Hopper card: the same scenes, step and rollout as the JAX package, with its
two Pallas pair kernels, and their tensor-core forms, rewritten by hand in
CUDA C++ (`csrc/`). The JAX package stays the reference; this package
imports torch and numpy and never jax.
"""

from .config import SimConfig, default_config, blowup_config, SCENES
from .geometry import KernelGeometry, geometry_from_env
from .state import SimState, StepDiagnostics, make_state
from .models.scenes import spawn
from .core.step import diagnostics_fn, make_step, make_rollout

__version__ = "0.1.0"

__all__ = [
    "SimConfig",
    "KernelGeometry",
    "geometry_from_env",
    "SimState",
    "StepDiagnostics",
    "SCENES",
    "default_config",
    "blowup_config",
    "make_state",
    "spawn",
    "make_step",
    "make_rollout",
    "diagnostics_fn",
]
