"""State and config across the two packages, through numpy.

The JAX package's arrays reach this module as numpy arrays, so the port
never imports jax; the parity tests use these helpers so that both packages
start from the very same particles and constants.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from .config import SimConfig
from .geometry import OWNS, KernelGeometry
from .state import SimState

# the JAX KernelGeometry's fields that the port's geometry shares
GEOM_FIELDS = ("own", "mxu_sum", "mxu_rd2", "mxu_proj")
# the JAX KernelGeometry's fields that exist for the TPU kernels alone (the
# Mosaic candidate blocks, DMA ring, grid batching, shifted copies and the
# per-chunk lane budget): the port's windows are exact element ranges, so
# nothing here has a counterpart, and a value given for one is dropped
TPU_GEOM_FIELDS = ("cc_d", "cc_p", "nbuf", "gb", "maxlanes", "chains_d",
                   "chains_p", "ncopies")


def state_from_numpy(x, v, ids, step, device) -> SimState:
    """(n,3) x and v, (n,) ids and a scalar step -> SimState on `device`
    (copies: the state never shares memory with the arrays)."""
    return SimState(
        x=torch.tensor(np.asarray(x, np.float32), device=device),
        v=torch.tensor(np.asarray(v, np.float32), device=device),
        ids=torch.tensor(np.asarray(ids, np.int32), device=device),
        step=torch.tensor(np.asarray(step, np.int32), device=device),
    )


def state_to_numpy(state: SimState):
    """SimState -> (x, v, ids, step) numpy arrays on the host."""
    return tuple(t.detach().cpu().numpy() for t in state)


def port_own(own: int) -> int:
    """`own`, or the port's default where its kernels lack it (JAX allows
    e.g. 96), with a note on stderr."""
    if own in OWNS:
        return own
    print(f"note: own {own} has no kernel in the port (it has "
          f"{', '.join(map(str, OWNS))}); running own {KernelGeometry.own}",
          file=sys.stderr)
    return KernelGeometry.own


def config_from_fields(fields: dict) -> SimConfig:
    """The port's SimConfig from another SimConfig's fields.

    `fields` is e.g. `dataclasses.asdict(jax_cfg)`. Of its `geom` (the TPU
    kernel geometry, as a dict), the fields that have a counterpart here
    carry over (GEOM_FIELDS: `own` and the tensor-core switches), so a JAX
    config or checkpoint with `PBF_MXU_*` set runs the tensor-core kernels
    in the port too; every other geometry field is dropped. An `own` the
    port's kernels lack (JAX allows e.g. 96) becomes the port's default,
    with a note on stderr; `KernelGeometry.validate` stays strict for the
    port's own callers. Without `geom`, SimConfig's default factory builds
    the geometry. Unknown fields raise, so a field added to one package
    only is caught.
    """
    names = {f.name for f in dataclasses.fields(SimConfig)} - {"geom"}
    kw = {k: v for k, v in fields.items() if k != "geom"}
    unknown = set(kw) - names
    if unknown:
        raise ValueError(f"fields unknown to the port's SimConfig: "
                         f"{sorted(unknown)}")
    geom = fields.get("geom")
    if geom is not None:
        shared = {k: geom[k] for k in GEOM_FIELDS if k in geom}
        shared["own"] = port_own(shared.get("own", KernelGeometry.own))
        kw["geom"] = KernelGeometry(**shared)
    cfg = SimConfig(**kw)
    cfg.validate()
    return cfg
