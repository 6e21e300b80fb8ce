"""Checkpoint / resume in the JAX package's npz format v1.

The same file layout as `pdb_sph_tpu/io/checkpoint.py`, so a checkpoint
carries across the two packages in both directions:

- `x`, `v`, `ids`, `step`, `format_version` and `config_json` (the config's
  fields as JSON) are the JAX package's keys.
- `config_json` carries no `geom`: the JAX loader builds its
  `KernelGeometry(**geom)` from that key, and the port's geometry (`own`,
  `seg`, the tensor-core switches) has other fields. Without the key the
  JAX package takes its default geometry.
- The port's `KernelGeometry` goes under a key of its own,
  `torch_geom_json`, which the JAX loader never reads; a file written
  before the geometry had the tensor-core switches loads with them off,
  and one written while it had a `tile` (the tensor-core kernels' staging
  round before they shared the FP32 kernels' ring) loads without it.
  A file without the key (one the JAX package wrote) takes `own` and the
  `mxu_*` switches from the JAX file's `geom` and drops its other fields
  (`interop.config_from_fields`), so a JAX run with `PBF_MXU_*` set
  resumes on the tensor-core kernels.

Writes are atomic: a temporary file in the same directory, renamed over the
target, so a partly written checkpoint is never visible.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

import numpy as np
import torch

from .. import interop
from ..config import SimConfig
from ..geometry import KernelGeometry
from ..state import SimState
from ..utils.platform import resolve_device

FORMAT_VERSION = 1
GEOM_KEY = "torch_geom_json"
# fields an older port geometry carried that no kernel reads any more
RETIRED_GEOM_FIELDS = ("tile",)


def _json_bytes(obj) -> np.bytes_:
    return np.bytes_(json.dumps(obj).encode())


def save(path: str, cfg: SimConfig, state: SimState) -> None:
    """Atomically write state + config to an .npz file."""
    fields = dataclasses.asdict(cfg)
    geom = fields.pop("geom")
    x, v, ids, step = interop.state_to_numpy(state)
    payload = {
        "x": x,
        "v": v,
        "ids": ids,
        "step": step,
        "format_version": np.int32(FORMAT_VERSION),
        "config_json": _json_bytes(fields),
        GEOM_KEY: _json_bytes(geom),
    }
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load(path: str, device: torch.device | str = "cuda"
         ) -> tuple[SimConfig, SimState]:
    """(config, state on `device`, the card unless the caller asks for the
    CPU) from a checkpoint of either package."""
    with np.load(path, allow_pickle=False) as z:
        version = int(z["format_version"])
        if version != FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {version}")
        cfg = interop.config_from_fields(
            json.loads(bytes(z["config_json"]).decode()))
        if GEOM_KEY in z.files:
            geom = json.loads(bytes(z[GEOM_KEY]).decode())
            for key in RETIRED_GEOM_FIELDS:
                geom.pop(key, None)
            geom = KernelGeometry(**geom)
            cfg = dataclasses.replace(cfg, geom=geom)
        arrays = [z[k] for k in ("x", "v", "ids", "step")]
    cfg.validate()
    if arrays[0].shape != (cfg.n, 3):
        raise ValueError(f"checkpoint shape {arrays[0].shape} inconsistent "
                         f"with n={cfg.n}")
    return cfg, interop.state_from_numpy(*arrays,
                                         device=resolve_device(device))
