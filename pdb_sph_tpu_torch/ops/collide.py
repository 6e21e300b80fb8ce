"""Finalize: velocity update and the ordered 6-wall collision response.

The torch counterpart of `pdb_sph_tpu/ops/collide.py`, which documents the
semantics: the reference's sequential wall order (each wall reads what the
previous one wrote), a bounce only on outward velocity and a final clamp,
or with `strict_reference_collide` the reference's `v != 0` test and no
clamp.

`finalize` dispatches on the device: a CPU tensor goes to the plain torch
chain `finalize_ref`; a CUDA tensor launches the hand-written kernel of
`csrc/pbf_finalize.cu`, or raises. The kernel runs the whole chain in one
pass, bit for bit, and raises the step's non-finite flag as it goes, which
its result carries (`Finalized.nonfinite`); `nonfinite` is the flag's
plain version. Each launch counts in `cuda_pbf.LAUNCHES["finalize"]`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SimConfig
from . import cuda_pbf
from .smoothing import f32

# (axis, is_upper) in the reference's order (src/FluidSimulator.cu:362-439)
_WALL_ORDER = ((1, False), (1, True), (0, False), (2, False), (0, True),
               (2, True))


class Finalized(tuple):
    """The kernel's result: the pair (x, v), which unpacks as such, and
    `nonfinite`, a (1,) int32 on their device: 1 if a coordinate of x or v
    is not finite, else 0."""

    def __new__(cls, x: torch.Tensor, v: torch.Tensor,
                nonfinite: torch.Tensor):
        self = super().__new__(cls, (x, v))
        self.nonfinite = nonfinite
        return self


def nonfinite(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(1,) int32: 1 if a coordinate of x or v is not finite, else 0."""
    finite = torch.isfinite(x).all() & torch.isfinite(v).all()
    return (~finite).to(torch.int32)[None]


def _bounce(cfg: SimConfig, pos, vel, axis: int, upper: bool):
    w = f32(cfg.wall if upper else 0.0)
    cd = f32(cfg.collision_damp)
    pa, va = pos[:, axis], vel[:, axis]
    if cfg.strict_reference_collide:
        hit = (pa > w if upper else pa < w) & (va != 0.0)
    else:
        hit = (pa > w) & (va > 0.0) if upper else (pa < w) & (va < 0.0)

    t_coll = (pa - w) / torch.where(va == 0.0, torch.ones_like(va), va)
    pos_rw = pos - vel * (f32(1.0 - cd) * t_coll)[:, None]
    pos_rw[:, axis] = 2.0 * w - pos_rw[:, axis]
    vel_rf = vel.clone()
    vel_rf[:, axis] = vel_rf[:, axis] * -1.0
    vel_rf = vel_rf * cd

    pos = torch.where(hit[:, None], pos_rw, pos)
    vel = torch.where(hit[:, None], vel_rf, vel)
    return pos, vel


def finalize_ref(cfg: SimConfig, p: torch.Tensor, last_frame: torch.Tensor):
    """The plain torch chain: v = (p - last_frame)/dt, then the 6
    sequential wall responses and the clamp."""
    v = (p - last_frame) / f32(cfg.dt)
    for axis, upper in _WALL_ORDER:
        p, v = _bounce(cfg, p, v, axis, upper)
    if not cfg.strict_reference_collide:
        p = torch.clamp(p, 0.0, f32(cfg.wall))
    return p, v


def _rows(name: str, t: torch.Tensor, n: int, device) -> int:
    """The row stride of `t`, an (n, 3) float32 on `device` whose columns
    are adjacent; raise on any other layout."""
    if t.dtype != torch.float32 or t.device != device \
            or tuple(t.shape) != (n, 3) or t.stride(1) != 1 \
            or t.stride(0) < 3:
        raise ValueError(f"{name} must be ({n}, 3) float32 rows on {device} "
                         f"with adjacent columns, got {tuple(t.shape)} "
                         f"{t.dtype} {t.device} strides {t.stride()}")
    return t.stride(0)


def finalize(cfg: SimConfig, p: torch.Tensor, last_frame: torch.Tensor):
    """v = (p - last_frame)/dt, then the 6 sequential wall responses.

    Returns new tensors (x_new, v_new); `p` and `last_frame` are not
    written, so they may be views of reused buffers. CPU: finalize_ref.
    CUDA: `csrc/pbf_finalize.cu`, which reads `p` as rows of any stride
    (the (n, 3) view of the solve's (n_pad, 4) buffer, or contiguous rows)
    and returns a `Finalized` that carries the non-finite flag; or
    raise."""
    if p.device.type == "cpu":
        return finalize_ref(cfg, p, last_frame)
    if p.device.type != "cuda":
        raise ValueError(f"no kernel for device {p.device}")
    from ..utils.cuda_build import load_kernels

    n = p.shape[0]
    p_stride = _rows("p", p, n, p.device)
    last_stride = _rows("last_frame", last_frame, n, p.device)
    kernels = load_kernels()
    x = torch.empty((n, 3), dtype=torch.float32, device=p.device)
    v = torch.empty_like(x)
    flag = torch.zeros((1,), dtype=torch.int32, device=p.device)
    # PyTorch's CUDA division by a host scalar multiplies by the float32
    # reciprocal, which the chain's velocity therefore reads
    inv_dt = float(np.float32(1.0) / np.float32(cfg.dt))
    code = kernels.lib.launch_finalize(
        p.data_ptr(), p_stride, last_frame.data_ptr(), last_stride,
        x.data_ptr(), v.data_ptr(), flag.data_ptr(), n, inv_dt,
        f32(cfg.wall), f32(1.0 - f32(cfg.collision_damp)),
        f32(cfg.collision_damp), int(cfg.strict_reference_collide),
        torch.cuda.current_stream(p.device).cuda_stream)
    kernels.check(code, "launch_finalize")
    cuda_pbf.count_launch("finalize", "launch_finalize")
    return Finalized(x, v, flag)
