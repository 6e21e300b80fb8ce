"""Host rasterizer of the port: a native point-sprite rasterizer through
ctypes, with the same NumPy path where no C++ compiler is found.

The counterpart of `pdb_sph_tpu/render/renderer.py`. Its source,
`cpp/rasterizer.cpp` beside this module, is a byte-for-byte copy of the
JAX package's (tests/test_torch_isolation.py holds the two equal), so both
packages draw the same pixels; the port reads no file of the JAX package.
It is compiled at first use into `build/render/` under the repository root
(listed in `.gitignore`). Rendering runs on the host from numpy positions;
it is not the device path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "cpp" / "rasterizer.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "render"
# the JAX package's lazy-build flags (pdb_sph_tpu/render/renderer.py:37-40),
# so both packages draw the same pixels
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

# reference splat color (shaders/fluid.fs:16) and point size (fluid.vs:12)
COLOR = (0.53, 0.80, 0.98)
POINT_SCALE = 20.0
BACKGROUND = (0.05, 0.05, 0.08)
# a default view of the [0,2]^3 box (the reference's camera spawns at
# (-1.80, 1.48, -2.04), main.cpp:34, and is user-steered from there)
DEFAULT_EYE = (-1.8, 2.2, -2.0)
DEFAULT_TARGET = (1.0, 0.6, 1.0)
DEFAULT_FOV = 45.0

_lock = threading.Lock()
_lib = None


def _build_lib() -> Path | None:
    """The compiled library, built if needed; None without the source or a
    working g++ (the NumPy path then draws)."""
    if not SOURCE.exists():
        return None
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    out = BUILD_DIR / f"librasterizer_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return out
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None


def _get_lib():
    global _lib
    with _lock:
        if _lib is None:
            path = _build_lib()
            if path is None:
                _lib = False
            else:
                fp = ctypes.POINTER(ctypes.c_float)
                lib = ctypes.CDLL(str(path))
                lib.pbf_render_points.argtypes = [
                    fp, ctypes.c_int64, ctypes.c_int, ctypes.c_int, fp, fp,
                    ctypes.c_float, ctypes.c_float, fp, fp,
                    ctypes.POINTER(ctypes.c_ubyte),
                ]
                lib.pbf_render_points.restype = None
                _lib = lib
    return _lib


def have_native() -> bool:
    return bool(_get_lib())


def _render_numpy(pos, width, height, eye, target, fov, point_scale,
                  color, background):
    """Vectorised NumPy path (same math as rasterizer.cpp)."""
    eye = np.asarray(eye, np.float32)
    fwd = np.asarray(target, np.float32) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    cup = np.cross(right, fwd)

    d = pos - eye
    vz = d @ fwd
    vx = d @ right
    vy = d @ cup
    f = 1.0 / np.tan(np.deg2rad(fov) / 2.0)
    aspect = width / height
    ok = (vz > 0.1) & (vz < 100.0)
    vz = np.where(ok, vz, 1.0)
    sx = ((f / aspect) * vx / vz * 0.5 + 0.5) * width
    sy = (1.0 - (f * vy / vz * 0.5 + 0.5)) * height
    radius = np.maximum(0.5 * point_scale / vz, 0.5)

    img = np.empty((height, width, 3), np.float32)
    img[:] = background
    zbuf = np.full((height, width), 1e30, np.float32)

    order = np.argsort(-vz)  # far to near; z-test still applied per pixel
    for i in order:
        if not ok[i]:
            continue
        r = radius[i]
        x0, x1 = int(np.floor(sx[i] - r)), int(np.ceil(sx[i] + r))
        y0, y1 = int(np.floor(sy[i] - r)), int(np.ceil(sy[i] + r))
        x0, y0 = max(x0, 0), max(y0, 0)
        x1, y1 = min(x1, width - 1), min(y1, height - 1)
        if x1 < x0 or y1 < y0:
            continue
        xs = np.arange(x0, x1 + 1) + 0.5
        ys = np.arange(y0, y1 + 1) + 0.5
        nx = (xs - sx[i]) / r
        ny = (ys - sy[i]) / r
        m = nx[None, :] ** 2 + ny[:, None] ** 2
        hit = (m <= 1.0) & (vz[i] < zbuf[y0:y1 + 1, x0:x1 + 1])
        a = np.exp(-m * m)
        patch = img[y0:y1 + 1, x0:x1 + 1]
        patch[hit] = a[hit, None] * np.asarray(color, np.float32)
        zb = zbuf[y0:y1 + 1, x0:x1 + 1]
        zb[hit] = vz[i]
    return (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)


def render(positions, width: int = 1280, height: int = 720,
           eye=DEFAULT_EYE, target=DEFAULT_TARGET, fov: float = DEFAULT_FOV,
           point_scale: float = POINT_SCALE, color=COLOR,
           background=BACKGROUND) -> np.ndarray:
    """positions (n, 3) host array -> (height, width, 3) uint8 RGB frame."""
    pos = np.ascontiguousarray(np.asarray(positions), np.float32)
    lib = _get_lib()
    if not lib:
        return _render_numpy(pos, width, height, eye, target, fov,
                             point_scale, color, background)
    out = np.empty((height, width, 3), np.uint8)
    fp = ctypes.POINTER(ctypes.c_float)
    # keep each argument array alive until the call returns
    args = [np.ascontiguousarray(np.asarray(a, np.float32))
            for a in (eye, target, color, background)]
    lib.pbf_render_points(
        pos.ctypes.data_as(fp), pos.shape[0], width, height,
        args[0].ctypes.data_as(fp), args[1].ctypes.data_as(fp),
        ctypes.c_float(fov), ctypes.c_float(point_scale),
        args[2].ctypes.data_as(fp), args[3].ctypes.data_as(fp),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
    )
    return out
