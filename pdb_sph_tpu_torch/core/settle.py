"""The settle gate: the long-horizon physics check of the device kernels.

The port of `benchmarks/settle_check.py`. Parity tests on the CPU compute
in float32 and cannot see a precision fault that only the device has: on
the TPU, a reduced-precision rd2 kept the fluid agitated forever while
every CPU parity test passed. An 8k dam break run 2000 steps on the window
backend must come to rest:

- mean all-pairs (dense) density within 5 % of rho0 — the settled 8k dam
  rests a few percent over rho0 (hydrostatic compression at 3 Jacobi
  iterations), and the dense oracle measures it with no neighbour
  structure of its own;
- max speed below 0.5 — the sharp signal: the precision fault kept it far
  above;
- nothing escaped, the stats summed over every step `[0, 0, 0]` (no
  overflow, no non-finite step), and no NaN in the final state.

Run it on the card with `python -m pdb_sph_tpu_torch.core.settle`
(`chip_smoke.py` runs it as a phase).
"""

from __future__ import annotations

import sys
import time

import torch

from ..config import default_config
from ..geometry import KernelGeometry
from ..models.scenes import spawn
from ..ops import dense
from ..utils.platform import resolve_device
from ..utils.timing import fence
from .step import diagnostics_fn, make_rollout

RHO_BAND = 0.05   # |mean rho / rho0 - 1| must stay below this
MAX_SPEED = 0.5   # max |v| must stay below this
CHUNK = 100       # steps per Rollout call; the stats are read once a chunk


def settled(mean_density: float, rho0: float, max_speed: float,
            n_escaped: int, stats: list[int], nan: bool) -> bool:
    """The gate's criteria (benchmarks/settle_check.py:50-51), with the
    chunk-summed stats in place of the plan overflow alone."""
    return (abs(mean_density / rho0 - 1.0) < RHO_BAND
            and max_speed < MAX_SPEED and n_escaped == 0
            and list(stats) == [0, 0, 0] and not nan)


def settle_check(device: torch.device | str, n: int = 8192,
                 steps: int = 2000,
                 geom: KernelGeometry | None = None) -> dict:
    """Run the seed-0 dam break `steps` steps on the window backend, in
    Rollout calls of CHUNK steps, and measure the final state. Returns
    the numbers and the verdict (`ok`). `geom` selects the kernels' geometry
    (e.g. the tensor-core forms); None takes the config's default."""
    device = resolve_device(device)
    cfg = default_config(n=n, **({} if geom is None else {"geom": geom}))
    state = spawn(cfg, "dam_break", seed=0, device=device)
    stats = torch.zeros((3,), dtype=torch.int32, device=device)
    rollout = make_rollout(cfg, "window", CHUNK, with_stats=True,
                           device=device)
    t0 = time.perf_counter()
    done = 0
    while done < steps:
        chunk = min(CHUNK, steps - done)
        state, chunk_stats = rollout(state, chunk)
        stats += chunk_stats
        done += chunk
    fence(device)
    seconds = time.perf_counter() - t0

    d = diagnostics_fn(cfg, state, rollout.stepper.scratch)
    out = {
        "n": n,
        "step": int(state.step),
        "mean_density": float(dense.density_dense(cfg, state.x).mean()),
        "rho0": cfg.rho0,
        "max_speed": float(d.max_speed),
        "n_escaped": int(d.n_escaped),
        "stats": stats.tolist(),
        "nan": bool(d.nan_detected),
        "seconds": seconds,
    }
    out["ok"] = settled(out["mean_density"], out["rho0"], out["max_speed"],
                        out["n_escaped"], out["stats"], out["nan"])
    return out


def format_result(r: dict) -> str:
    return (f"step {r['step']}: mean dense rho {r['mean_density']:.1f} "
            f"(rho0 {r['rho0']:.0f}) maxv {r['max_speed']:.4f} escaped "
            f"{r['n_escaped']} stats {r['stats']} nan {r['nan']} "
            f"({r['n']} particles, {r['seconds']:.2f} s)\n"
            f"SETTLE CHECK: {'PASS' if r['ok'] else 'FAIL'}")


def main() -> int:
    r = settle_check("cuda")
    print(format_result(r))
    return 0 if r["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
