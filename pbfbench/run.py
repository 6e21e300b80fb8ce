"""Run one cell of the benchmark on the card and print its result line.

    python3 pbfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. One run is one process: it imports the port
(`pdb_sph_tpu_torch`, never JAX or the JAX package), makes the inputs from
the seed, loads the port's kernel library (built into `build/kernels/` in
the checkout by the first run), runs one segment of the cell's traffic
untimed, measures whole segments for `--seconds`, checks what the program
produced against the plain reference, and prints one JSON line last on
standard output, each number compared beside its limit last on standard
error. Without as many cards as the cell asks for it exits 3 and prints no
result; with JAX loaded once the window has closed, 4.

A cell whose configuration has a `parallel` entry (dam1m_d4.rollout, four
cards) runs on the rank path (`ranks.py`): this process starts one process
a rank through the program's launcher (`parallel/launch.py`, NCCL, one card
each), which set up, measure and check together; rank 0's clock times the
window, and this process prints the result line from what the ranks leave.
A rank that raises or stalls fails the run (exit 1, no result, no rank left
running). With `--trace 1` each rank writes its own trace,
`build/pbfbench/trace_<cell>.rank<r>.json`.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every compiler cache at a fixed path inside the checkout
CACHES = {"TRITON_CACHE_DIR": "triton",
          "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "cuda",
          "PYTORCH_KERNEL_CACHE_PATH": "torch_kernels"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "pbfbench" / "cache" / sub)
    sys.path.insert(0, str(ROOT))
    from pbfbench import harness

    cell = harness.find_cell(args.workload)
    import torch

    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"{args.workload} needs {chips} CUDA card(s); "
                    f"torch.cuda.is_available() is "
                    f"{torch.cuda.is_available()}, device_count "
                    f"{torch.cuda.device_count()}")
        return 3
    torch.set_num_threads(1)
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), device="cuda", t_start=T_START)
    found = harness.jax_modules()
    if found:
        harness.log(f"loaded in the benchmark's process: {found}")
        return 4
    for name, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        harness.log(f"check {name} {c['value']!r} limit {c['limit']!r} "
                    f"{verdict}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
