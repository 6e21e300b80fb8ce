"""The readings that the limits of a cell's check are set from.

    python3 pbfbench/control.py --workload <cell> --seeds 1 2 ... \
        --control-seeds 101 102 103 [--out <file.jsonl>]

In one process on the card, for each seed: the program as the cell's
configuration states it drives one segment of the cell's traffic from the
seed's spawn (a short window at the cell's own load), then its side of the
check and the comparison with the reference run as in a benchmark run
(harness.program_side, harness.compare). Then the same for each control
seed with the control in the program's place: the program with every
tensor-core switch of its kernel geometry on, its own path that computes
the pair sums in a lower precision than float32 (bf16 hi/lo products),
the step a later change would be tempted by. Each (kind, seed) prints one
JSON line of the compared numbers. A cell on ranks (a configuration with a
`parallel` entry) runs every seed of a kind on one set of ranks
(ranks.readings): from each seed's spawn its set-up to the compact tier,
one segment, the check. The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CONTROL_GEOMETRY = {"mxu_sum": True, "mxu_rd2": True, "mxu_proj": True}


def readings(workload: str, seeds, geometry: dict | None, device: str,
             config: dict | None = None, traffic: dict | None = None):
    """Yield one dict of compared numbers a seed, for the program in the
    cell's geometry with `geometry`'s fields replaced."""
    import torch

    from pbfbench import harness

    cell = harness.find_cell(workload)
    conf = {**cell.config, **(config or {})}
    if "parallel" in conf:
        from pbfbench import ranks

        yield from ranks.readings(workload, seeds, geometry, device, config,
                                  traffic)
        return
    mix = harness.Traffic.of(cell.traffic, **(traffic or {}))
    dev = torch.device(device)
    program = harness.Program(conf, mix.steps_per_call, dev, geometry)
    host = harness.Host(conf["n"], mix, dev)
    for seed in seeds:
        t0 = time.perf_counter()
        start = harness.spawn(conf, seed, dev)
        end = harness.drive(program, start, mix, host, [], [])
        steps, _, numbers = harness.program_side(program, start, mix, seed,
                                                 [end], host, [])
        t1 = time.perf_counter()
        numbers = {**harness.compare(conf, steps, mix.gap_from), **numbers}
        yield {"workload": workload, "seed": seed,
               "control": geometry is not None,
               "phases": [s[0] for s in steps], "numbers": numbers,
               "program_s": t1 - t0,
               "reference_s": time.perf_counter() - t1}
    program.release()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    out = open(args.out, "a") if args.out else None
    try:
        for seeds, geometry in ((args.seeds, None),
                                (args.control_seeds, CONTROL_GEOMETRY)):
            if not seeds:
                continue
            for r in readings(args.workload, seeds, geometry, args.device):
                line = json.dumps(r)
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
