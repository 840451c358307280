"""The readings that a cell's correctness limits are set from: for each
seed, the numbers of the port's solves (the lower readings) and of the
control, the plain reference put in the solver's place in the precision
below the configuration's (TF32; the upper readings).  Not run by the
benchmark's own runs.

    python3 -m fembench.control --workload <name> --seeds 1 2 3 ... \
        [--solves 3]

Set-up is made once; for each seed the first ``--solves`` load cases of
that seed's window are solved through the port and judged, then the
control takes the same load cases and is judged.  One JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import spec, traffic as traffic_gen
from .harness import Phases


def readings(workload: str, seeds, solves: int, device, overrides=None):
    bench = spec.benchmark()
    cell = spec.workload(bench, workload)
    cfg = spec.config(bench, cell["config"])
    if overrides:
        cfg = dict(cfg, mesh=dict(cfg["mesh"], **overrides))
    mix = spec.traffic(cell["traffic"])
    mod = spec.module("drivers", mix["driver"])
    driver = mod.Driver(cfg, mix, torch.device(device))
    driver.setup(Phases(torch.device(device)))
    for case in traffic_gen.warmup_cases(mix, 0):
        driver.solve(case)
    kept = {}
    for seed in seeds:
        cases = traffic_gen.load_cases(mix, seed)
        kept[seed] = [driver.keep(driver.solve(next(cases)))
                      for _ in range(solves)]
        driver.program_readings(kept[seed])
    driver.release()
    for seed in seeds:
        program = mod.judge(cfg, mix, kept[seed], device)
        ctl = mod.judge(cfg, mix, mod.control(cfg, mix, kept[seed], device),
                        device)
        yield {"workload": workload, "seed": seed,
               "program": {k: max(n[k] for n in program)
                           for k in program[0]},
               "control": {k: min(n[k] for n in ctl) for k in ctl[0]}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--solves", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    for line in readings(args.workload, args.seeds, args.solves,
                         torch.device("cuda", 0)):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
