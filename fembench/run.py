"""Run one cell of the port's benchmark once, on the card, and print its
result as the last line of standard output.

    python3 -m fembench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Exits non-zero with no result where there
is no CUDA card (or fewer than the cell asks for), where the port is not
the checkout's own, or where JAX or the JAX package is loaded once the
window has closed.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "hidenn_fem_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's (compared whole: the port's name starts with the latter)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from fembench import harness, spec

    bench = spec.benchmark()
    cell = spec.workload(bench, args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        harness.log(f"{args.workload} needs {cell['chips']} CUDA card(s); "
                    f"found {torch.cuda.device_count()}")
        return 2
    import hidenn_fem_tpu_torch
    here = os.path.realpath(spec.ROOT)
    if not os.path.realpath(hidenn_fem_tpu_torch.__file__).startswith(
            here + os.sep):
        harness.log("the port under test is not this checkout's: "
                    f"{hidenn_fem_tpu_torch.__file__}")
        return 2
    result = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              imports_s=time.perf_counter() - _T0)
    found = forbidden_modules()
    if found:
        harness.log(f"JAX or the JAX package was loaded: {found}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
