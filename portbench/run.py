"""The benchmark's one command, run from the root of a checkout:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``portbench/workloads`` on the card and prints its
result as the last line of standard output (see README.md).  Exits with
another code than 0, and prints no result, without a card (or with fewer
than the cell asks for) and where ``jax``, ``jaxlib``, ``flax`` or
``repro`` are loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the checkout's own caches, at fixed paths inside it
    os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / "build" / "triton")
    os.environ.pop("REPRO_TORCH_BUILD_DIR", None)
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(CHECKOUT / "src"), str(CHECKOUT)]

    import torch

    from portbench import harness, spec

    cell, _cfg, _traffic = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    line = harness.run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), T_START)
    print(f"card: {harness.card()}", file=sys.stderr)
    found = harness.barred_modules()
    if found:
        print(f"modules the benchmark bars are loaded: {found}", file=sys.stderr)
        return 3
    harness.print_result(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
