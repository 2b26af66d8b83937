"""AGC-style dataset skimming (paper §6.2, Fig. 5): all five strategies,
the twin of the JAX package's ``examples/skim_dataset.py``.

Builds a 9-partition synthetic dataset, runs the three combined skims
(horizontal/vertical/nested) under each writing strategy, reports runtime,
output equality and size reduction.  ``--device`` defaults to ``cuda``
and raises without a card; ``--device cpu`` runs the seal kernels' plain
versions.  ``main(argv)`` returns ``{strategy: {"kept_events", "s",
"out_mb"}}``.

Run:  PYTHONPATH=src python -m repro_torch.launch.skim [--events 20000] \
          [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

from repro_torch.kernels.ops import resolve_device
from repro_torch.skim import STRATEGIES, make_agc_dataset, skim_partitions


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--events", type=int, default=10_000)
    ap.add_argument("--partitions", type=int, default=9)
    ap.add_argument("--files-per-partition", type=int, default=4)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    work = args.workdir or tempfile.mkdtemp(prefix="repro_torch_skim_")
    print(f"building dataset ({args.partitions} partitions x "
          f"{args.files_per_partition} files x {args.events} events)...")
    parts = make_agc_dataset(os.path.join(work, "in"), args.partitions,
                             args.files_per_partition, args.events,
                             device=dev)
    in_bytes = sum(os.path.getsize(f) for fs in parts.values() for f in fs)
    print(f"input: {in_bytes/1e6:.1f} MB")

    print(f"\n{'strategy':15s} {'time':>8s} {'kept':>8s} {'out MB':>8s}")
    results = {}
    for strat in STRATEGIES:
        out = os.path.join(work, strat)
        t0 = time.perf_counter()
        res = skim_partitions(parts, out, strat, n_threads=args.threads,
                              device=dev)
        dt = time.perf_counter() - t0
        out_mb = (sum(os.path.getsize(os.path.join(out, f))
                      for f in os.listdir(out) if f.startswith("skim_")) / 1e6
                  if strat != "separate-null" else 0.0)
        results[strat] = {"kept_events": res["kept_events"], "s": dt,
                          "out_mb": out_mb}
        print(f"{strat:15s} {dt:7.2f}s {res['kept_events']:8d} {out_mb:8.2f}")

    kept = {r["kept_events"] for r in results.values()}
    if len(kept) != 1:
        raise RuntimeError(f"strategies disagree: {results}")
    print(f"\nall strategies kept the same {kept.pop()} events")
    print(f"workdir: {work}")
    return results


if __name__ == "__main__":
    main()
