"""Parallel single-file checkpointing demo (the paper's technique on
training state), the twin of the JAX package's
``examples/parallel_checkpoint.py``.

Saves a ~200MB model with 1/2/4/8 writer threads into one file each,
reports wall time, lock counts and critical-section share, verifies all
restore identically, and demonstrates elastic restore (file written by 8
writers restored and re-sharded without any merge step).  The tree's
tensors live on ``--device`` (``cuda`` by default, raising without a
card; ``cpu`` when asked), and restores put them back there.
``--layers`` cuts the tree's 48 layers (the reference's fixed depth,
~20 s and 0.7 GB of files on a CPU) for a quick run.

Run:  PYTHONPATH=src python -m repro_torch.launch.parallel_checkpoint \
          [--layers 48] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.ckpt import load_checkpoint, save_checkpoint
from repro_torch.kernels.ops import resolve_device
from repro_torch.train.optimizer import tree_leaves


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=48)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    tree = {
        f"layer_{i}": {
            "w": torch.from_numpy(
                rng.normal(size=(512, 2048)).astype(np.float32)).to(dev),
            "b": torch.zeros((2048,), dtype=torch.float32, device=dev),
        }
        for i in range(args.layers)
    }
    nbytes = sum(x.numel() * x.element_size() for x in tree_leaves(tree))
    print(f"state: {nbytes/2**20:.0f} MiB")

    work = args.workdir or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    os.makedirs(work, exist_ok=True)
    print(f"\n{'writers':>8s} {'time':>8s} {'MB/s':>8s} {'locks':>7s} "
          f"{'lock-held':>10s} {'clusters':>9s}")
    paths, times = {}, {}
    for n in (1, 2, 4, 8):
        p = os.path.join(work, f"ckpt_w{n}.rntj")
        t0 = time.perf_counter()
        stats = save_checkpoint(p, tree, n_writers=n, row_block_bytes=2 << 20,
                                device=dev)
        dt = time.perf_counter() - t0
        paths[n], times[n] = p, dt
        held_frac = stats["lock_held_ms"] / (dt * 1e3)
        print(f"{n:8d} {dt:7.2f}s {nbytes/2**20/dt:8.1f} "
              f"{stats['lock_acquisitions']:7d} {held_frac:9.1%} "
              f"{stats['clusters']:9d}")

    print("\nverifying all layouts restore identically...")
    ref, _ = load_checkpoint(paths[1], target_tree=tree, device=dev)
    for n, p in paths.items():
        got, _ = load_checkpoint(p, target_tree=tree, device=dev)
        for a, b in zip(tree_leaves(ref), tree_leaves(got)):
            if not torch.equal(a, b):
                raise RuntimeError(f"the {n}-writer checkpoint restores "
                                   "differently")
    print("OK: single self-describing file per run, no merge step, "
          "restore is writer-count-agnostic (elastic).")
    print(f"workdir: {work}")
    return {"bytes": nbytes, "seconds": times, "paths": paths}


if __name__ == "__main__":
    main()
