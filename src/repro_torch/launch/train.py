"""Training launcher, the twin of ``repro.launch.train`` on one card.

Ingests a synthetic corpus into ``--data`` when the file is missing (on
``--device``), then trains ``--arch`` with ``TrainLoop``: AdamW steps on
the packing loader's device engine, a checkpoint every ``--ckpt-every``
steps, and a restart from the newest committed checkpoint in
``--ckpt-dir`` when there is one.  ``--device`` defaults to ``cuda`` and
raises without a card; ``--device cpu`` runs the kernels' plain versions.
Parameters are random, drawn from ``--seed``.  The loop trains on
``make_local_mesh(device=--device)``, a mesh over the world
``torch.distributed`` was started with (a one-rank group when there is
none: NCCL on the card, gloo on the CPU), as the reference does;
``--production-mesh`` builds the 16 x 16 production mesh and raises its
world-size error unless 256 ranks run.  The launcher prints the
dry-run's per-rank bytes of the train state and of the step's peak on its
mesh, and on the card refuses a run whose peak exceeds the card's memory
(``RuntimeError``, before anything is drawn).

``main(argv)`` returns the loop (its ``history``, ``params``, ``saves``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
      --smoke --steps 50 --data corpus.rntj --ckpt-dir ckpt --device cpu
"""

from __future__ import annotations

import argparse
import math
import os
import tempfile
from pathlib import Path

import torch

from repro_torch.configs import ARCHS, get_arch, smoke_config
from repro_torch.distributed.sharding import AxisRules, _axes
from repro_torch.launch.dryrun import train_memory
from repro_torch.launch.mesh import (
    describe, make_local_mesh, make_production_mesh, mesh_shape,
)
from repro_torch.models.registry import build, model_device
from repro_torch.pipeline import PackedLoader, ingest_corpus, synth_corpus
from repro_torch.train import LoopConfig, TrainLoop, make_optimizer


def main(argv=None) -> TrainLoop:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="smollm-360m")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--data", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_corpus.rntj"))
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--production-mesh", action="store_true",
                    help="use the 16x16 production mesh (needs 256 ranks)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = model_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_arch(args.arch)
    bundle = build(cfg)
    mesh = (make_production_mesh(device=dev) if args.production_mesh
            else make_local_mesh(device=dev))
    check_fits(cfg, bundle, mesh, args, dev)

    if not Path(args.data).exists():
        print(f"ingesting synthetic corpus -> {args.data}")
        ingest_corpus(
            synth_corpus(2000, seed=args.seed, mean_len=256,
                         vocab=cfg.vocab_size),
            args.data, n_workers=4, device=dev,
        )
    loader = PackedLoader(args.data, batch=args.batch, seq_len=args.seq,
                          device=dev)

    loop = TrainLoop(
        bundle, loader, args.ckpt_dir,
        config=LoopConfig(
            steps=args.steps, ckpt_every=args.ckpt_every,
            grad_compression=args.grad_compression,
            microbatches=args.microbatches,
        ),
        optimizer=make_optimizer(peak_lr=args.lr, warmup=20, total=args.steps),
        device=dev, seed=args.seed, mesh=mesh,
    )
    if loop.step:
        print(f"restored from checkpoint at step {loop.step}")
    history = loop.run()
    print(f"done: step {loop.step}, "
          f"loss {history[0].loss:.3f} -> {history[-1].loss:.3f}")
    return loop


def check_fits(cfg, bundle, mesh, args, dev) -> None:
    """Print the dry-run's per-rank train state and step peak on ``mesh``
    at this run's rows; on the card, raise ``RuntimeError`` when the peak
    exceeds the card's memory."""
    shape = mesh_shape(mesh)
    tok = bundle._token_shape(args.batch // args.microbatches, args.seq)
    row_axes = _axes(AxisRules(shape).spec(["dp"] + [None] * (len(tok) - 1),
                                           tok)[0])
    rows = tok[0] // math.prod(shape.shape[a] for a in row_axes)
    mem = train_memory(cfg, shape, rows, args.seq, args.grad_compression,
                       row_axes=row_axes)
    G = 2 ** 30
    print(f"mesh {describe(mesh)}: train state {mem['state'] / G:.3f} GiB a "
          f"rank, step peak {mem['peak_bytes'] / G:.3f} GiB (dry-run)")
    if dev.type == "cuda":
        cap = torch.cuda.get_device_properties(dev).total_memory
        if mem["peak_bytes"] > cap:
            raise RuntimeError(
                f"{cfg.name} on mesh {describe(mesh)}: the dry-run puts a "
                f"rank's train step at {mem['peak_bytes'] / G:.1f} GiB (state "
                f"{mem['state'] / G:.1f}, activations "
                f"{mem['activation_bytes'] / G:.1f}, gathered parameters "
                f"{mem['gathered_params'] / G:.1f}) and the card holds "
                f"{cap / G:.1f} GiB: train on more ranks, fewer rows a rank "
                "(--batch, --microbatches) or a smaller config")


if __name__ == "__main__":
    main()
