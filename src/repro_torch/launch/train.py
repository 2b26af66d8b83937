"""Training launcher, the twin of ``repro.launch.train`` on one card.

Ingests a synthetic corpus into ``--data`` when the file is missing (on
``--device``), then trains ``--arch`` with ``TrainLoop``: AdamW steps on
the packing loader's device engine, a checkpoint every ``--ckpt-every``
steps, and a restart from the newest committed checkpoint in
``--ckpt-dir`` when there is one.  ``--device`` defaults to ``cuda`` and
raises without a card; ``--device cpu`` runs the kernels' plain versions.
Parameters are random, drawn from ``--seed``.  There is no mesh on one
card: ``--production-mesh`` raises ``NotImplementedError``.

``main(argv)`` returns the loop (its ``history``, ``params``, ``saves``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
      --smoke --steps 50 --data corpus.rntj --ckpt-dir ckpt --device cpu
"""

from __future__ import annotations

import argparse
import os
import tempfile
from pathlib import Path

from repro_torch.configs import ARCHS, get_arch, smoke_config
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
                    help="the 16x16 production mesh (not on one card)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    if args.production_mesh:
        raise NotImplementedError(
            "--production-mesh: the port trains on one card; the mesh comes "
            "with the distributed slice (ROADMAP Queue 1 item 4)")
    dev = model_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_arch(args.arch)
    bundle = build(cfg)

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
        device=dev, seed=args.seed,
    )
    if loop.step:
        print(f"restored from checkpoint at step {loop.step}")
    history = loop.run()
    print(f"done: step {loop.step}, "
          f"loss {history[0].loss:.3f} -> {history[-1].loss:.3f}")
    return loop


if __name__ == "__main__":
    main()
