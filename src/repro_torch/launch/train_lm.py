"""End-to-end program: train a ~100M-param LM for a few hundred steps, the
twin of the JAX package's ``examples/train_lm.py``.

The model is the smollm-360m family scaled to ~100M params (same GQA
ratios, vocab, structure).  The full pipeline is real: parallel columnar
ingest, packing loader, the train step with AdamW + remat, async
single-file checkpoints every 50 steps, crash-safe resume.

``--tiny`` swaps in a ~10M model.  ``--device`` defaults to ``cuda`` and
raises without a card; ``--device cpu`` runs the kernels' plain versions.
``main(argv)`` returns the loop.

Run:  PYTHONPATH=src python -m repro_torch.launch.train_lm [--steps 300] \
          [--tiny] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchConfig
from repro_torch.models.registry import build, model_device
from repro_torch.pipeline import PackedLoader, ingest_corpus, synth_corpus
from repro_torch.train import LoopConfig, TrainLoop, make_optimizer


def lm_100m() -> ArchConfig:
    """~100M params: smollm family, scaled."""
    return get_arch("smollm-360m").with_(
        name="smollm-100m", n_layers=12, d_model=640, n_heads=10,
        n_kv_heads=5, head_dim=64, d_ff=1792,
    )


def lm_10m() -> ArchConfig:
    return get_arch("smollm-360m").with_(
        name="smollm-10m", n_layers=6, d_model=192, n_heads=6, n_kv_heads=2,
        head_dim=32, d_ff=512, vocab_size=16384, remat=False,
    )


def main(argv=None) -> TrainLoop:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = model_device(args.device)
    work = args.workdir or tempfile.mkdtemp(prefix="repro_torch_train_lm_")
    os.makedirs(work, exist_ok=True)
    data = os.path.join(work, "corpus.rntj")
    cfg = lm_10m() if args.tiny else lm_100m()
    bundle = build(cfg)
    print(f"model {cfg.name}: {cfg.param_count()/1e6:.1f}M params")

    if not os.path.exists(data):
        ingest_corpus(synth_corpus(3000, seed=args.seed, mean_len=300,
                                   vocab=cfg.vocab_size),
                      data, n_workers=4, device=dev)
    loader = PackedLoader(data, batch=args.batch, seq_len=args.seq,
                          device=dev)
    loop = TrainLoop(
        bundle, loader, os.path.join(work, "ckpt"),
        config=LoopConfig(steps=args.steps, ckpt_every=50, log_every=10),
        optimizer=make_optimizer(peak_lr=1e-3, warmup=30, total=args.steps),
        device=dev, seed=args.seed,
    )
    if loop.step:
        print(f"resuming from step {loop.step}")
    hist = loop.run()
    first10 = sum(h.loss for h in hist[:10]) / max(len(hist[:10]), 1)
    last10 = sum(h.loss for h in hist[-10:]) / max(len(hist[-10:]), 1)
    print(f"loss: first-10 avg {first10:.3f} -> last-10 avg {last10:.3f}")
    print(f"workdir: {work}")
    return loop


if __name__ == "__main__":
    main()
