"""Quickstart: the whole main path in one program, the twin of the JAX
package's ``examples/quickstart.py``.

1. Ingest a synthetic tokenized corpus with 4 parallel writers -> ONE file.
2. Train a reduced gemma-2b (head dim 32) for 30 steps, checkpoints
   every 10.
3. Kill/restart: resume from the committed checkpoint mid-epoch.
4. Serve: prefill + greedy decode; log generations through the parallel
   writer (nested columnar output).

``--device`` defaults to ``cuda`` and raises without a card; ``--device
cpu`` runs the kernels' plain versions.  ``main(argv)`` returns
``{"work", "ingest", "history", "restored_at", "resumed", "serve"}``.

Run:  PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import smoke_config
from repro_torch.launch.serve import main as serve_main
from repro_torch.models.registry import build, model_device
from repro_torch.pipeline import PackedLoader, ingest_corpus, synth_corpus
from repro_torch.train import LoopConfig, TrainLoop

ARCH = "gemma-2b"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=None,
                    help="a directory for the corpus, the checkpoints and "
                         "the generations (a new temporary one by default)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = model_device(args.device)
    work = args.workdir or tempfile.mkdtemp(prefix="repro_torch_quickstart_")
    os.makedirs(work, exist_ok=True)
    data = os.path.join(work, "corpus.rntj")
    ckpt = os.path.join(work, "ckpt")
    gen = os.path.join(work, "gen.rntj")

    cfg = smoke_config(ARCH)
    bundle = build(cfg)

    print("=== 1. parallel ingest ===")
    stats = ingest_corpus(
        synth_corpus(400, mean_len=128, vocab=cfg.vocab_size), data,
        n_workers=4, device=dev)
    print(f"  {stats['entries']} docs -> {stats['clusters']} clusters, "
          f"{stats['compressed_bytes']/1e6:.2f} MB compressed "
          f"({stats['lock_acquisitions']} lock acquisitions)")

    print("=== 2. train 30 steps ===")
    loader = PackedLoader(data, batch=4, seq_len=64, device=dev)
    loop = TrainLoop(bundle, loader, ckpt,
                     config=LoopConfig(steps=30, ckpt_every=10, log_every=10),
                     device=dev)
    hist = loop.run()
    print(f"  loss {hist[0].loss:.3f} -> {hist[-1].loss:.3f}")

    print("=== 3. crash-restart ===")
    loader2 = PackedLoader(data, batch=4, seq_len=64, device=dev)
    loop2 = TrainLoop(bundle, loader2, ckpt,
                      config=LoopConfig(steps=10, ckpt_every=10, log_every=5),
                      device=dev)
    restored_at = loop2.step
    print(f"  restored at step {restored_at}; continuing")
    loop2.run()
    for ld in (loader, loader2):
        ld.close()

    print("=== 4. serve ===")
    served = serve_main(["--arch", ARCH, "--smoke", "--requests", "4",
                         "--prompt-len", "8", "--max-new", "8",
                         "--device", str(dev), "--out", gen])
    print(f"workdir: {work}")
    return {"work": work, "ingest": stats, "history": hist,
            "restored_at": restored_at, "resumed": loop2.history,
            "serve": served}


if __name__ == "__main__":
    main()
