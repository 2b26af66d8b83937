"""Batched serving demo: concurrent decode workers, one output file, the
twin of the JAX package's ``examples/serve_batch.py``.

Multiple worker threads each serve a batch of requests (prefill + greedy
decode on a reduced deepseek-67b) and write their generations through
fill contexts of ONE ParallelWriter — inference output as nested
columnar data, written with the paper's protocol.  ``--device`` defaults
to ``cuda`` and raises without a card; ``--device cpu`` runs the kernels'
plain versions.  ``main(argv)`` returns ``{"out", "tokens"}``: the
generations file and ``{request_id: tokens}``.

Run:  PYTHONPATH=src python -m repro_torch.launch.serve_batch [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import threading

import numpy as np
import torch

from repro_torch.configs import smoke_config
from repro_torch.core import ColumnBatch, ParallelWriter, RNTJReader
from repro_torch.launch.serve import GEN_SCHEMA, generate
from repro_torch.models.registry import build, model_device

N_WORKERS, BATCH, PLEN, NEW = 3, 4, 12, 16


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = model_device(args.device)
    cfg = smoke_config("deepseek-67b")
    bundle = build(cfg)
    gen_rng = torch.Generator(device=dev)
    gen_rng.manual_seed(0)
    params = bundle.init(gen_rng, dev)

    work = args.workdir or tempfile.mkdtemp(prefix="repro_torch_serve_")
    os.makedirs(work, exist_ok=True)
    out = os.path.join(work, "generations.rntj")
    writer = ParallelWriter(GEN_SCHEMA, out, device=dev)
    served = {}
    errors = []

    def worker(wid: int):
        try:
            rng = np.random.default_rng(wid)
            ctx = writer.create_fill_context()
            prompts = rng.integers(0, cfg.vocab_size,
                                   (BATCH, PLEN)).astype(np.int32)
            gen = generate(bundle, params, torch.from_numpy(prompts).to(dev),
                           NEW)
            ids = np.arange(wid * 100, wid * 100 + BATCH, dtype=np.int64)
            ctx.fill_batch(ColumnBatch.from_arrays(GEN_SCHEMA, BATCH, {
                "request_id": ids,
                "prompt_len": np.full(BATCH, PLEN, np.int32),
                "tokens": np.full(BATCH, gen.shape[1], np.int64),
                "tokens._0": gen.reshape(-1).astype(np.int32),
            }))
            ctx.close()
            served.update(zip(ids.tolist(), gen))
            print(f"  worker {wid}: served {BATCH} requests x {NEW} tokens")
        except BaseException as e:  # re-raised on the main thread
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(N_WORKERS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    writer.close()
    if errors:
        raise errors[0]

    with RNTJReader(out, device=dev) as r:
        print(f"\noutput file: {r.n_entries} generations in {r.n_clusters} "
              "clusters")
        ids = sorted(int(i) for i in r.read_column("request_id"))
        n = r.n_entries
    print(f"request ids: {ids}")
    if n != N_WORKERS * BATCH:
        raise RuntimeError(f"{n} generations written, expected "
                           f"{N_WORKERS * BATCH}")
    print(f"workdir: {work}")
    return {"out": out, "tokens": served}


if __name__ == "__main__":
    main()
