"""Serving launcher: batched prefill + greedy decode, generations logged
through the ParallelWriter.

The twin of ``repro.launch.serve``.  Generations are variable-length
nested data ({request_id, prompt_len, tokens[]}) written through
``repro_torch.core.ParallelWriter`` on the model's device, the
inference-side instance of the paper's technique.  Prefill runs K5
(``flash_attention``) once per attention block (every layer of a dense
model, each of zamba2's shared blocks), K7 (``rwkv6_scan``) once per
rwkv6 layer and K8 (``mamba2_ssd``) once per Mamba-2 layer; each decode
step runs K6 (``decode_attention``) once per attention block (the
recurrent layers' one-token steps are plain PyTorch).

Parameters are random, drawn from a ``torch.Generator`` seeded with
``--seed``; prompts come from ``numpy.random.default_rng(--seed)``.
``--device`` defaults to ``cuda`` and raises without a card; ``--device
cpu`` runs the kernels' plain versions.

Usage (``--arch`` smollm-360m, gemma-2b, deepseek-67b, rwkv6-7b or
zamba2-2.7b; the other archs raise ``NotImplementedError``):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
      --requests 16 --prompt-len 1000 --max-new 64 --out gen.rntj
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_arch, smoke_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core import Collection, ColumnBatch, Leaf, ParallelWriter, Schema
from repro_torch.models.registry import ModelBundle, build, model_device

GEN_SCHEMA = Schema([
    Leaf("request_id", "int64"),
    Leaf("prompt_len", "int32"),
    Collection("tokens", Leaf("_0", "int32")),
])


def generate(bundle: ModelBundle, params: Dict, prompts: torch.Tensor,
             max_new: int, keep_logits: bool = False,
             timings: Optional[Dict[str, float]] = None):
    """Greedy decode a batch of same-length prompts (B, S) int32 on the
    parameters' device -> (B, max_new) int32 numpy array: prefill, then
    ``max_new - 1`` decode steps.

    ``keep_logits`` also returns the logits that chose each token,
    (B, max_new, V) on the device.  ``timings`` (a dict) receives
    ``prefill_s`` and ``decode_s``, each ended by a synchronize (the
    copy of the tokens to the host ends the decode)."""
    b, s = prompts.shape[:2]
    dev = prompts.device
    t0 = time.perf_counter()
    logits, cache = bundle.prefill(params, prompts, max_len=s + max_new)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)            # (B, 1)
    if timings is not None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        timings["prefill_s"] = t1 - t0
    out, kept = [tok], [logits]
    for i in range(max_new - 1):
        pos = torch.full((b,), s + i, dtype=torch.int32, device=dev)
        logits, cache = bundle.decode_step(params, tok, cache, pos)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok)
        if keep_logits:
            kept.append(logits)
    gen = torch.cat(out, dim=1).cpu().numpy()
    if timings is not None:
        timings["decode_s"] = time.perf_counter() - t1
    if keep_logits:
        return gen, torch.cat(kept, dim=1)
    return gen


@dataclass
class ServeResult:
    cfg: ArchConfig
    bundle: ModelBundle
    params: Dict
    prompts: torch.Tensor          # (B, S) int32 on the device
    tokens: np.ndarray             # (B, max_new) int32
    logits: Optional[torch.Tensor]  # (B, max_new, V) with keep_logits
    timings: Dict[str, float]      # prefill_s, decode_s, write_s
    out: str


def main(argv=None, keep_logits: bool = False) -> ServeResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="smollm-360m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "generations.rntj"))
    args = ap.parse_args(argv)

    dev = model_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_arch(args.arch)
    bundle = build(cfg)
    gen_rng = torch.Generator(device=dev)
    gen_rng.manual_seed(args.seed)
    params = bundle.init(gen_rng, dev)
    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.requests, args.prompt_len)).astype(np.int32)).to(dev)

    timings: Dict[str, float] = {}
    res = generate(bundle, params, prompts, args.max_new,
                   keep_logits=keep_logits, timings=timings)
    gen, logits = res if keep_logits else (res, None)
    t0 = time.perf_counter()
    writer = ParallelWriter(GEN_SCHEMA, args.out, device=dev)
    ctx = writer.create_fill_context()
    ctx.fill_batch(ColumnBatch.from_arrays(GEN_SCHEMA, args.requests, {
        "request_id": np.arange(args.requests, dtype=np.int64),
        "prompt_len": np.full(args.requests, args.prompt_len, np.int32),
        "tokens": np.full(args.requests, gen.shape[1], np.int64),
        "tokens._0": gen.reshape(-1).astype(np.int32),
    }))
    ctx.close()
    writer.close()
    timings["write_s"] = time.perf_counter() - t0
    print(f"wrote {args.requests} generations x {gen.shape[1]} tokens -> "
          f"{args.out}")
    return ServeResult(cfg, bundle, params, prompts, gen, logits, timings,
                       args.out)


if __name__ == "__main__":
    main()
