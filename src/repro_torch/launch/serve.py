"""Serving launcher: batched prefill + greedy decode, generations logged
through the ParallelWriter.

The twin of ``repro.launch.serve``.  Generations are variable-length
nested data ({request_id, prompt_len, tokens[]}) written through
``repro_torch.core.ParallelWriter`` on the model's device, the
inference-side instance of the paper's technique.  Prefill runs K5
(``flash_attention``) once per attention block (every layer of an
attention model, MLA's at q/k 96 and v 64 in minicpm3-4b, each of
zamba2's shared blocks), K7 (``rwkv6_scan``) once per rwkv6 layer and K8
(``mamba2_ssd``) once per Mamba-2 layer; each decode step runs K6
(``decode_attention``) once per GQA attention block (MLA's latent-space
decode and the recurrent layers' one-token steps are plain PyTorch).
A model of ``Q > 1`` codebooks (musicgen-large) takes prompts ``(B, S, Q)``
and generates ``(B, max_new, Q)``; the file logs the first codebook's
stream, as the reference does.

Parameters are random, drawn from a ``torch.Generator`` seeded with
``--seed``; prompts come from ``numpy.random.default_rng(--seed)``.
``--device`` defaults to ``cuda`` and raises without a card; ``--device
cpu`` runs the kernels' plain versions.

``serve_model(cfg, ...)`` is the same run for a config the caller made (a
depth cut with ``cfg.with_(n_layers=...)``, say); the command line takes
the registry's names only.

Usage (``--arch`` any of the registry's ten):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
      --requests 16 --prompt-len 1000 --max-new 64 --out gen.rntj
"""

from __future__ import annotations

import argparse
import os
import tempfile
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import obs
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
             max_new: int, keep_logits: bool = False):
    """Greedy decode a batch of same-length prompts (B, S[, Q]) int32 on
    the parameters' device -> (B, max_new[, Q]) int32 numpy array:
    prefill, then ``max_new - 1`` decode steps.

    ``keep_logits`` also returns the logits that chose each token,
    (B, max_new[, Q], V) on the device.  Spans (``repro_torch.obs``):
    ``serve.generate`` around the call, ``serve.prefill`` (the prefill and
    the first pick) and one ``serve.decode_step`` a step inside it, both
    timed on the card."""
    b, s = prompts.shape[:2]
    dev = prompts.device
    on_card = dev.type == "cuda"
    with obs.span("serve.generate"):
        with obs.span("serve.prefill", card=on_card):
            logits, cache = bundle.prefill(params, prompts, max_len=s + max_new)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)    # (B, 1)
        out, kept = [tok], [logits]
        for i in range(max_new - 1):
            with obs.span("serve.decode_step", card=on_card):
                pos = torch.full((b,), s + i, dtype=torch.int32, device=dev)
                logits, cache = bundle.decode_step(params, tok, cache, pos)
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
            out.append(tok)
            if keep_logits:
                kept.append(logits)
        gen = torch.cat(out, dim=1).cpu().numpy()
    if keep_logits:
        return gen, torch.cat(kept, dim=1)
    return gen


def span_seconds(summary: Dict[str, Dict]) -> Dict[str, float]:
    """``prefill_s``, ``decode_s`` and ``write_s`` of one served batch from
    its spans' summary, as wall seconds: the prefill until its end on the
    card (the ``serve.prefill`` span's card time; its host time on the
    CPU), the decode from there to the tokens' arrival on the host (the
    rest of ``serve.generate``), the writer's fills and closes (host)."""
    def ms(name, key="host_ms"):
        e = summary.get(name)
        return 0.0 if e is None or e[key] is None else e[key]

    prefill = ms("serve.prefill", "card_ms") or ms("serve.prefill")
    return {"prefill_s": prefill / 1e3,
            "decode_s": (ms("serve.generate") - prefill) / 1e3,
            "write_s": (ms("writer.fill_batch") + ms("writer.close")) / 1e3}


@dataclass
class ServeResult:
    cfg: ArchConfig
    bundle: ModelBundle
    params: Dict
    prompts: torch.Tensor          # (B, S[, Q]) int32 on the device
    tokens: np.ndarray             # (B, max_new[, Q]) int32
    logits: Optional[torch.Tensor]  # (B, max_new[, Q], V) with keep_logits
    timings: Dict[str, float]      # prefill_s, decode_s, write_s
    out: str


def serve_model(cfg: ArchConfig, requests: int, prompt_len: int, max_new: int,
                seed: int, device, out: str,
                keep_logits: bool = False) -> ServeResult:
    """Serve ``requests`` random prompts of ``prompt_len`` tokens on a
    model of ``cfg`` with random parameters (both from ``seed``), and log
    the generations to ``out``."""
    dev = model_device(device)
    bundle = build(cfg)
    gen_rng = torch.Generator(device=dev)
    gen_rng.manual_seed(seed)
    params = bundle.init(gen_rng, dev)
    rng = np.random.default_rng(seed)
    shape = bundle._token_shape(requests, prompt_len)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, shape).astype(np.int32)).to(dev)

    since = obs.mark()
    with obs.recording():
        res = generate(bundle, params, prompts, max_new,
                       keep_logits=keep_logits)
        gen, logits = res if keep_logits else (res, None)
        logged = gen[..., 0] if gen.ndim == 3 else gen  # the first codebook
        writer = ParallelWriter(GEN_SCHEMA, out, device=dev)
        ctx = writer.create_fill_context()
        ctx.fill_batch(ColumnBatch.from_arrays(GEN_SCHEMA, requests, {
            "request_id": np.arange(requests, dtype=np.int64),
            "prompt_len": np.full(requests, prompt_len, np.int32),
            "tokens": np.full(requests, logged.shape[1], np.int64),
            "tokens._0": logged.reshape(-1).astype(np.int32),
        }))
        ctx.close()
        writer.close()
    timings = span_seconds(obs.summary(since))
    print(f"wrote {requests} generations x {logged.shape[1]} tokens -> {out}")
    return ServeResult(cfg, bundle, params, prompts, gen, logits, timings, out)


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
    cfg = smoke_config(args.arch) if args.smoke else get_arch(args.arch)
    return serve_model(cfg, args.requests, args.prompt_len, args.max_new,
                       args.seed, args.device, args.out,
                       keep_logits=keep_logits)


if __name__ == "__main__":
    main()
