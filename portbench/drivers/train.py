"""The ``train`` traffic kind: pre-training on a corpus kept in one RNT-J
file, through the program's own loop.

Set-up (the clock starts at the process's start): the corpus is drawn
from the seed (``yardstick.corpus``) and ingested by the program's
``ingest_corpus`` with the mix's writer threads into one file in a fresh
directory under ``TMPDIR``; the program's ``PackedLoader`` decodes it on
the card and its ``TrainLoop`` (AdamW as the mix states it, no
checkpoint inside the run) is built once.  Its parameters are then drawn
by the benchmark (``yardstick.weights``) into the loop's own tensors,
and the loop runs the mix's checked steps through ``TrainLoop.run``:
they warm every shape and give the readings the reference is held to
(each step's loss, the first step's gradient as AdamW's first moment
holds it, each leaf's change from the drawn start).

The window: ``TrainLoop.run(1)`` until ``seconds`` have passed, a step
at a time on the same loop, loader and state; ``train_tokens_per_s`` is
every token of the window's steps over the window's wall seconds, the
loader's waits included.  With ``trace`` the window is followed by the
mix's traced steps under ``torch.profiler``.

Then the program's state is freed, the peak memory read, and the
reference (``portbench.reference``) follows the checked steps from the
same corpus and weights.
"""

from __future__ import annotations

import gc
import math
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from portbench.reference import compare, loader as ref_loader
from portbench.reference.compare import sample_stride
from portbench.reference.model import param_spec, train_readings
from portbench.yardstick import flops, trace as ytrace
from portbench.yardstick.corpus import synth_corpus
from portbench.yardstick.weights import draw_leaf, fill_leaf, walk

EOS = 0


def arch_config(cfg: Dict):
    """The program's ``ArchConfig`` for a configuration file; raises where
    the file states what the program has no option for."""
    from repro_torch.configs.base import ArchConfig, MoEConfig

    if cfg.get("qk_norm") not in (None, False, True):
        raise ValueError(f"{cfg['name']}: qk_norm is on or off, "
                         f"not {cfg['qk_norm']!r}")
    moe = cfg.get("moe")
    if moe and (not moe["norm_topk_prob"] or moe["aux_loss_alpha"] != 0.01):
        raise ValueError(f"{cfg['name']}: the program renormalises the top-k "
                         "gates and weighs the balance loss by 0.01")
    return ArchConfig(
        name=cfg["name"], family=cfg["family"], n_layers=cfg["n_layers"],
        d_model=cfg["d_model"], n_heads=cfg["n_heads"],
        n_kv_heads=cfg["n_kv_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["d_ff"], vocab_size=cfg["vocab_size"],
        qk_norm=bool(cfg.get("qk_norm")), norm_eps=cfg["norm_eps"],
        rope_theta=cfg["rope_theta"], param_dtype=cfg["param_dtype"],
        compute_dtype=cfg["compute_dtype"], remat=True,
        moe=(MoEConfig(n_experts=moe["n_experts"], top_k=moe["top_k"],
                       n_shared=moe["n_shared"],
                       capacity_factor=moe["capacity_factor"])
             if moe else None),
    )


def _flat(tree, prefix="") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


class TimedLoader:
    """The program's loader behind one generator for the whole run: the
    host seconds of each ``next()``, and host copies of the first
    ``keep`` batches."""

    def __init__(self, loader, keep: int):
        self.loader = loader
        self.keep = keep
        self.spans: List[float] = []
        self.kept: List[Dict[str, np.ndarray]] = []
        self._it = None

    def batches(self):
        if self._it is None:
            self._it = self._gen()
        return self._it

    def _gen(self):
        from torch.profiler import record_function

        it = self.loader.batches()
        while True:
            t0 = time.perf_counter()
            with record_function("portbench.loader_next"):
                b = next(it)
            self.spans.append(time.perf_counter() - t0)
            if len(self.kept) < self.keep:
                self.kept.append({k: torch.as_tensor(v).cpu().numpy().copy()
                                  for k, v in b.items()})
            yield b

    # the loop's checkpoint integration; no save falls inside a run
    def state(self):
        return self.loader.state()

    def load_state(self, state):
        self.loader.load_state(state)


class Phases:
    """Set-up's phases, each printed on standard error with its seconds."""

    def __init__(self):
        self.t = time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        print(f"set-up: {name} in {now - self.t:.3f} s", file=sys.stderr, flush=True)
        self.t = now


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def setup(cfg: Dict, traffic: Dict, seed: int, dev, workdir: Path,
          keep_grad: bool = False):
    """Build the program's loop on a fresh corpus and weights and run the
    checked steps -> (loop, loader, program readings, corpus documents).
    ``keep_grad`` keeps the first gradient's sample (on the host)."""
    from repro_torch.models.registry import build
    from repro_torch.pipeline import PackedLoader, ingest_corpus
    from repro_torch.train import LoopConfig, TrainLoop, make_optimizer

    opt = traffic["optimizer"]
    phases = Phases()
    docs = synth_corpus(traffic["corpus_docs"], seed=seed,
                        mean_len=traffic["mean_len"], vocab=cfg["vocab_size"])
    phases("corpus drawn")
    path = str(workdir / "corpus.rntj")
    ingest_corpus(iter(docs), path, n_workers=traffic["writer_threads"],
                  device=dev)
    phases("ingested")
    loader = TimedLoader(
        PackedLoader(path, batch=traffic["batch"], seq_len=traffic["seq_len"],
                     eos_id=EOS, device=dev),
        keep=traffic["checked_steps"])
    bundle = build(arch_config(cfg))
    loop = TrainLoop(
        bundle, loader, str(workdir / "ckpt"),
        config=LoopConfig(steps=traffic["checked_steps"], ckpt_every=2 ** 62,
                          log_every=2 ** 62),
        optimizer=make_optimizer(
            peak_lr=opt["peak_lr"], warmup=opt["warmup"],
            total=opt["total_steps"], b1=opt["b1"], b2=opt["b2"],
            eps=opt["eps"], weight_decay=opt["weight_decay"],
            clip_norm=opt["clip_norm"]),
        device=dev, seed=seed)
    phases("loop built")
    spec = param_spec(cfg)
    params = _flat(loop.params)
    if set(params) != set(spec):
        raise ValueError(f"the program's parameters {sorted(params)} are not "
                         f"the configuration's {sorted(spec)}")
    for i, path, shape, std in walk(spec):
        t = params[path]
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{path}: the program holds {tuple(t.shape)} "
                             f"{t.dtype}, the configuration {shape} float32")
        fill_leaf(t, std, seed, i)
    phases("weights drawn")

    loop.run(1)
    phases("first step")
    moments = _flat(loop.opt_state.m)
    grad = {k: float(torch.linalg.vector_norm(m)) / (1 - opt["b1"])
            for k, m in moments.items()}
    # where a limit compares the first gradient whole: the first moment's
    # sample on the host (the gradient is it over 1 - b1)
    first = ({k: m.reshape(-1)[::sample_stride(m.numel())].to("cpu", copy=True)
              for k, m in moments.items()} if keep_grad else None)
    phases("first gradient read")
    loop.run(traffic["checked_steps"] - 1)
    phases("later checked steps")
    change = {}
    params = _flat(loop.params)
    for i, path, shape, std in walk(spec):
        start = draw_leaf(shape, std, seed, i, dev)
        change[path] = float(torch.linalg.vector_norm(params[path] - start))
        del start
    readings = {"loss": [ev.loss for ev in loop.history], "grad": grad,
                "change": change, "first_grad": first}
    _sync(dev)
    phases("change read")
    return loop, loader, readings, [d for _, d in docs]


def reference_batches(traffic: Dict, docs: List[np.ndarray], kept: List[Dict]):
    """-> (the loader's tokens no corpus document explains, the
    reference's own batches in the program's order of documents, or None
    where the loader is wrong)."""
    wrong, order = ref_loader.judge(docs, ref_loader.stream_of(kept), EOS)
    if wrong:
        return wrong, None
    batches = ref_loader.batches_from(docs, order, EOS, traffic["checked_steps"],
                                      traffic["batch"], traffic["seq_len"])
    return 0, [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]


def reference_numbers(cfg: Dict, traffic: Dict, seed: int, dev,
                      docs: List[np.ndarray], kept: List[Dict],
                      readings: Dict) -> Dict[str, float]:
    """The reference over the checked steps, compared with ``readings``."""
    wrong, batches = reference_batches(traffic, docs, kept)
    numbers = {"loader_tokens_wrong": wrong}
    if batches is not None:
        ref = train_readings(cfg, traffic["optimizer"], seed, batches, dev,
                             first_grad=readings["first_grad"],
                             first_scale=1 / (1 - traffic["optimizer"]["b1"]))
        numbers.update(compare.train_numbers(readings, ref))
    return numbers


def _traced(loop, steps: int, dev) -> Dict:
    """``steps`` more steps under ``torch.profiler``, reduced; the trace is
    taken again (three times at most) where it missed launches."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.kernels import ops

    last = None
    for _ in range(3):
        before = ops.launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("portbench.traced"):
                for _ in range(steps):
                    loop.run(1)
                _sync(dev)
        after = ops.launch_counts()
        launched = {k: after.get(k, 0) - before.get(k, 0) for k in after}
        expect = {"k5_fwd": launched.get("flash_attention", 0),
                  "k5_bwd": launched.get("flash_attention_bwd", 0)}
        try:
            s = ytrace.summarize(prof.events(), "portbench.traced", expect)
        except ytrace.TraceMissed as e:
            last = e
            print(f"trace: {e}; tracing again", flush=True)
            continue
        s["steps"] = steps
        s["launches"] = launched
        return s
    raise ytrace.TraceMissed(f"three traces missed launches: {last}")


def run(cell: Dict, cfg: Dict, traffic: Dict, seed: int, seconds: float,
        trace: bool, device: str, t_start: float) -> Dict:
    dev = torch.device(device)
    b, s = traffic["batch"], traffic["seq_len"]
    workdir = Path(tempfile.mkdtemp(prefix="portbench-"))
    print(f"set-up: imports and CUDA start in {time.perf_counter() - t_start:.3f} s",
          file=sys.stderr, flush=True)
    try:
        loop, loader, readings, docs = setup(
            cfg, traffic, seed, dev, workdir,
            keep_grad="grad_diff" in cell["limits"])
        setup_s = time.perf_counter() - t_start

        loader.spans.clear()
        losses_before = len(loop.history)
        n, t0 = 0, time.perf_counter()
        while True:
            loop.run(1)
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
        window_losses = [ev.loss for ev in loop.history[losses_before:]]
        spans = list(loader.spans)

        summary = _traced(loop, traffic["trace_steps"], dev) if trace else None
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
        kept = loader.kept
        del loop, loader
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        numbers = reference_numbers(cfg, traffic, seed, dev, docs, kept,
                                    readings)
        print(f"reference: {time.perf_counter() - t_ref:.3f} s", file=sys.stderr,
              flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    ctx = {
        "driver": "train", "cell": cell, "config": cfg, "traffic": traffic,
        "window": {"seconds": window_s, "steps": n, "tokens": n * b * s},
        "spans": {"loader_next_s": spans},
        "step_flops": flops.train_step_flops(cfg, b, s),
        "attention_shape": (b, cfg["n_heads"], cfg["n_kv_heads"], s, s,
                            cfg["head_dim"]),
        "trace": summary,
    }
    return {
        "e2e": {"train_tokens_per_s": {"value": n * b * s / window_s,
                                       "unit": "tokens/s"},
                "setup_s": {"value": setup_s, "unit": "s"}},
        "ctx": ctx,
        "numbers": numbers,
        "attempted": n,
        "failed": sum(1 for x in window_losses if not math.isfinite(x)),
        "memory_peak_bytes": peak,
        "trace": summary,
    }
