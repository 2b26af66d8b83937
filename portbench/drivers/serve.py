"""The ``serve`` traffic kind: closed-loop offline generation through the
program's ``launch.serve.generate``, every batch's generations filled into
ONE ``ParallelWriter`` file.

The mix: batches of ``batch`` requests of one task and one prompt
length.  Each of the mix's ``tasks`` gives its prompt (``images`` of
``image_tokens`` VQ tokens each, then text of a length drawn uniformly
from its ``text`` range), the tokens each request generates greedily
(``max_new``) and its number of batches in the cycle.  The text lengths
are drawn once from the mix's own ``cycle_seed``, so that every run holds
the same cycle; ``--seed`` orders the cycle and draws the prompts'
tokens (text from the vocabulary's first ids, images from its last
``image_codes``).

Set-up (the clock starts at the process's start): the weights are drawn by
the benchmark (``yardstick.weights``) into the program's parameter tree
(checked against ``param_shapes``), and each prompt length of the cycle
is warmed by a prefill and one decode step, each task's longest by a
whole batch of its ``max_new``.

The window: batch after batch, ``generate(bundle, params, prompts,
max_new)`` on a bundle whose ``prefill`` the benchmark wraps to read its
end (a synchronize: the benchmark takes its clock itself); then the
batch's generations (the rows ``generate`` returned) are filled into the
file's fill context.  The window ends with the first whole cycle after
``seconds`` (every seed's window then holds the same batches), and the
file is closed inside it.  ``serve_tokens_per_s``: every prompt and
generated token of the batches filled in the window over its wall
seconds; ``ttft_p95_ms``: the 95th percentile over every request of the
time from its batch's start to the end of its prefill (its first token
computed; ``generate`` brings tokens to the host only at its end).

Then: the file is read back (the program's host reader) against the
served tokens, the program's state is freed, the peak read, and the
reference runs over a sample of the finished requests drawn from the
seed, with the longest among them.
"""

from __future__ import annotations

import gc
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from portbench.reference.model import param_spec, served_gaps
from portbench.yardstick import flops, trace as ytrace
from portbench.yardstick.weights import fill_leaf, walk

def lengths_cycle(traffic: Dict) -> List[tuple]:
    """The mix's batches, in the cycle's own order: (text tokens, images,
    new tokens)."""
    rng = np.random.default_rng(traffic["cycle_seed"])
    out = []
    for task in traffic["tasks"]:
        lo, hi = task["text"]
        for _ in range(task["batches"]):
            out.append((int(rng.integers(lo, hi + 1)), task["images"],
                        task["max_new"]))
    return out


def prompt_len(traffic: Dict, shape: tuple) -> int:
    return shape[0] + shape[1] * traffic["image_tokens"]


def prompts(rng, traffic: Dict, shape: tuple, vocab: int) -> np.ndarray:
    """(batch, length) int32: the images' VQ codes (the vocabulary's last
    ``image_codes`` ids) first, then the text (the others)."""
    text, images = shape[:2]
    img = images * traffic["image_tokens"]
    b, codes = traffic["batch"], traffic["image_codes"]
    out = np.empty((b, img + text), np.int32)
    out[:, :img] = rng.integers(vocab - codes, vocab, (b, img))
    out[:, img:] = rng.integers(0, vocab - codes, (b, text))
    return out


class TimedBundle:
    """The program's bundle, its ``prefill`` ended by a synchronize and
    timed by the benchmark's own clock."""

    def __init__(self, bundle):
        self._b = bundle
        self.prefill_end = 0.0

    def prefill(self, *a, **k):
        out = self._b.prefill(*a, **k)
        if out[0].device.type == "cuda":
            torch.cuda.synchronize(out[0].device)
        self.prefill_end = time.perf_counter()
        return out

    def decode_step(self, *a, **k):
        return self._b.decode_step(*a, **k)


def _nest(flat: Dict[str, torch.Tensor]) -> Dict:
    tree: Dict = {}
    for path, t in flat.items():
        *head, last = path.split(".")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return tree


def draw_params(bundle, cfg: Dict, seed: int, dev) -> Dict:
    """The benchmark's weights in the program's parameter tree."""
    from portbench.drivers.train import _flat

    shapes = _flat(bundle.param_shapes())
    spec = param_spec(cfg)
    if set(shapes) != set(spec):
        raise ValueError(f"the program's parameters {sorted(shapes)} are not "
                         f"the configuration's {sorted(spec)}")
    flat = {}
    for i, path, shape, std in walk(spec):
        if tuple(shapes[path].shape) != shape:
            raise ValueError(f"{path}: the program holds "
                             f"{tuple(shapes[path].shape)}, the configuration {shape}")
        flat[path] = fill_leaf(torch.empty(shape, dtype=torch.float32,
                                           device=dev), std, seed, i)
    return _nest(flat)


def _batch(ids, length: int, tokens: np.ndarray):
    """A batch's generations as the program logs them."""
    from repro_torch.core import ColumnBatch
    from repro_torch.launch.serve import GEN_SCHEMA

    n = len(ids)
    return ColumnBatch.from_arrays(GEN_SCHEMA, n, {
        "request_id": np.asarray(ids, np.int64),
        "prompt_len": np.full(n, length, np.int32),
        "tokens": np.full(n, tokens.shape[1], np.int64),
        "tokens._0": tokens.reshape(-1).astype(np.int32),
    })


def serve_batches(bundle, params, traffic, cfg, seed, dev, seconds, writer_path,
                  order=None, n_batches=None):
    """Run the cycle's batches in the seed's order (or ``order``), whole
    cycles until ``seconds`` have passed, or ``n_batches`` of them -> a
    record of the window, and ``next``: the cycle's shapes that would come
    after it."""
    from repro_torch.core import ParallelWriter
    from repro_torch.launch.serve import GEN_SCHEMA, generate

    rng = np.random.default_rng(seed)
    cycle = lengths_cycle(traffic)
    order = order or [cycle[i] for i in rng.permutation(len(cycle))]
    b, vocab = traffic["batch"], cfg["vocab_size"]
    timed = TimedBundle(bundle)
    writer = ParallelWriter(GEN_SCHEMA, writer_path, device=dev)
    ctx = writer.create_fill_context()
    rec = {"batches": [], "ttft_s": [], "write_s": 0.0, "served": {}}
    t0 = time.perf_counter()
    k = 0
    while True:
        shape = order[k % len(order)]
        length, new = prompt_len(traffic, shape), shape[2]
        host = prompts(rng, traffic, shape, vocab)
        ids = np.arange(k * b, (k + 1) * b)
        tb = time.perf_counter()
        gen = generate(timed, params, torch.from_numpy(host).to(dev), new)
        te = time.perf_counter()
        answered = len(gen)
        tw = time.perf_counter()
        ctx.fill_batch(_batch(ids[:answered], length, gen))
        rec["write_s"] += time.perf_counter() - tw
        rec["batches"].append({"length": length, "new": new,
                               "prefill_s": timed.prefill_end - tb,
                               "decode_s": te - timed.prefill_end})
        rec["ttft_s"] += [timed.prefill_end - tb] * b
        for j in range(answered):
            rec["served"][int(ids[j])] = (host[j], gen[j])
        k += 1
        if (k == n_batches if n_batches is not None
                else k % len(order) == 0 and time.perf_counter() - t0 >= seconds):
            break
    tw = time.perf_counter()
    ctx.close()
    writer.close()
    rec["write_s"] += time.perf_counter() - tw
    rec["window_s"] = time.perf_counter() - t0
    rec["attempted"] = k * b
    rec["next"] = order[k % len(order):] + order[:k % len(order)]
    return rec


def checked(served: Dict, traffic: Dict, seed: int) -> list:
    """The finished requests the reference checks: the longest (the first
    of them) and others drawn from the seed, ``checked_requests`` in all,
    as (prompt, served tokens)."""
    rng = np.random.default_rng(seed)
    ids = sorted(served)
    longest = max(ids, key=lambda i: len(served[i][0]) + len(served[i][1]))
    others = [i for i in ids if i != longest]
    pick = [longest] + [int(i) for i in rng.choice(
        others, size=min(traffic["checked_requests"] - 1, len(others)),
        replace=False)]
    return [served[i] for i in pick]


def read_back(path: str, served: Dict) -> int:
    """Tokens of the served requests the file does not hold as served
    (a request missing from it counts all its tokens)."""
    from repro_torch.core import RNTJReader

    r = RNTJReader(path, device="cpu")
    try:
        ids = r.read_column("request_id")
        ends = r.read_column("tokens")
        vals = r.read_column("tokens._0")
    finally:
        r.close()
    starts = np.concatenate([[0], ends[:-1]])
    got = {int(i): vals[s:e] for i, s, e in zip(ids, starts, ends)}
    wrong = 0
    for rid, (_p, toks) in served.items():
        have = got.get(rid)
        if have is None or len(have) != len(toks):
            wrong += len(toks)
        else:
            wrong += int(np.sum(have != toks))
    return wrong


def _traced(bundle, params, traffic, cfg, seed, dev, order, path):
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.kernels import ops

    last = None
    for _ in range(3):
        before = ops.launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("portbench.traced"):
                rec = serve_batches(bundle, params, traffic, cfg, seed + 1, dev,
                                    0.0, path, order=order,
                                    n_batches=traffic["trace_batches"])
                torch.cuda.synchronize(dev)
        after = ops.launch_counts()
        launched = {k: after.get(k, 0) - before.get(k, 0) for k in after}
        expect = {"k5_fwd": launched.get("flash_attention", 0),
                  "k6": launched.get("decode_attention", 0)}
        try:
            s = ytrace.summarize(prof.events(), "portbench.traced", expect)
        except ytrace.TraceMissed as e:
            last = e
            print(f"trace: {e}; tracing again", flush=True)
            continue
        s["launches"] = launched
        s["lengths"] = [(bt["length"], bt["new"]) for bt in rec["batches"]]
        return s
    raise ytrace.TraceMissed(f"three traces missed launches: {last}")


def build_bundle(cfg: Dict):
    """The program's model for a configuration file."""
    from portbench.drivers.train import arch_config
    from repro_torch.models.registry import build

    return build(arch_config(cfg))


def run(cell: Dict, cfg: Dict, traffic: Dict, seed: int, seconds: float,
        trace: bool, device: str, t_start: float) -> Dict:
    from repro_torch.launch.serve import generate

    dev = torch.device(device)
    b = traffic["batch"]
    workdir = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        bundle = build_bundle(cfg)
        params = draw_params(bundle, cfg, seed, dev)
        warm = np.random.default_rng(0)
        cycle = sorted(set(lengths_cycle(traffic)),
                       key=lambda sh: (prompt_len(traffic, sh), sh[2]))
        longest = {sh[1:]: sh for sh in cycle}    # each task's longest prompt
        for shape in cycle:
            p = torch.from_numpy(prompts(warm, traffic, shape, cfg["vocab_size"])).to(dev)
            generate(bundle, params, p,
                     shape[2] if longest[shape[1:]] == shape else 2)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        setup_s = time.perf_counter() - t_start

        path = str(workdir / "generations.rntj")
        rec = serve_batches(bundle, params, traffic, cfg, seed, dev, seconds,
                            path)
        wrong_log = read_back(path, rec["served"])
        summary = (_traced(bundle, params, traffic, cfg, seed, dev, rec["next"],
                           str(workdir / "traced.rntj")) if trace else None)
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        del params, bundle
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        served = rec["served"]
        t_ref = time.perf_counter()
        gaps = served_gaps(cfg, seed, checked(served, traffic, seed), dev)
        print(f"reference: {time.perf_counter() - t_ref:.3f} s", file=sys.stderr,
              flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    window_s = rec["window_s"]
    tokens = sum(b * (bt["length"] + bt["new"]) for bt in rec["batches"])
    numbers = {"answers_missing": rec["attempted"] - len(served),
               "log_tokens_wrong": wrong_log,
               "served_logit_gap": max(gaps["served"])}
    ctx = {
        "driver": "serve", "cell": cell, "config": cfg, "traffic": traffic,
        "window": {"seconds": window_s, "batches": rec["batches"],
                   "write_s": rec["write_s"],
                   "flops": sum(flops.serve_batch_flops(cfg, b, bt["length"],
                                                        bt["new"])
                                for bt in rec["batches"])},
        "trace": summary,
    }
    return {
        "e2e": {"serve_tokens_per_s": {"value": tokens / window_s, "unit": "tokens/s"},
                "ttft_p95_ms": {"value": 1e3 * float(np.percentile(rec["ttft_s"], 95)),
                                "unit": "ms"},
                "setup_s": {"value": setup_s, "unit": "s"}},
        "ctx": ctx, "numbers": numbers,
        "attempted": rec["attempted"],
        "failed": rec["attempted"] - len(served),
        "memory_peak_bytes": peak, "trace": summary,
    }
