"""Parallel corpus ingest: many tokenizer workers -> ONE dataset file,
the twin of ``repro.pipeline.ingest`` over the port's ``ParallelWriter``.

Each worker owns a fill context of the shared ParallelWriter and streams
its documents as relocatable clusters; a run with N workers produces a
file readers cannot distinguish from a sequential ingest (paper §4.3).
The writer runs its seal kernels on ``device`` (``"cuda"`` by default,
``RuntimeError`` without a card; ``"cpu"`` runs their plain versions).
With one worker the file is byte-identical to the reference's.
"""

from __future__ import annotations

import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core import ParallelWriter, WriteOptions

from .tokens import DOC_SCHEMA, docs_to_batch


def synth_corpus(n_docs: int, seed: int = 0, mean_len: int = 512,
                 vocab: int = 50_000, n_phrases: int = 512,
                 ) -> Iterator[Tuple[int, np.ndarray]]:
    """Synthetic tokenized corpus with log-normal doc lengths (the
    reference's generator: the same seed gives the same documents).

    Documents are Zipf-weighted concatenations of a fixed phrase inventory,
    so the data is LEARNABLE (per-token entropy ~ H(phrase)/len(phrase)
    << ln(vocab)) — training loss curves show real progress, unlike
    uniform-random tokens whose floor is ln(vocab).
    """
    rng = np.random.default_rng(seed)
    phrases = [
        rng.integers(0, vocab, int(rng.integers(8, 32))).astype(np.int32)
        for _ in range(n_phrases)
    ]
    p = 1.0 / np.arange(1, n_phrases + 1)
    p /= p.sum()
    for i in range(n_docs):
        n = max(8, int(rng.lognormal(np.log(mean_len), 0.6)))
        parts, total = [], 0
        while total < n:
            ph = phrases[rng.choice(n_phrases, p=p)]
            parts.append(ph)
            total += len(ph)
        yield i, np.concatenate(parts)[:n]


def ingest_corpus(
    docs: Iterator[Tuple[int, np.ndarray]],
    path: str,
    n_workers: int = 4,
    batch_docs: int = 256,
    options: Optional[WriteOptions] = None,
    device="cuda",
) -> dict:
    """Pull-based parallel ingest; returns writer stats."""
    options = options or WriteOptions(codec="zlib", level=1,
                                      cluster_bytes=4 * 1024 * 1024)
    writer = ParallelWriter(DOC_SCHEMA, path, options, device=device)
    feed_lock = threading.Lock()

    def pull_batch():
        ids: List[int] = []
        toks: List[np.ndarray] = []
        with feed_lock:
            for _ in range(batch_docs):
                try:
                    i, t = next(docs)
                except StopIteration:
                    break
                ids.append(i)
                toks.append(t)
        return ids, toks

    def worker():
        ctx = writer.create_fill_context()
        while True:
            ids, toks = pull_batch()
            if not ids:
                break
            ctx.fill_batch(docs_to_batch(np.asarray(ids, np.int64), toks))
        ctx.close()

    threads = [threading.Thread(target=worker) for _ in range(n_workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    writer.close()
    return writer.stats.as_dict()
