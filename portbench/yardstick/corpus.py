"""The training corpus, frozen from ``synth_corpus``
(``src/repro_torch/pipeline/ingest.py:24``).

The same documents as that generator for the same arguments: log-normal
lengths, Zipf-weighted concatenations of a fixed phrase inventory.  The
one change is speed: the Zipf draw reads a cumulative table once made
(``cdf.searchsorted(rng.random(), side="right")``) where the original
calls ``rng.choice(n_phrases, p=p)`` a phrase, which draws the same one
uniform number and searches the same table.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def synth_corpus(n_docs: int, seed: int = 0, mean_len: int = 512,
                 vocab: int = 50_000, n_phrases: int = 512
                 ) -> List[Tuple[int, np.ndarray]]:
    """-> ``[(doc id, int32 tokens)]`` of ``n_docs`` documents."""
    rng = np.random.default_rng(seed)
    phrases = [
        rng.integers(0, vocab, int(rng.integers(8, 32))).astype(np.int32)
        for _ in range(n_phrases)
    ]
    p = 1.0 / np.arange(1, n_phrases + 1)
    p /= p.sum()
    cdf = p.cumsum()
    cdf /= cdf[-1]
    docs = []
    for i in range(n_docs):
        n = max(8, int(rng.lognormal(np.log(mean_len), 0.6)))
        parts, total = [], 0
        while total < n:
            ph = phrases[int(cdf.searchsorted(rng.random(), side="right"))]
            parts.append(ph)
            total += len(ph)
        docs.append((i, np.concatenate(parts)[:n]))
    return docs
