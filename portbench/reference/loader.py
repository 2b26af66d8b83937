"""The training batches as the corpus makes them, judged against the
program's.

The program's loader packs the corpus file's documents, each followed by
the end-of-sequence token, into one stream and cuts ``(B, S + 1)`` grids
from it: a batch's tokens are a grid's first ``S`` columns, its labels
the last ``S``.  The file's order of documents is the writer's choice
(its threads commit clusters as they fill), so the reference reads that
order off the program's stream: it walks the stream and, at each point,
finds the one corpus document (by its own copy of the corpus) that is
spelled there whole and followed by the end token, none twice.  Tokens
that no such document explains count as wrong.  The reference's batches
are then cut from its own documents in that order.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

KEY = 8  # every document has at least 8 tokens


def stream_of(batches: Sequence[Dict[str, np.ndarray]]) -> np.ndarray:
    """The packed stream the batches were cut from."""
    rows = [np.concatenate([b["tokens"], b["labels"][:, -1:]], axis=1).reshape(-1)
            for b in batches]
    return np.concatenate(rows).astype(np.int64)


def judge(docs: Sequence[np.ndarray], stream: np.ndarray, eos: int
          ) -> Tuple[int, List[int]]:
    """-> (tokens of ``stream`` no whole corpus document explains, the
    documents' order)."""
    index: Dict[tuple, List[int]] = {}
    for i, d in enumerate(docs):
        index.setdefault(tuple(int(x) for x in d[:KEY]), []).append(i)
    used, order, pos, n = set(), [], 0, len(stream)
    while pos < n:
        seg = stream[pos:]
        if len(seg) >= KEY:
            cands = index.get(tuple(int(x) for x in seg[:KEY]), [])
        else:  # the stream ends inside a document's first tokens
            cands = [i for i, d in enumerate(docs)
                     if np.array_equal(d[:len(seg)], seg)]
        hit = None
        for i in cands:
            if i in used:
                continue
            d = docs[i]
            if len(seg) <= len(d):
                if np.array_equal(d[:len(seg)], seg):
                    hit = i
            elif np.array_equal(seg[:len(d)], d) and seg[len(d)] == eos:
                hit = i
            if hit is not None:
                break
        if hit is None:
            return n - pos, order
        used.add(hit)
        order.append(hit)
        pos += len(docs[hit]) + 1
    return 0, order


def batches_from(docs: Sequence[np.ndarray], order: Sequence[int], eos: int,
                 n_batches: int, batch: int, seq_len: int
                 ) -> List[Dict[str, np.ndarray]]:
    """``n_batches`` batches cut from the documents in ``order``."""
    parts = []
    for i in order:
        parts += [docs[i], np.array([eos], np.int32)]
    need = batch * (seq_len + 1)
    flat = np.concatenate(parts)[: n_batches * need]
    out = []
    for k in range(n_batches):
        grid = flat[k * need:(k + 1) * need].reshape(batch, seq_len + 1)
        out.append({"tokens": grid[:, :-1].copy(), "labels": grid[:, 1:].copy()})
    return out
