"""Tokenized-document schema: the ML instance of the paper's nested data,
the twin of ``repro.pipeline.tokens``.

A document is ``{doc_id, tokens[]}`` — a variable-length collection, i.e.
exactly the row shape (Fig. 1) that makes regular-grid parallel writing
impossible and the paper's protocol necessary.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core import Collection, ColumnBatch, Leaf, Schema

DOC_SCHEMA = Schema([
    Leaf("doc_id", "int64"),
    Collection("tokens", Leaf("_0", "int32")),
])


def docs_to_batch(doc_ids: np.ndarray, token_lists: Sequence[np.ndarray]) -> ColumnBatch:
    sizes = np.array([len(t) for t in token_lists], np.int64)
    values = (np.concatenate(token_lists).astype(np.int32)
              if len(token_lists) else np.empty(0, np.int32))
    return ColumnBatch.from_arrays(
        DOC_SCHEMA, len(doc_ids),
        {"doc_id": np.asarray(doc_ids, np.int64), "tokens": sizes,
         "tokens._0": values},
    )
