"""The worker half of the checkpoint layer: schema, dtype names, batch
packing, and the multiprocessing save worker.

This module imports only ``repro_torch.core``, numpy and torch, so that a
``multiprocessing`` *spawn* child running :func:`run_save_worker` needs
nothing else of the package — the parent pickles the shard payloads, the
child only needs the container writer.  ``checkpoint.py`` re-exports
everything here.

Dtypes travel by name in the manifest, as the reference writes them
(``"float32"``, ``"bfloat16"``, ``"int32"``, ...): :func:`torch_dtype` maps
a name to its torch dtype and :func:`dtype_name` back.  Leaf bytes move
through a ``uint8`` view, so a ``bfloat16`` leaf needs no numpy twin.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import Collection, ColumnBatch, Leaf, Schema, WriteOptions
from repro_torch.core.mpwrite import join_container

CKPT_SCHEMA = Schema([
    Leaf("param_id", "int32"),
    Leaf("shard_index", "int32"),
    Collection("shape", Leaf("_0", "int64")),
    Leaf("row_start", "int64"),
    Leaf("row_end", "int64"),
    Collection("data", Leaf("_0", "uint8")),
])


#: the manifest's dtype names (numpy's spelling) -> torch dtypes
TORCH_DTYPES = {
    name: getattr(torch, name) for name in (
        "bool", "uint8", "int8", "int16", "int32", "int64", "uint16",
        "uint32", "uint64", "float16", "bfloat16", "float32", "float64",
        "complex64", "complex128")
    if hasattr(torch, name)
}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return TORCH_DTYPES[name]
    except KeyError:
        raise TypeError(f"checkpoint dtype {name!r} has no torch dtype") from None


def dtype_name(dtype: torch.dtype) -> str:
    """The manifest's name of a torch dtype (``torch.float32`` ->
    ``"float32"``, numpy's spelling)."""
    return str(dtype).removeprefix("torch.")


def tensor_bytes(t: torch.Tensor) -> bytes:
    """The raw little-endian bytes of a CPU tensor in C order (numpy's
    ``tobytes``), through a ``uint8`` view."""
    t = t.contiguous()
    if t.numel() == 0:
        return b""
    return t.reshape(-1).view(torch.uint8).numpy().tobytes()


def _entry_batch(entries: List[Dict]) -> ColumnBatch:
    n = len(entries)
    by_path = {
        "param_id": np.array([e["param_id"] for e in entries], np.int32),
        "shard_index": np.array([e["shard_index"] for e in entries], np.int32),
        "shape": np.array([len(e["shape"]) for e in entries], np.int64),
        "shape._0": np.concatenate(
            [np.asarray(e["shape"], np.int64) for e in entries]
        ) if entries else np.empty(0, np.int64),
        "row_start": np.array([e["row_start"] for e in entries], np.int64),
        "row_end": np.array([e["row_end"] for e in entries], np.int64),
        "data": np.array([len(e["data"]) for e in entries], np.int64),
        "data._0": np.concatenate(
            [np.frombuffer(e["data"], np.uint8) for e in entries]
        ) if entries else np.empty(0, np.uint8),
    }
    return ColumnBatch.from_arrays(CKPT_SCHEMA, n, by_path)


def run_save_worker(
    path: str,
    shards: List[Dict],
    flush_bytes: int,
    options: Optional[WriteOptions] = None,
    crash_after_units: Optional[int] = None,
    device="cuda",
) -> None:
    """Process entry point: join the shared container and write ``shards``.

    Each shard dict is one checkpoint entry (param_id, shard_index, shape,
    row_start, row_end, data-bytes).  Entries accumulate into batches of
    roughly ``flush_bytes`` before handing off to the fill context, which
    clusters them by ``options.cluster_bytes`` as usual.

    ``crash_after_units`` is the chaos hook: after that many entries the
    worker force-flushes whatever it has and ``os._exit``\\ s without DONE
    or close — from the coordinator's side this is indistinguishable from
    SIGKILL, and everything journaled up to the crash must be salvaged.

    ``device`` is the participant's writer device (``"cuda"`` by default;
    ``"cpu"`` when the caller asks for it).
    """
    w = join_container(path, schema=CKPT_SCHEMA, options=options,
                       device=device)
    try:
        ctx = w.create_fill_context()
        batch: List[Dict] = []
        size = written = 0
        for e in shards:
            batch.append(e)
            size += len(e["data"])
            written += 1
            if size >= flush_bytes:
                ctx.fill_batch(_entry_batch(batch))
                batch, size = [], 0
            if crash_after_units is not None and written >= crash_after_units:
                if batch:
                    ctx.fill_batch(_entry_batch(batch))
                ctx.flush_cluster()
                os._exit(1)  # hard crash: lease left dangling, no DONE
        if batch:
            ctx.fill_batch(_entry_batch(batch))
        ctx.close()
    finally:
        if crash_after_units is None:
            w.close()
