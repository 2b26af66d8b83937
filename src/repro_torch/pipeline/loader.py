"""Packing data loader: nested columnar docs -> fixed (B, S) token
batches, the twin of ``repro.pipeline.loader``.

Deterministic and exactly resumable: the loader state is
``(entry_cursor, leftover_tokens)`` and is stored inside the training
checkpoint, so a restarted run continues mid-epoch on the same tokens.
Reads go cluster-at-a-time (the format's natural unit) with column
projection — no entry-by-entry Python loop on the hot path.

Two engines behind one contract (DESIGN.md §9), picked by ``engine``:

* ``"host"`` — the numpy path: ``read_cluster`` + a per-document Python
  loop feeding ``np.concatenate`` packing; yields numpy arrays.
* ``"device"`` (the default) — built on
  :meth:`RNTJReader.iter_clusters_device`: stored page bytes upload once
  per cluster, columns decode on ``device`` (on a card K4 for the offset
  column as exact int32 ends, K3 for the int32 token column; on the CPU
  their plain versions), and the batch packing — document gather with
  EOS insertion, ``(B, S)`` views — runs as plain torch ops on
  ``device`` (the reference runs them as XLA ops, not Pallas kernels).
  Yields tensors on ``device``.

The reference picks its engine with ``device="auto"|"device"|"host"`` by
whether jax is imported; here ``engine`` names it and ``device`` (default
``"cuda"``, ``RuntimeError`` without a card) is the torch device.
``ReadOptions(device_decode="off")`` still pins the host engine.

Both engines emit the byte-identical token stream (EOS-joined documents
in entry order, wrapped over epochs) and keep the same
``(entry_cursor, leftover)`` state: ``entry_cursor`` counts documents
pulled from the stream, ``leftover`` holds pulled-but-unemitted tokens.
A checkpoint written under either engine — or by the reference's loader
— restores under either.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.core import RNTJReader
from repro_torch.core.reader import ReadOptions

ENGINES = ("device", "host")


def _pack_cluster(vals: torch.Tensor, offs: torch.Tensor, ndocs: int,
                  eos_id: int) -> torch.Tensor:
    """A cluster's value column + offset column (cluster-relative ends)
    -> the packed token stream ``doc0 .. EOS doc1 .. EOS ...`` (int32).

    Gather formulation: document ``k``'s EOS lands at output position
    ``offs[k] + k``, so a tiny ``ndocs``-element scatter marks the EOS
    slots, a cumsum over the marks counts completed documents before each
    position, and every other slot gathers token ``j - docs_before(j)``.
    """
    dev = vals.device
    n = vals.shape[0]
    n_out = n + ndocs
    eos_pos = offs.long() + torch.arange(ndocs, device=dev)
    mark = torch.zeros(n_out, dtype=torch.int64, device=dev)
    mark[eos_pos] = 1
    docs_before = torch.cumsum(mark, 0) - mark
    j = torch.arange(n_out, device=dev)
    tok = torch.clamp(j - docs_before, 0, max(n - 1, 0))
    src = vals.to(torch.int32) if n else torch.zeros(1, dtype=torch.int32,
                                                     device=dev)
    return torch.where(mark == 1, torch.tensor(eos_id, dtype=torch.int32,
                                               device=dev), src[tok])


def _batch_views(flat: torch.Tensor, pos: int, batch: int, seq_len: int):
    grid = flat[pos:pos + batch * (seq_len + 1)].reshape(batch, seq_len + 1)
    return grid[:, :-1].contiguous(), grid[:, 1:].contiguous()


class PackedLoader:
    """``engine``: ``"device"`` (the default; tensors on ``device``) or
    ``"host"`` (numpy).  ``read_options`` tunes the underlying reader —
    ``device_decode="off"`` pins the loader to the host engine."""

    def __init__(self, path: str, batch: int, seq_len: int,
                 eos_id: int = 0, state: Optional[Dict] = None,
                 engine: str = "device", device="cuda",
                 read_options: Optional[ReadOptions] = None):
        if engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, got "
                             f"{engine!r}")
        self.reader = RNTJReader(path, options=read_options, device=device)
        self.device = self.reader.device
        self.batch = batch
        self.seq_len = seq_len
        self.eos_id = eos_id
        self.engine = engine
        schema = self.reader.schema
        self._col_off = schema.column_of_path["tokens"]
        self._col_val = schema.column_of_path["tokens._0"]
        self.entry_cursor = 0
        self.leftover = np.empty(0, np.int32)
        # device-engine buffer: the packed stream lives on the device as
        # (_flat, _pos) — flat tokens plus a consumed-prefix cursor — so
        # per-batch state updates are O(1) (no leftover re-slice copy)
        self._flat: Optional[torch.Tensor] = None
        self._pos = 0
        if state:
            self.load_state(state)

    # -- resumable state ---------------------------------------------------

    def state(self) -> Dict:
        """The exact-resume state ``{entry_cursor, leftover}``.

        Under the device engine the leftover comes to the host here —
        checkpoint time is the one place the device stream syncs.
        """
        if self._flat is not None:
            left = self._flat[self._pos:].cpu().numpy().copy()
        else:
            left = np.asarray(self.leftover, np.int32).copy()
        return {"entry_cursor": self.entry_cursor, "leftover": left}

    def load_state(self, state: Dict) -> None:
        """Restore ``(entry_cursor, leftover)``; applies to the next
        :meth:`batches` call (generators already running keep their own
        position, exactly like the host path)."""
        self.entry_cursor = int(state["entry_cursor"])
        self.leftover = np.asarray(state["leftover"], np.int32)
        self._flat = None
        self._pos = 0

    @property
    def n_docs(self) -> int:
        return self.reader.n_entries

    def _use_device(self) -> bool:
        return (self.engine == "device"
                and self.reader.read_options.device_decode != "off")

    # -- iteration ------------------------------------------------------------

    def batches(self) -> Iterator[Dict]:
        """Yields ``{tokens (B,S), labels (B,S)}`` forever (epoch-wrapped):
        int32 numpy arrays from the host engine, int32 tensors on
        ``device`` from the device engine."""
        if self._use_device():
            return self._device_batches()
        return self._host_batches()

    # -- host engine -------------------------------------------------------

    def _doc_stream(self) -> Iterator[np.ndarray]:
        """Docs starting at entry_cursor, wrapping around epochs."""
        while True:
            for ci in range(self.reader.n_clusters):
                first, last = self.reader.cluster_entry_range(ci)
                if last <= self.entry_cursor:
                    continue
                cols = self.reader.read_cluster(ci, [self._col_off, self._col_val])
                offs = cols[self._col_off]
                vals = cols[self._col_val]
                starts = np.concatenate([[0], offs[:-1]])
                lo = self.entry_cursor - first
                for j in range(lo, last - first):
                    self.entry_cursor += 1
                    yield vals[starts[j]:offs[j]].astype(np.int32)
            self.entry_cursor = 0  # next epoch

    def _host_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        need = self.batch * (self.seq_len + 1)
        stream = self._doc_stream()
        buf = self.leftover
        while True:
            parts = [buf]
            total = len(buf)
            while total < need:
                doc = next(stream)
                parts.append(doc)
                parts.append(np.array([self.eos_id], np.int32))
                total += len(doc) + 1
            flat = np.concatenate(parts)
            chunk, self.leftover = flat[:need], flat[need:]
            buf = self.leftover
            grid = chunk.reshape(self.batch, self.seq_len + 1)
            yield {"tokens": grid[:, :-1].copy(), "labels": grid[:, 1:].copy()}

    # -- device engine -----------------------------------------------------

    def _device_stream(self):
        """Raw per-cluster device chunks ``(vals, offs, ndocs, drop)``
        starting at ``entry_cursor``, wrapping around epochs — the
        cluster-granular analog of :meth:`_doc_stream` (pulling a
        cluster advances ``entry_cursor`` to its end; the chunk's
        unemitted tail is the leftover).  ``drop`` is the count of
        already-consumed leading packed elements (mid-cluster resume
        only; 0 in steady state) — packing itself happens in
        :meth:`_device_batches` so the refill can fuse it with the
        carry concat."""
        want = [self._col_off, self._col_val]
        while True:
            start_ci = None
            for ci in range(self.reader.n_clusters):
                _f, last = self.reader.cluster_entry_range(ci)
                if last > self.entry_cursor:
                    start_ci = ci
                    break
            if start_ci is None:
                self.entry_cursor = 0  # next epoch
                continue
            for i, cols in self.reader.iter_clusters_device(want, start=start_ci):
                first, last = self.reader.cluster_entry_range(i)
                offs = self._on_device(cols[self._col_off])
                vals = self._on_device(cols[self._col_val])
                lo = self.entry_cursor - first
                # mid-cluster resume: docs < lo and their EOS slots are
                # already consumed.  The one host sync of the stream
                # (restore only, never steady state).
                drop = (int(offs[lo - 1]) + lo) if lo > 0 else 0
                self.entry_cursor = last
                yield vals, offs, int(last - first), drop

    def _on_device(self, col) -> torch.Tensor:
        """A decoded column as a tensor on the loader's device (columns the
        reader's plan gates out come back as numpy arrays)."""
        if isinstance(col, np.ndarray):
            return torch.from_numpy(np.ascontiguousarray(col)).to(self.device)
        return col

    def _device_batches(self):
        need = self.batch * (self.seq_len + 1)
        stream = self._device_stream()
        if self._flat is None:
            left = torch.from_numpy(np.asarray(self.leftover, np.int32))
            if left.shape[0] < need:
                # left-pad so _flat is always at least `need` long — the
                # refill below can then take a fixed (need,) carry slice
                pad = torch.zeros(need - left.shape[0], dtype=torch.int32)
                self._pos = pad.shape[0]
                self._flat = torch.cat([pad, left]).to(self.device)
            else:
                self._flat = left.to(self.device)
                self._pos = 0
        while True:
            avail = int(self._flat.shape[0]) - self._pos
            if avail < need:
                # the remainder right-aligned in a fixed (need,) carry
                # window (the reference keeps the refill's shapes fixed
                # for XLA; here it bounds the carry copy to `need`)
                buf = self._flat[-need:]
                total = avail
                while total < need:
                    vals, offs, ndocs, drop = next(stream)
                    # `drop` > 0 only on a restore: the consumed prefix
                    buf = torch.cat([buf, _pack_cluster(
                        vals, offs, ndocs, self.eos_id)[drop:]])
                    total += int(vals.shape[0]) + ndocs - drop
                self._flat = buf
                self._pos = need - avail
            tokens, labels = _batch_views(self._flat, self._pos, self.batch,
                                          self.seq_len)
            self._pos += need
            yield {"tokens": tokens, "labels": labels}

    def close(self) -> None:
        self.reader.close()
