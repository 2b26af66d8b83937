"""Single-file parallel checkpointing of torch trees.

This is the paper's technique applied to the checkpoint path of a training
framework: every (virtual) host serializes + compresses its parameter
shards into relocatable clusters of ONE RNT-J file in parallel — no
per-host file tree and no post-hoc merge step (contrast: Orbax/tensorstore
write per-host files = the paper's "independent files + merge" baseline).

Checkpoint schema (nested, variable length — exactly the data shape the
format exists for)::

    entry := { param_id:int32, shard_index:int32,
               shape:[int64], row_start:int64, row_end:int64,
               data:[uint8] }

Entry param_id == -1 carries the JSON manifest (tree structure, names,
dtypes, step metadata).  Restore is mesh-shape-agnostic: clusters are
self-describing, so any number of readers can re-partition them (elastic
restart across different host counts).

Trees are nested dicts, lists, tuples and NamedTuples of tensors (numpy
arrays and Python scalars are taken too); ``None`` holds no leaf.  A leaf's
name is the key string ``jax.tree_util.keystr`` gives the same path —
``['a']['b']`` for dict keys (sorted, as jax flattens them), ``[0]`` for
list and tuple items, ``.name`` for NamedTuple fields — so either package
restores the other's files.  Leaves go to the host with
``.detach().cpu().contiguous()`` and come back on the caller's ``device``.
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing
import re
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import (
    ParallelWriter, ReadOptions, RNTJReader, WriteOptions,
)
from repro_torch.core.mpwrite import MultiWriterCoordinator
from repro_torch.kernels.ops import resolve_device

from ._mpworker import (
    CKPT_SCHEMA, _entry_batch, dtype_name, run_save_worker, tensor_bytes,
    torch_dtype,
)


#: a restore decodes each cluster's pages on 4 threads with the next
#: cluster in flight: inflating a train state's gigabytes on the calling
#: thread alone set the restore's time
RESTORE_READ = ReadOptions(decode_workers=4, prefetch_clusters=2)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten_with_names(tree) -> Tuple[List[Tuple[str, Any]], Callable]:
    """-> ([(key string, leaf)], rebuild): the leaves in jax's flattening
    order, and ``rebuild(leaves)``, which puts new leaves in the same
    structure."""
    out: List[Tuple[str, Any]] = []

    def walk(x, name):
        if x is None:
            return lambda it: None
        if isinstance(x, dict):
            keys = sorted(x)  # jax flattens a dict in sorted key order
            subs = {k: walk(x[k], f"{name}[{k!r}]") for k in keys}

            def rebuild_dict(it):
                built = {k: subs[k](it) for k in keys}  # leaves come sorted
                return {k: built[k] for k in x}  # in the tree's own order
            return rebuild_dict
        if _is_namedtuple(x):
            subs = [walk(getattr(x, f), f"{name}.{f}") for f in x._fields]
            return lambda it: type(x)(*[s(it) for s in subs])
        if isinstance(x, (list, tuple)):
            subs = [walk(v, f"{name}[{i}]") for i, v in enumerate(x)]
            return lambda it: type(x)(s(it) for s in subs)
        out.append((name, x))
        return lambda it: next(it)

    build = walk(tree, "")
    return out, lambda leaves: build(iter(leaves))


def _host_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().contiguous()
    # numpy arrays and Python scalars take numpy's dtype, as in the reference
    return torch.from_numpy(np.array(leaf, order="C"))


def _host_arrays(leaves) -> List[torch.Tensor]:
    return [_host_tensor(l) for _, l in leaves]


def _work_units(arrays: List[torch.Tensor],
                row_block_bytes: int) -> List[Tuple[int, int, int]]:
    """(param_id, row range) blocks so large tensors spread across
    writers; every unit is independent (paper §1's reorderable rows)."""
    units: List[Tuple[int, int, int]] = []
    for pid, arr in enumerate(arrays):
        rows = arr.shape[0] if arr.ndim else 1
        nbytes = arr.numel() * arr.element_size()
        row_bytes = max(1, nbytes // max(rows, 1))
        block = max(1, row_block_bytes // row_bytes)
        start = 0
        while start < rows or (rows == 0 and start == 0):
            end = min(rows, start + block)
            units.append((pid, start, end))
            if end >= rows:
                break
            start = end
    return units


def _build_manifest(names: List[str], arrays: List[torch.Tensor],
                    metadata: Optional[Dict]) -> Dict:
    return {
        "names": names,
        "dtypes": [dtype_name(a.dtype) for a in arrays],
        "shapes": [list(a.shape) for a in arrays],
        "treedef": None,  # reconstructed from names at load
        "metadata": metadata or {},
    }


def _manifest_entry(manifest: Dict) -> Dict:
    return {
        "param_id": -1, "shard_index": 0, "shape": [],
        "row_start": 0, "row_end": 0,
        "data": json.dumps(manifest).encode(),
    }


def _unit_entry(arrays, u: int, unit: Tuple[int, int, int]) -> Dict:
    pid, r0, r1 = unit
    arr = arrays[pid]
    piece = arr[r0:r1] if arr.ndim else arr
    return {
        "param_id": pid, "shard_index": u,
        "shape": list(arr.shape),
        "row_start": r0, "row_end": r1,
        "data": tensor_bytes(piece),
    }


def _prepare(tree, metadata, row_block_bytes):
    leaves, _rebuild = _flatten_with_names(tree)
    arrays = _host_arrays(leaves)
    manifest = _build_manifest([n for n, _ in leaves], arrays, metadata)
    return manifest, arrays, _work_units(arrays, row_block_bytes)


def save_checkpoint(
    path: str,
    tree,
    n_writers: int = 4,
    row_block_bytes: int = 4 * 1024 * 1024,
    options: Optional[WriteOptions] = None,
    metadata: Optional[Dict] = None,
    device="cuda",
) -> Dict:
    """Parallel single-file save.

    ``n_writers`` simulates hosts: work (leaf row-blocks) is partitioned
    round-robin; each writer thread owns a fill context and commits its
    clusters through the shared reserve+metadata critical section.  In a
    real multi-host deployment each process runs one writer over its
    addressable shards and the critical section is the coordinator's
    extent ledger (DESIGN.md §3.2).  ``device`` is the writer's.
    """
    # journal=False: checkpoint durability comes from the temp-file +
    # atomic-rename commit protocol (a torn save is discarded wholesale,
    # never salvaged), so the per-cluster recovery framing would only add
    # bytes that no reader CRC covers — without it, every byte of a
    # committed checkpoint is checksummed and a flip is always detected
    options = options or WriteOptions(
        codec="zlib", level=1, cluster_bytes=32 * 1024 * 1024, journal=False
    )
    resolve_device(device)
    manifest, arrays, units = _prepare(tree, metadata, row_block_bytes)

    writer = ParallelWriter(CKPT_SCHEMA, path, options, device=device)

    # manifest entry (param_id = -1) goes in first
    mctx = writer.create_fill_context()
    mctx.fill_batch(_entry_batch([_manifest_entry(manifest)]))
    mctx.flush_cluster()

    def worker(widx: int):
        ctx = writer.create_fill_context()
        batch: List[Dict] = []
        for u, unit in enumerate(units):
            if u % n_writers != widx:
                continue
            batch.append(_unit_entry(arrays, u, unit))
            if sum(len(e["data"]) for e in batch) >= row_block_bytes:
                ctx.fill_batch(_entry_batch(batch))
                batch = []
        if batch:
            ctx.fill_batch(_entry_batch(batch))
        ctx.close()

    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(n_writers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    writer.close()
    return writer.stats.as_dict()


def save_checkpoint_mp(
    path: str,
    tree,
    n_processes: int = 2,
    row_block_bytes: int = 4 * 1024 * 1024,
    options: Optional[WriteOptions] = None,
    metadata: Optional[Dict] = None,
    mp_context: str = "spawn",
    crash_worker: Optional[int] = None,
    crash_after_units: int = 1,
    device="cuda",
) -> Dict:
    """N-**process** sharded save into ONE container file.

    The real-deployment shape of :func:`save_checkpoint`: each writer is
    a separate OS process joining the shared file through the side-car
    extent log (DESIGN.md §8.6) instead of a thread sharing the in-process
    reserve lock.  The parent acts as coordinator — it writes the manifest
    cluster through an in-process participant, hands each child its
    round-robin share of work units (pickled host bytes), then runs the
    footer-assembly rendezvous.

    A worker killed mid-save (or ``crash_worker=i`` for tests: worker *i*
    hard-exits after ``crash_after_units`` entries) is fenced at lease
    expiry and the seal degrades gracefully: every fully journaled cluster
    is kept, the crash is recorded in ``footer.extra["mpw"]``, and the
    returned report has ``degraded=True`` so callers (CheckpointManager)
    can refuse to commit.  ``load_checkpoint(strict=False)`` restores the
    surviving parameters from such a file.

    Unlike the thread path, mp saves keep ``journal=True`` — the journal
    framing is what makes per-writer clusters independently salvageable.
    ``device`` is every participant's writer device; children start with
    ``spawn`` by default, the one start method a process that has used a
    card can give its children.
    """
    resolve_device(device)
    options = options or WriteOptions(
        codec="zlib", level=1, cluster_bytes=32 * 1024 * 1024,
        lease_interval=2.0,
    )
    if not (options.buffered and options.journal):
        options = dataclasses.replace(options, buffered=True, journal=True)

    manifest, arrays, units = _prepare(tree, metadata, row_block_bytes)

    # Round-robin shards, materialized as picklable entry dicts.  In a
    # real multi-host job each process owns its addressable shards and no
    # bytes cross processes; here the parent holds the whole tree, so the
    # hand-off is the pickle through the spawn pipe.
    shards: List[List[Dict]] = [[] for _ in range(n_processes)]
    for u, unit in enumerate(units):
        shards[u % n_processes].append(_unit_entry(arrays, u, unit))

    # the with-block skips the rendezvous when the body raises, so a
    # parent-side failure doesn't stall on the straggler timeout
    with MultiWriterCoordinator(CKPT_SCHEMA, path, options) as coord:
        mw = coord.participant(device=device)
        mctx = mw.create_fill_context()
        mctx.fill_batch(_entry_batch([_manifest_entry(manifest)]))
        mctx.flush_cluster()
        mw.close()

        ctx = multiprocessing.get_context(mp_context)
        procs = []
        for i in range(n_processes):
            crash = crash_after_units if crash_worker == i else None
            p = ctx.Process(
                target=run_save_worker,
                args=(path, shards[i], row_block_bytes, options, crash,
                      device),
            )
            p.start()
            procs.append(p)
        for p in procs:
            p.join()
        exitcodes = [p.exitcode for p in procs]

        report = coord.seal(expect_writers=1 + n_processes)

    report["worker_exitcodes"] = exitcodes
    report["degraded"] = bool(
        report["fenced"] or report["salvaged"] or report["abandoned"]
        or any(c != 0 for c in exitcodes)
    )
    return report


def load_checkpoint(path: str, target_tree=None, device="cuda",
                    strict: bool = True):
    """-> (tree, metadata).  Reassembles from any cluster layout; every
    leaf comes back as a tensor on ``device`` (``"cuda"`` by default,
    ``RuntimeError`` without a card; ``"cpu"`` when asked).

    Entries that arrive before the manifest are buffered, not rejected —
    a salvaged multi-writer file's cluster order is the global reservation
    order, which can interleave worker data ahead of the manifest.

    ``strict=False`` tolerates an *incomplete* checkpoint (a degraded
    multi-writer seal after a worker crash): parameters with missing
    shards come back zero-filled and their names are listed under
    ``metadata["restore_missing"]``.  With ``strict=True`` (default) any
    gap raises ``IOError``.
    """
    dev = resolve_device(device)
    reader = RNTJReader(path, options=RESTORE_READ, device=dev)
    manifest = None
    # each leaf assembles as raw bytes, viewed as its dtype at the end
    buffers: Dict[int, np.ndarray] = {}
    covered: Dict[int, int] = {}
    pending: List[Tuple[int, tuple, int, int, np.ndarray]] = []

    def _row_bytes(pid, shape):
        item = torch_dtype(manifest["dtypes"][pid]).itemsize
        return item * int(np.prod(shape[1:], dtype=np.int64))

    def _alloc(pid, shape):
        nbytes = torch_dtype(manifest["dtypes"][pid]).itemsize * int(
            np.prod(shape, dtype=np.int64))
        # zeros (not empty) when gaps are tolerated: uncovered rows
        # must read as a defined value, not heap garbage
        return (np.empty if strict else np.zeros)(nbytes, np.uint8)

    def _apply(pid, shape, r0, r1, data):
        if pid not in buffers:
            buffers[pid] = _alloc(pid, shape)
        if len(shape):
            rb = _row_bytes(pid, shape)
            buffers[pid][r0 * rb:r1 * rb] = data
            covered[pid] = covered.get(pid, 0) + (r1 - r0)
        else:
            buffers[pid][:] = data
            covered[pid] = 1

    try:
        for pid, shape, r0, r1, data in _entries(reader):
            if pid == -1:
                manifest = json.loads(data.tobytes())
                for args in pending:
                    _apply(*args)
                pending = []
            elif manifest is None:
                pending.append((pid, shape, r0, r1, data.copy()))
            else:
                _apply(pid, shape, r0, r1, data)
    finally:
        reader.close()
    if manifest is None:
        raise IOError("checkpoint has no manifest entry")

    missing: List[str] = []
    leaves = []
    for pid, name in enumerate(manifest["names"]):
        shape = tuple(int(s) for s in manifest["shapes"][pid])
        need = shape[0] if shape else 1
        if covered.get(pid, 0) < need:
            missing.append(name)
            if pid not in buffers:
                buffers[pid] = np.zeros(
                    torch_dtype(manifest["dtypes"][pid]).itemsize
                    * int(np.prod(shape, dtype=np.int64)), np.uint8)
        leaves.append((buffers.pop(pid), manifest["dtypes"][pid], shape))
    if missing and strict:
        raise IOError(
            f"checkpoint incomplete: missing or partial params {missing}"
        )

    tensors = [_leaf_tensor(raw, dt, shape).to(dev)
               for raw, dt, shape in leaves]
    tree = _unflatten_by_names(manifest["names"], tensors, target_tree)
    meta = dict(manifest["metadata"])
    if missing:
        meta["restore_missing"] = missing
    return tree, meta


def _leaf_tensor(raw: np.ndarray, dt: str, shape) -> torch.Tensor:
    """A leaf's assembled bytes as a tensor of its dtype and shape (an
    empty leaf, such as a loader's leftover at step 0, has no bytes whose
    stride a dtype view could take)."""
    if raw.size == 0:
        return torch.empty(shape, dtype=torch_dtype(dt))
    return torch.from_numpy(raw).view(torch_dtype(dt)).reshape(shape)


def _entries(reader):
    """Every checkpoint entry as ``(param_id, shape, row_start, row_end,
    data)``, cluster by cluster from the reader's columns: ``data`` is a
    view of the cluster's byte column.  (``iter_cluster_entries`` would
    recompose each entry's bytes into a list of Python ints, about 10^9 of
    them for a 4 GB train state.)"""
    col = reader.schema.column_of_path
    for ci, cols in reader.iter_clusters(recycle=False):
        pids, r0s, r1s = (cols[col[k]] for k in ("param_id", "row_start",
                                                   "row_end"))
        shape_ends, shape_vals = cols[col["shape"]], cols[col["shape._0"]]
        data_ends, data = cols[col["data"]], cols[col["data._0"]]
        s0 = d0 = 0
        for j in range(reader.clusters[ci].n_entries):
            s1, d1 = int(shape_ends[j]), int(data_ends[j])
            yield (int(pids[j]), tuple(int(x) for x in shape_vals[s0:s1]),
                   int(r0s[j]), int(r1s[j]), data[d0:d1])
            s0, d0 = s1, d1


def _unflatten_by_names(names: List[str], leaves, target_tree=None):
    if target_tree is not None:
        flat, rebuild = _flatten_with_names(target_tree)
        by_name = dict(zip(names, leaves))
        return rebuild([by_name[n] for n, _ in flat])
    # build nested dicts from keystr names like "['a']['b']"
    root: Dict = {}
    for name, leaf in zip(names, leaves):
        keys = re.findall(r"\['([^']*)'\]|\[(\d+)\]|\.([A-Za-z_]\w*)", name)
        keys = [k or i or a for k, i, a in keys]
        cur = root
        for k in keys[:-1]:
            cur = cur.setdefault(k, {})
        cur[keys[-1]] = leaf
    return root
