"""AGC-style dataset skimming (paper §6.2), all five strategies of Fig. 5,
the twin of ``repro.skim.engine`` on the port's ``core``.

Event model (a faithful miniature of the CMS ttbar skim):
    { event_id, met, electrons_pt[], muons_pt[], jets_pt[] }

Three skims, applied together exactly like the paper:
  * horizontal — drop unused columns (schema projection)
  * vertical   — keep events with >=1 electron AND >=1 muon AND >=4 jets
                 above the coarse cut
  * nested     — drop collection elements below the cut

Strategies (paper Fig. 5):
  imt            one sequential writer per partition, page-compression pool
  separate       one file per input shard, then hadd-style merge
  buffermerger   per-worker in-memory files merged from worker threads
  parallel       the paper's parallel writer (one file per partition)
  separate-null  separate files into /dev/null (scalability ceiling)

``make_agc_dataset``, ``skim_file`` and ``skim_partitions`` take
``device=`` (default ``"cuda"``, ``RuntimeError`` without a card;
``"cpu"`` when asked) and hand it to every writer, merger and reader they
build: the writers' seals run K1 (fill batches of at least 65,536
entries) and K2 (page blocks of at least 256 KiB) there.  The skim itself
stays numpy on the host, over the reader's host decode, as in the
reference.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import (
    BufferMerger, Collection, ColumnBatch, F, Leaf, ParallelWriter,
    ReadOptions, RNTJReader, Schema, SequentialWriter, WriteOptions,
    close_all, merge_files,
)
from repro_torch.core.filter import Expr
from repro_torch.kernels.ops import resolve_device

EVENT_SCHEMA = Schema([
    Leaf("event_id", "int64"),
    Leaf("met", "float32"),
    Collection("electrons_pt", Leaf("_0", "float32")),
    Collection("muons_pt", Leaf("_0", "float32")),
    Collection("jets_pt", Leaf("_0", "float32")),
])

# horizontal skim keeps these fields (drops met)
KEEP_FIELDS = ["event_id", "electrons_pt", "muons_pt", "jets_pt"]

STRATEGIES = ("imt", "separate", "buffermerger", "parallel", "separate-null")


@dataclass(frozen=True)
class Cuts:
    pt_cut: float = 20.0
    min_electrons: int = 1
    min_muons: int = 1
    min_jets: int = 4


def cuts_expr(cuts: Cuts) -> Optional[Expr]:
    """The zone-map pushdown predicate IMPLIED by the vertical skim.

    Conservative by construction: an event passing the cuts necessarily
    has at least one above-``pt_cut`` element in every collection whose
    ``min_*`` is >= 1 (the count thresholds themselves cannot be
    expressed over zone bounds), so pruning by this expression never
    drops an event the kernel would keep — the kernel re-applies the
    exact cuts on whatever survives.  A collection with ``min_* == 0``
    imposes no existential requirement and contributes no atom (an
    electron-only channel must not prune on muons); with every min at
    zero there is nothing to push down and this returns ``None``."""
    atoms = [F(path) > float(cuts.pt_cut)
             for path, need in (("electrons_pt._0", cuts.min_electrons),
                                ("muons_pt._0", cuts.min_muons),
                                ("jets_pt._0", cuts.min_jets))
             if need >= 1]
    if not atoms:
        return None
    expr = atoms[0]
    for a in atoms[1:]:
        expr = expr & a
    return expr


# ---------------------------------------------------------------------------
# synthetic AGC-like dataset


def make_agc_dataset(
    directory: str,
    n_partitions: int = 9,
    files_per_partition: int = 4,
    events_per_file: int = 20_000,
    seed: int = 0,
    options: Optional[WriteOptions] = None,
    device="cuda",
) -> Dict[int, List[str]]:
    """-> {partition: [input files]} (the paper's 787-file / 9-partition
    layout, scaled to this container); each file one fill batch of a
    ``SequentialWriter`` on ``device``."""
    device = resolve_device(device)
    options = options or WriteOptions(codec="zlib", level=1,
                                      cluster_bytes=2 * 1024 * 1024)
    out: Dict[int, List[str]] = {}
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    for part in range(n_partitions):
        out[part] = []
        for f in range(files_per_partition):
            rng = np.random.default_rng(seed + 1000 * part + f)
            path = str(d / f"part{part}_file{f}.rntj")
            batch = _synth_events(rng, events_per_file,
                                  id0=(part * files_per_partition + f) * events_per_file)
            with SequentialWriter(EVENT_SCHEMA, path, options,
                                  device=device) as w:
                w.fill_batch(batch)
            out[part].append(path)
    return out


def _synth_events(rng: np.random.Generator, n: int, id0: int) -> ColumnBatch:
    ne = rng.poisson(1.2, n).astype(np.int64)
    nm = rng.poisson(1.2, n).astype(np.int64)
    nj = rng.poisson(6.0, n).astype(np.int64)
    pt = lambda total: rng.exponential(18.0, int(total)).astype(np.float32) + 5.0
    return ColumnBatch.from_arrays(EVENT_SCHEMA, n, {
        "event_id": np.arange(id0, id0 + n, dtype=np.int64),
        "met": rng.exponential(30.0, n).astype(np.float32),
        "electrons_pt": ne, "electrons_pt._0": pt(ne.sum()),
        "muons_pt": nm, "muons_pt._0": pt(nm.sum()),
        "jets_pt": nj, "jets_pt._0": pt(nj.sum()),
    })


# ---------------------------------------------------------------------------
# the skim kernel (vectorized, per cluster)

OUT_SCHEMA = EVENT_SCHEMA.project(KEEP_FIELDS)

# every strategy streams its inputs through the read engine's prefetch
# pipeline: cluster i+1 is read+decoded while the skim kernel chews on i
DEFAULT_READ_OPTIONS = ReadOptions(prefetch_clusters=1)


def _skim_cluster_arrays(
    s: Schema, cols: Dict[int, np.ndarray], n: int, cuts: Cuts
) -> Optional[ColumnBatch]:
    """The vectorized skim kernel over one cluster's column arrays."""

    def coll(path):
        offs = cols[s.column_of_path[path]].astype(np.int64)
        vals = cols[s.column_of_path[path + "._0"]]
        sizes = np.empty_like(offs)
        if len(offs):
            sizes[0] = offs[0]
            np.subtract(offs[1:], offs[:-1], out=sizes[1:])
        return sizes, vals

    e_sz, e_pt = coll("electrons_pt")
    m_sz, m_pt = coll("muons_pt")
    j_sz, j_pt = coll("jets_pt")

    def count_above(sizes, vals):
        mask = vals > cuts.pt_cut
        idx = np.repeat(np.arange(n), sizes)
        return np.bincount(idx, weights=mask.astype(np.float64), minlength=n), mask

    e_cnt, e_keep = count_above(e_sz, e_pt)
    m_cnt, m_keep = count_above(m_sz, m_pt)
    j_cnt, j_keep = count_above(j_sz, j_pt)

    keep = ((e_cnt >= cuts.min_electrons) & (m_cnt >= cuts.min_muons)
            & (j_cnt >= cuts.min_jets))          # vertical skim
    if not keep.any():
        return None

    def nested(sizes, vals, elem_keep):
        ev_of_elem = np.repeat(keep, sizes)
        m = elem_keep & ev_of_elem                 # nested skim
        new_vals = vals[m]
        idx = np.repeat(np.arange(n), sizes)
        new_sizes = np.bincount(idx, weights=m.astype(np.float64), minlength=n)
        return new_sizes[keep].astype(np.int64), new_vals

    e_s, e_v = nested(e_sz, e_pt, e_keep)
    m_s, m_v = nested(m_sz, m_pt, m_keep)
    j_s, j_v = nested(j_sz, j_pt, j_keep)
    ids = cols[s.column_of_path["event_id"]][keep]

    return ColumnBatch.from_arrays(OUT_SCHEMA, int(keep.sum()), {
        "event_id": ids,
        "electrons_pt": e_s, "electrons_pt._0": e_v,
        "muons_pt": m_s, "muons_pt._0": m_v,
        "jets_pt": j_s, "jets_pt._0": j_v,
    })


def _concat_batches(schema: Schema, batches: List[ColumnBatch]) -> ColumnBatch:
    """Concatenate kept sub-batches of ONE input cluster into the single
    batch the unpruned path would have filled (offset columns carry
    per-collection sizes, so concatenation is plain per column)."""
    if len(batches) == 1:
        return batches[0]
    data = {
        c.index: np.concatenate([b.data[c.index] for b in batches])
        for c in schema.columns
    }
    return ColumnBatch(schema, sum(b.n_entries for b in batches), data)


def skim_file(
    in_path: str,
    fill,
    cuts: Cuts,
    read_options: Optional[ReadOptions] = None,
    pushdown: bool = True,
    device="cuda",
) -> int:
    """Skim one input file into ``fill(batch)``; returns kept events.

    Streams through the read engine's shared entry-range-selection
    helper (``iter_cluster_segments``), so the pruned and unpruned paths
    share partition boundaries: exactly ONE output batch is filled per
    surviving input cluster in both modes, which keeps output files
    byte-identical (DESIGN.md §11).  With ``pushdown`` (default) and no
    explicit ``ReadOptions.filter``, the predicate implied by ``cuts``
    is pushed down; zone-map pruning then skips clusters/pages that
    cannot contain a passing event before any pread.  Cuts that imply
    no predicate (every ``min_*`` at zero), files without zone maps,
    and ``prune=False`` all degrade to the full scan.  The reader opens
    on ``device``; its host decode feeds the skim.
    """
    ropts = read_options or DEFAULT_READ_OPTIONS
    if pushdown and ropts.filter is None:
        expr = cuts_expr(cuts)
        if expr is not None:
            ropts = replace(ropts, filter=expr)
    r = RNTJReader(in_path, options=ropts, device=device)
    kept = 0
    try:
        for _ci, segments in r.iter_cluster_segments():
            parts = []
            for _e0, cols, n in segments:
                b = _skim_cluster_arrays(r.schema, cols, n, cuts)
                if b is not None:
                    parts.append(b)
            if parts:
                batch = _concat_batches(OUT_SCHEMA, parts)
                fill(batch)
                kept += batch.n_entries
    finally:
        r.close()
    return kept


# ---------------------------------------------------------------------------
# strategies (paper Fig. 5)


def skim_partitions(
    partitions: Dict[int, List[str]],
    out_dir: str,
    strategy: str,
    n_threads: int,
    cuts: Cuts = Cuts(),
    options: Optional[WriteOptions] = None,
    imt_workers: Optional[int] = None,
    read_options: Optional[ReadOptions] = None,
    pushdown: bool = True,
    device="cuda",
) -> Dict:
    """Skim all partitions with the given strategy; returns stats.

    ``pushdown`` (default on) pushes the predicate implied by ``cuts``
    into every strategy's readers (see :func:`skim_file`): zone-mapped
    inputs prune, legacy inputs full-scan, outputs stay byte-identical.

    Every resource (the thread pool, per-worker writers, merger files) is
    released on the error path too: a worker raising propagates the
    exception instead of leaking threads and half-written files.

    The output writers inherit the I/O engine (DESIGN.md §6) straight
    from ``WriteOptions``: the default enables bounded write-behind, so a
    skim worker seals its next cluster while the previous extent drains
    instead of stalling inside the commit on output-device latency.

    Every writer, merger and reader runs on ``device``.
    """
    assert strategy in STRATEGIES, strategy
    device = resolve_device(device)
    options = options or WriteOptions(codec="zlib", level=1,
                                      cluster_bytes=2 * 1024 * 1024,
                                      io_inflight_bytes=16 * 1024 * 1024)
    ropts = read_options or DEFAULT_READ_OPTIONS
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    kept_total = [0]
    kept_lock = threading.Lock()

    def add_kept(k):
        with kept_lock:
            kept_total[0] += k

    pool = ThreadPoolExecutor(max_workers=n_threads)
    try:
        if strategy == "imt":
            # parallelize over partitions only; page compression pool inside.
            per_part = max(1, n_threads // max(len(partitions), 1))
            opts = WriteOptions(**{**options.__dict__,
                                   "imt_workers": imt_workers or per_part})
            def run_part(part, files):
                w = SequentialWriter(OUT_SCHEMA, str(out / f"skim_{part}.rntj"),
                                     opts, device=device)
                try:
                    for f in files:
                        add_kept(skim_file(f, w.fill_batch, cuts, ropts,
                                           pushdown, device))
                finally:
                    w.close()
            futs = [pool.submit(run_part, p, fs) for p, fs in partitions.items()]
            for fu in futs:
                fu.result()

        elif strategy in ("separate", "separate-null"):
            tmp_files: Dict[int, List[str]] = {p: [] for p in partitions}
            def run_file(part, i, f):
                dst = ("/dev/null" if strategy == "separate-null"
                       else str(out / f"tmp_{part}_{i}.rntj"))
                w = SequentialWriter(OUT_SCHEMA, dst, options, device=device)
                try:
                    add_kept(skim_file(f, w.fill_batch, cuts, ropts,
                                       pushdown, device))
                finally:
                    w.close()
                if strategy == "separate":
                    tmp_files[part].append(dst)
            futs = [pool.submit(run_file, p, i, f)
                    for p, fs in partitions.items() for i, f in enumerate(fs)]
            for fu in futs:
                fu.result()
            if strategy == "separate":
                # hadd-style merge per partition (parallel over partitions)
                futs = [pool.submit(merge_files, tmp_files[p],
                                    str(out / f"skim_{p}.rntj"), options,
                                    device=device)
                        for p in partitions]
                for fu in futs:
                    fu.result()

        elif strategy == "buffermerger":
            mergers = {p: BufferMerger(OUT_SCHEMA, str(out / f"skim_{p}.rntj"),
                                       options, device=device)
                       for p in partitions}
            try:
                def run_file(part, f):
                    bmf = mergers[part].get_file()
                    try:
                        add_kept(skim_file(f, bmf.fill_batch, cuts, ropts,
                                           pushdown, device))
                    finally:
                        bmf.close()
                futs = [pool.submit(run_file, p, f)
                        for p, fs in partitions.items() for f in fs]
                for fu in futs:
                    fu.result()
            finally:
                close_all(mergers.values())

        else:  # parallel — the paper's contribution
            writers = {p: ParallelWriter(OUT_SCHEMA, str(out / f"skim_{p}.rntj"),
                                         options, device=device)
                       for p in partitions}
            try:
                def run_file(part, f):
                    ctx = writers[part].create_fill_context()
                    try:
                        add_kept(skim_file(f, ctx.fill_batch, cuts, ropts,
                                           pushdown, device))
                    finally:
                        ctx.close()
                futs = [pool.submit(run_file, p, f)
                        for p, fs in partitions.items() for f in fs]
                for fu in futs:
                    fu.result()
            finally:
                close_all(writers.values())
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    return {"kept_events": kept_total[0], "strategy": strategy,
            "n_threads": n_threads}
