"""Crash recovery: rebuild a torn RNT-J file's footer from its data region.

The writer's footer is written last, so a crash mid-run leaves a file
whose anchor/footer/page list never existed — unreadable to the normal
open path even though every committed cluster's bytes are intact.  With
``WriteOptions.journal`` (v2 files, default) the data region is
self-describing (DESIGN.md §8.3): each buffered cluster extent is

    [32-byte envelope][payload][journal record]

and each unbuffered cluster appended a journal record after its pages.
:func:`scan_container` walks the region front to back, hopping by the
declared lengths and resynchronizing on known magics after corruption;
a cluster is salvaged when its journal record parses, its envelope
agrees (seq, length, descriptor CRC), and its page checksums verify.
:func:`recover_container` then appends a fresh page list + footer +
anchor covering exactly the salvaged clusters — after which the normal
reader decodes every salvaged entry byte-identically.

What is *not* recoverable: the producer's last unsealed cluster (its
entries never reached the sink), any cluster whose extent is torn, and
the framed-member side-car (it is finalization metadata; salvaged
chunk-framed pages decode through the serial whole-page path instead).
Salvage also renumbers entries contiguously when a mid-file cluster is
dropped — entry *ranges* shift, entry *bytes* do not.
"""

from __future__ import annotations

import os
import shutil
import struct
import time
import zlib
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from .container import Sink, open_sink
from .metadata import (
    ANCHOR_SIZE,
    CLUSTER_ENV_MAGIC,
    CLUSTER_ENV_SIZE,
    JOURNAL_MAGIC,
    MAGIC,
    ClusterMeta,
    _ENV_HDR,
    _ENV_MAGIC,
    _JREC_HDR,
    build_anchor,
    build_footer,
    build_pagelist,
    parse_anchor,
    parse_cluster_envelope,
    parse_footer,
    parse_header,
    parse_journal_record,
    parse_pagelist,
)

_RESYNC_CHUNK = 1 << 20
_MAX_JREC = 64 << 20  # sanity bound on a declared journal-record length


class RecoveryError(IOError):
    """The file cannot be salvaged at all (e.g. the header is torn: the
    schema needed to interpret anything else is gone)."""


@dataclass
class RecoveryReport:
    """What a scan/recovery run found and did."""

    file_size: int = 0
    version: int = 0
    footer_valid: bool = False       # the file didn't need recovery
    clusters_salvaged: int = 0
    entries_salvaged: int = 0
    clusters_dropped: List[dict] = field(default_factory=list)
    journal_records: int = 0         # valid records seen in the scan
    envelopes: int = 0               # valid cluster envelopes seen
    resyncs: int = 0                 # magic-search recoveries after corruption
    garbage_bytes: int = 0           # bytes skipped while resynchronizing
    scan_bytes: int = 0              # data-region bytes walked
    scan_seconds: float = 0.0
    rebuilt: bool = False            # a fresh footer was appended
    output: Optional[str] = None
    # multi-writer salvage (side-car reservation log present): per-writer
    # attribution, fenced/done sets, orphaned reservations (DESIGN.md §8.6)
    multiwriter: Optional[dict] = None
    # remote salvage (object-store source): which case ran — final object
    # repaired, or interrupted multipart reassembled (DESIGN.md §10)
    remote: Optional[dict] = None
    # zone-map disposition (DESIGN.md §11): the journal cannot attest
    # page statistics, so a rebuild drops them rather than serve
    # possibly-stale bounds; the reason is recorded here
    zonemaps: Optional[dict] = None

    def as_dict(self) -> dict:
        return {
            "file_size": self.file_size,
            "version": self.version,
            "footer_valid": self.footer_valid,
            "clusters_salvaged": self.clusters_salvaged,
            "entries_salvaged": self.entries_salvaged,
            "clusters_dropped": self.clusters_dropped,
            "journal_records": self.journal_records,
            "envelopes": self.envelopes,
            "resyncs": self.resyncs,
            "garbage_bytes": self.garbage_bytes,
            "scan_bytes": self.scan_bytes,
            "scan_seconds": self.scan_seconds,
            "rebuilt": self.rebuilt,
            "output": self.output,
            "multiwriter": self.multiwriter,
            "remote": self.remote,
            "zonemaps": self.zonemaps,
        }


# ---------------------------------------------------------------------------
# scanning


def _read_exact(sink: Sink, off: int, size: int) -> Optional[bytes]:
    """``size`` bytes at ``off``, or ``None`` when the file is too short
    or the read fails (a torn tail must not abort the scan)."""
    try:
        buf = sink.pread(off, size)
    except (OSError, ValueError, EOFError):
        return None
    return buf if len(buf) == size else None


_MAGICS = (CLUSTER_ENV_MAGIC, JOURNAL_MAGIC, _ENV_MAGIC, MAGIC)


def _resync(sink: Sink, pos: int, size: int, report: RecoveryReport) -> int:
    """Find the next known magic at or after ``pos``; returns its offset
    (or ``size`` when none remains).  Called only after corruption."""
    report.resyncs += 1
    start = pos
    while pos < size:
        chunk = _read_exact(sink, pos, min(_RESYNC_CHUNK + 4, size - pos))
        if chunk is None:
            pos = size
            break
        best = None
        for magic in _MAGICS:
            i = chunk.find(magic)
            if i >= 0 and (best is None or i < best):
                best = i
        if best is not None:
            pos += best
            break
        # overlap by 3 so a magic split across chunks is still found
        step = max(1, len(chunk) - 3)
        pos += step
    report.garbage_bytes += pos - start
    return min(pos, size)


def _parse_header_env(sink: Sink, report: RecoveryReport):
    hdr = _read_exact(sink, 0, _ENV_HDR.size)
    if hdr is None:
        raise RecoveryError("file too short for a header envelope")
    try:
        magic, etype, plen = _ENV_HDR.unpack(hdr)
    except struct.error as e:  # pragma: no cover - size checked above
        raise RecoveryError(str(e))
    if magic != _ENV_MAGIC:
        raise RecoveryError("no header envelope at offset 0 (bad magic)")
    total = _ENV_HDR.size + plen + 4
    buf = _read_exact(sink, 0, total)
    if buf is None:
        raise RecoveryError("header envelope torn (file shorter than header)")
    try:
        schema, options = parse_header(buf)
    except (IOError, ValueError, KeyError) as e:
        raise RecoveryError(f"header envelope corrupt: {e}")
    return schema, options, total


def _verify_cluster_pages(sink: Sink, jr, size: int,
                          verify_pages: bool) -> Optional[str]:
    """None when the cluster's bytes check out, else the drop reason."""
    if jr.buffered:
        end = jr.cluster_off + jr.cluster_size
        if end > size:
            return "payload extends past end of file"
        if not verify_pages:
            return None
        payload = _read_exact(sink, jr.cluster_off, jr.cluster_size)
        if payload is None:
            return "payload unreadable"
        for p in jr.pages:
            rel = p.offset - jr.cluster_off
            if rel < 0 or rel + p.size > len(payload):
                return "page outside payload extent"
            if p.checksum and zlib.crc32(payload[rel:rel + p.size]) != p.checksum:
                return "page checksum mismatch"
        return None
    # unbuffered: pages are scattered; validate each in place
    for p in jr.pages:
        if p.offset + p.size > size:
            return "page extends past end of file"
        if not verify_pages:
            continue
        buf = _read_exact(sink, p.offset, p.size)
        if buf is None:
            return "page unreadable"
        if p.checksum and zlib.crc32(buf) != p.checksum:
            return "page checksum mismatch"
    return None


def scan_container(
    sink: Sink, verify_pages: bool = True, xlog_state=None
) -> Tuple[object, dict, List[ClusterMeta], RecoveryReport]:
    """Scan a (possibly torn) RNT-J file's data region and return
    ``(schema, header_options, salvaged_clusters, report)``.

    The salvaged :class:`ClusterMeta` list is ordered by commit sequence
    with entry ranges renumbered contiguously — exactly what a page list
    wants.  Raises :class:`RecoveryError` only when the header itself is
    unusable; everything else degrades to dropped clusters.

    ``xlog_state`` (a replayed :class:`repro_torch.core.extents.LogState` from
    the multi-writer side-car log) enables **fencing enforcement**: a
    journal record is additionally required to sit inside a reservation
    owned by the same ``(writer_id, epoch)`` — a stale-epoch writer's
    late writes are rejected here even if their CRCs are pristine — and
    the report gains per-writer attribution (``report.multiwriter``)."""
    t0 = time.perf_counter()
    size = sink.size
    report = RecoveryReport(file_size=size)
    schema, options, pos = _parse_header_env(sink, report)
    report.version = 2  # journal framing implies v2

    envelopes = {}   # seq -> {"payload_off", "payload_len", "desc_crc"}
    journals = {}    # seq -> JournalRecord
    while pos + 4 <= size:
        magic = _read_exact(sink, pos, 4)
        if magic is None:
            break
        if magic == CLUSTER_ENV_MAGIC:
            buf = _read_exact(sink, pos, CLUSTER_ENV_SIZE)
            env = None
            if buf is not None:
                try:
                    env = parse_cluster_envelope(buf)
                except IOError:
                    env = None
            if env is None:
                pos = _resync(sink, pos + 1, size, report)
                continue
            report.envelopes += 1
            env["payload_off"] = pos + CLUSTER_ENV_SIZE
            envelopes.setdefault(env["seq"], env)
            # hop over the payload; its tail carries the journal record
            pos += CLUSTER_ENV_SIZE + env["payload_len"]
        elif magic == JOURNAL_MAGIC:
            hdr = _read_exact(sink, pos, _JREC_HDR.size)
            jr = None
            if hdr is not None:
                _m, plen = _JREC_HDR.unpack(hdr)
                total = _JREC_HDR.size + plen + 4
                if 0 < plen <= _MAX_JREC and pos + total <= size:
                    buf = _read_exact(sink, pos, total)
                    if buf is not None:
                        try:
                            jr, _end = parse_journal_record(buf, 0)
                        except IOError:
                            jr = None
            if jr is None:
                pos = _resync(sink, pos + 1, size, report)
                continue
            report.journal_records += 1
            jr.end = pos + _JREC_HDR.size + plen + 4
            journals.setdefault(jr.seq, jr)
            pos = jr.end
        elif magic == _ENV_MAGIC:
            # a finalization envelope (page list / footer / member
            # side-car) from a previous successful close: hop over it
            hdr = _read_exact(sink, pos, _ENV_HDR.size)
            if hdr is None:
                break
            _m, _t, plen = _ENV_HDR.unpack(hdr)
            total = _ENV_HDR.size + plen + 4
            if plen > size or pos + total > size:
                pos = _resync(sink, pos + 1, size, report)
                continue
            pos += total
        elif magic == MAGIC:
            # an anchor (previous finalization); fixed size
            pos += ANCHOR_SIZE
        else:
            pos = _resync(sink, pos, size, report)
    report.scan_bytes = pos

    # -- validate: a cluster survives when journal + envelope agree ---------
    res_by_off = {}
    if xlog_state is not None:
        res_by_off = {r.offset: r for r in xlog_state.reservations.values()}
    per_writer: dict = {}
    clusters: List[ClusterMeta] = []
    for seq in sorted(journals):
        jr = journals[seq]
        reason = None
        if jr.buffered:
            env = envelopes.get(seq)
            if env is None:
                reason = "envelope missing or corrupt"
            elif (env["payload_len"] != jr.cluster_size
                  or env["desc_crc"] != jr.crc
                  or env["payload_off"] != jr.cluster_off):
                reason = "envelope/journal disagree"
        if reason is None and xlog_state is not None and jr.buffered:
            # fencing enforcement: the extent must be a reservation OWNED
            # by this exact (writer_id, epoch).  A fenced writer that
            # rejoined got a fresh epoch, so its stale process's late
            # writes — however intact — fail this check and are dropped.
            r = res_by_off.get(jr.cluster_off - CLUSTER_ENV_SIZE)
            if r is None:
                reason = "extent has no reservation in the side-car log"
            elif (r.writer_id != jr.writer_id or r.epoch != jr.epoch
                  or r.seq != jr.seq):
                reason = "journal record from a fenced epoch"
        if reason is None:
            reason = _verify_cluster_pages(sink, jr, size, verify_pages)
        if reason is not None:
            report.clusters_dropped.append({"seq": seq, "reason": reason})
            continue
        if jr.writer_id:
            pw = per_writer.setdefault(
                jr.writer_id, {"clusters": 0, "entries": 0})
            pw["clusters"] += 1
            pw["entries"] += jr.n_entries
        clusters.append(
            ClusterMeta(
                first_entry=0,  # renumbered below
                n_entries=jr.n_entries,
                n_elements=list(jr.n_elements),
                pages=list(jr.pages),
                byte_offset=jr.cluster_off if jr.buffered else 0,
                byte_size=jr.cluster_size if jr.buffered else 0,
            )
        )
    n = 0
    for cm in clusters:
        cm.first_entry = n
        n += cm.n_entries
    report.clusters_salvaged = len(clusters)
    report.entries_salvaged = n
    if xlog_state is not None:
        salvaged_offs = {cm.byte_offset - CLUSTER_ENV_SIZE
                         for cm in clusters if cm.byte_size}
        orphaned = [
            {"writer": r.writer_id, "offset": r.offset, "size": r.size,
             "committed": r.committed}
            for r in xlog_state.reservations.values()
            if r.offset not in salvaged_offs
        ]
        report.multiwriter = {
            "writers": {str(w.writer_id): dict(
                per_writer.get(w.writer_id, {"clusters": 0, "entries": 0}),
                fenced=w.fenced, done=w.done)
                for w in xlog_state.writers.values()},
            "sealed": xlog_state.sealed,
            "orphaned_reservations": orphaned,
        }
    report.scan_seconds = time.perf_counter() - t0
    return schema, options, clusters, report


# ---------------------------------------------------------------------------
# recovery


def _load_xlog_state(container_path: str):
    """``(state, stale)``: the replayed side-car reservation-log state, or
    ``(None, False)`` when absent (single-writer files) or unreadable
    (recovery must still proceed).

    The log is only trusted when its generation id matches the one in the
    container header — CREATE and the header are stamped with the same id
    by the coordinator.  A mismatch means the log belongs to a *previous*
    file at this path (a crashed or degraded run never unlinks it): its
    fencing state would drop every valid cluster of the current file, so
    it is ignored and reported as ``(None, True)`` instead."""
    from .extents import XLOG_SUFFIX, replay_log
    path = os.fspath(container_path)
    try:
        with open(path + XLOG_SUFFIX, "rb") as f:
            state = replay_log(f.read())
    except OSError:
        return None, False
    expect = None
    try:
        with open(path, "rb") as f:
            hdr = f.read(_ENV_HDR.size)
            if len(hdr) == _ENV_HDR.size:
                magic, _t, plen = _ENV_HDR.unpack(hdr)
                if magic == _ENV_MAGIC:
                    _sch, opts = parse_header(hdr + f.read(plen + 4))
                    expect = opts.get("mpw_gen")
    except (OSError, IOError, ValueError, KeyError, struct.error):
        expect = None
    if state.generation != expect:
        return None, True
    return state, False


def _footer_clusters(sink: Sink) -> Optional[int]:
    """Entry count from a valid anchor+footer chain, or ``None``."""
    try:
        size = sink.size
        if size < ANCHOR_SIZE:
            return None
        anchor = parse_anchor(sink.pread(size - ANCHOR_SIZE, ANCHOR_SIZE))
        f_off, f_size = anchor["footer"]
        footer = parse_footer(sink.pread(f_off, f_size))
        pl_off, pl_size = footer["pagelist"]
        parse_pagelist(sink.pread(pl_off, pl_size))
        return int(anchor["n_entries"])
    except (IOError, ValueError, KeyError, struct.error):
        return None


def recover_container(
    source,
    output: Optional[str] = None,
    dry_run: bool = False,
    verify_pages: bool = True,
    force: bool = False,
) -> RecoveryReport:
    """Salvage a torn RNT-J file and append a fresh footer in place (or
    into a copy at ``output``).

    ``source`` is a path or an open readable :class:`Sink`.  A file whose
    footer chain is already valid is left untouched (``footer_valid`` in
    the report) unless ``force``.  ``dry_run`` scans and reports without
    writing.  Returns the :class:`RecoveryReport`; raises
    :class:`RecoveryError` when even the header is unusable.

    When the source is a path and a multi-writer side-car reservation log
    (``<path>.mpwlog``) sits next to it — a crash before the coordinator's
    rendezvous sealed the file — its replayed state drives fencing
    enforcement and per-writer attribution (see :func:`scan_container`).
    The log must carry the container header's generation id: a stale log
    from a previous file at the same path is ignored (plain scan, no
    fencing) and flagged as ``multiwriter["stale_log_ignored"]``."""
    owns = False
    xlog_state, xlog_stale = None, False
    if isinstance(source, (str, os.PathLike)):
        path = os.fspath(source)
        if "://" in path:
            # remote container: salvage the final object or an interrupted
            # multipart upload, journal-scan in memory, put the rebuilt
            # container back (DESIGN.md §10).  The object IS the output.
            if output is not None:
                raise ValueError("output= is not supported for remote URLs")
            from .remote import salvage_remote_url  # local import: no cycle
            return salvage_remote_url(path, dry_run=dry_run,
                                      verify_pages=verify_pages, force=force)
        xlog_state, xlog_stale = _load_xlog_state(path)
        if output is not None:
            if not dry_run:
                shutil.copyfile(path, output)
                path = output
        sink = open_sink(path, create=False)
        owns = True
    else:
        if output is not None:
            raise ValueError("output= requires a path source")
        sink = source
    try:
        entries = _footer_clusters(sink)
        if entries is not None and not force:
            report = RecoveryReport(file_size=sink.size, footer_valid=True)
            report.entries_salvaged = entries
            report.output = output
            return report
        schema, _options, clusters, report = scan_container(
            sink, verify_pages=verify_pages, xlog_state=xlog_state
        )
        if xlog_stale:
            # a side-car log was present but belongs to a previous file
            # at this path: plain scan ran without fencing enforcement
            report.multiwriter = {"stale_log_ignored": True}
        report.output = output
        if dry_run:
            return report
        _rebuild_footer(sink, schema, clusters, report)
        report.rebuilt = True
        return report
    finally:
        if owns:
            sink.close()


def _rebuild_footer(sink: Sink, schema, clusters: List[ClusterMeta],
                    report: RecoveryReport) -> None:
    """Append page list + footer + anchor covering the salvaged clusters.

    The header at offset 0 is reused verbatim (it already records the
    schema and effective encodings).  The footer's ``extra`` carries the
    salvage provenance so readers/tools can tell a recovered file."""
    n_entries = report.entries_salvaged
    pl = build_pagelist(clusters, schema.n_columns)
    pl_off = sink.reserve(len(pl))
    sink.pwrite(pl_off, pl)
    # Zone maps are finalization metadata (like the framed-member
    # side-car): the journal records the scan trusts never carry them,
    # so a rebuilt footer cannot attest any bounds a previous footer
    # claimed.  Drop them — pruning degrades to a full scan, which is
    # always correct — and say why in the report.  They are recomputed
    # whenever the salvaged clusters re-encode through a merge.
    report.zonemaps = {
        "preserved": False,
        "reason": "journal records carry no page statistics; "
                  "rebuilt footer omits zone maps instead of serving "
                  "unattested bounds",
    }
    extra = {
        "recovered": {
            "clusters_salvaged": report.clusters_salvaged,
            "clusters_dropped": len(report.clusters_dropped),
            "scanned_bytes": report.scan_bytes,
            "zonemaps_dropped": True,
        }
    }
    ftr = build_footer(n_entries, len(clusters), (pl_off, len(pl)), extra=extra)
    f_off = sink.reserve(len(ftr))
    sink.pwrite(f_off, ftr)
    hdr16 = sink.pread(0, _ENV_HDR.size)
    _m, _t, hplen = _ENV_HDR.unpack(hdr16)
    anchor = build_anchor((0, _ENV_HDR.size + hplen + 4), (f_off, len(ftr)),
                          n_entries, len(clusters))
    a_off = sink.reserve(ANCHOR_SIZE)
    sink.pwrite(a_off, anchor)
    sink.fsync()
