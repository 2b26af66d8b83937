"""On-disk metadata: envelopes, page list, footer, anchor.

Layout (RNT-J, a faithful simplification of RNTuple-in-TFile):

    file := header_env { cluster blobs / pages } pagelist_env footer_env anchor

* header envelope   — schema + write options (self-describing)
* page list envelope— per committed cluster, in entry order: entry range,
  per-column element counts, and every page descriptor (paper §3's "page
  list" + "column ranges": the element offset of each column in a cluster
  is the running sum of the per-cluster element counts, in cluster order)
* footer envelope   — cluster summaries + locator of the page list
* anchor            — fixed 64-byte trailer at EOF locating header+footer

Metadata is appended **in commit order** under the writer's critical
section, so the resulting file is indistinguishable from one written
sequentially (paper §4.3).
"""

from __future__ import annotations

import json
import struct
import zlib
from dataclasses import dataclass, field, replace as dc_replace
from typing import List, Optional, Tuple

import numpy as np

from .pages import PageDesc
from .schema import ENC_NONE, Schema

MAGIC = b"RNTJ"
# v2 adds the per-cluster recovery envelope + commit journal (DESIGN.md §8).
# v1 files (no journal) remain fully readable; v2 readers accept both.
# v3 exists only inside journal records: multi-writer commits stamp each
# record with (writer_id, epoch) for fencing (DESIGN.md §8.6).  The anchor
# and envelopes stay at v2 — a sealed multi-writer file is indistinguishable
# from a single-writer one except for the wider journal records.
VERSION = 2
JREC_VERSION_MP = 3
SUPPORTED_VERSIONS = (1, 2, 3)

ENV_HEADER = 1
ENV_PAGELIST = 2
ENV_FOOTER = 3
ENV_MEMBERS = 4   # optional framed-member side-car (DESIGN.md §6.4)

_ENV_HDR = struct.Struct("<4sHxxQ")  # magic, type, pad, payload_len
_ENV_MAGIC = b"RJEV"

_ANCHOR = struct.Struct("<4sIQQQQQQI4x")  # magic, ver, hdr(off,size), ftr(off,size), n_entries, n_clusters, crc
ANCHOR_SIZE = _ANCHOR.size  # 64 bytes

# page descriptor record on disk
_PAGE_REC = np.dtype(
    [
        ("column", "<u4"),
        ("codec", "<u1"),
        ("_pad", "V3"),
        ("n_elements", "<u8"),
        ("offset", "<u8"),
        ("size", "<u8"),
        ("uncompressed_size", "<u8"),
        ("checksum", "<u4"),
        ("_pad2", "V4"),
    ]
)


def wrap_envelope(env_type: int, payload: bytes) -> bytes:
    hdr = _ENV_HDR.pack(_ENV_MAGIC, env_type, len(payload))
    crc = struct.pack("<I", zlib.crc32(payload))
    return hdr + payload + crc


def unwrap_envelope(buf: bytes, expect_type: int) -> bytes:
    magic, etype, plen = _ENV_HDR.unpack_from(buf, 0)
    if magic != _ENV_MAGIC:
        raise IOError("bad envelope magic")
    if etype != expect_type:
        raise IOError(f"envelope type {etype}, expected {expect_type}")
    payload = buf[_ENV_HDR.size : _ENV_HDR.size + plen]
    (crc,) = struct.unpack_from("<I", buf, _ENV_HDR.size + plen)
    if zlib.crc32(payload) != crc:
        raise IOError("envelope checksum mismatch")
    return payload


# ---------------------------------------------------------------------------
# header


def build_header(schema: Schema, options: dict) -> bytes:
    payload = json.dumps(
        {"version": VERSION, "schema": json.loads(schema.to_json()), "options": options},
        separators=(",", ":"),
    ).encode()
    return wrap_envelope(ENV_HEADER, payload)


def parse_header(buf: bytes) -> Tuple[Schema, dict]:
    d = json.loads(unwrap_envelope(buf, ENV_HEADER))
    schema = Schema.from_json(json.dumps(d["schema"]))
    options = d.get("options", {})
    encodings = options.get("encodings")
    if encodings is not None:
        # restore the writer's EFFECTIVE per-column encodings over the
        # derived defaults, so ALL readers — engine and legacy
        # page-at-a-time alike — decode exactly what was written
        schema.columns = [
            c if c.encoding == e else dc_replace(c, encoding=e)
            for c, e in zip(schema.columns, encodings)
        ]
    elif options.get("precondition") is False:
        # older header without the encodings list: the writer stored
        # every column verbatim
        schema.columns = [
            dc_replace(c, encoding=ENC_NONE) for c in schema.columns
        ]
    return schema, options


# ---------------------------------------------------------------------------
# cluster metadata (in-memory while writing; page list envelope on close)


@dataclass
class ClusterMeta:
    """Metadata of one committed cluster (absolute page offsets)."""

    first_entry: int
    n_entries: int
    n_elements: List[int]            # per column
    pages: List[PageDesc]
    byte_offset: int = 0             # cluster blob start (buffered mode)
    byte_size: int = 0


def build_pagelist(clusters: List[ClusterMeta], n_columns: int) -> bytes:
    chunks: List[bytes] = [struct.pack("<IQ", len(clusters), n_columns)]
    for cm in clusters:
        chunks.append(
            struct.pack(
                "<QQQQI", cm.first_entry, cm.n_entries, cm.byte_offset,
                cm.byte_size, len(cm.pages),
            )
        )
        chunks.append(np.asarray(cm.n_elements, dtype="<u8").tobytes())
        chunks.append(_pack_page_recs(cm.pages))
    return wrap_envelope(ENV_PAGELIST, b"".join(chunks))


def parse_pagelist(buf: bytes) -> List[ClusterMeta]:
    payload = unwrap_envelope(buf, ENV_PAGELIST)
    pos = 0
    n_clusters, n_columns = struct.unpack_from("<IQ", payload, pos)
    pos += 12
    out: List[ClusterMeta] = []
    for _ in range(n_clusters):
        first_entry, n_entries, boff, bsize, n_pages = struct.unpack_from(
            "<QQQQI", payload, pos
        )
        pos += 36
        n_elements = np.frombuffer(payload, dtype="<u8", count=n_columns, offset=pos)
        pos += 8 * n_columns
        rec = np.frombuffer(payload, dtype=_PAGE_REC, count=n_pages, offset=pos)
        pos += _PAGE_REC.itemsize * n_pages
        pages = [
            PageDesc(
                column=int(r["column"]),
                n_elements=int(r["n_elements"]),
                offset=int(r["offset"]),
                size=int(r["size"]),
                uncompressed_size=int(r["uncompressed_size"]),
                checksum=int(r["checksum"]),
                codec=int(r["codec"]),
            )
            for r in rec
        ]
        out.append(
            ClusterMeta(first_entry, n_entries, [int(x) for x in n_elements],
                        pages, boff, bsize)
        )
    return out


# ---------------------------------------------------------------------------
# recovery envelope + commit journal (v2, DESIGN.md §8)
#
# With ``WriteOptions.journal`` (default on), every buffered cluster extent is
# written as
#
#     [32-byte cluster envelope][cluster payload][journal record]
#
# in ONE vectored engine write, and every unbuffered cluster commit appends a
# journal record alone.  The envelope makes the payload self-describing
# (magic, commit sequence, length, CRC of its descriptor); the journal record
# is a self-contained copy of the cluster's page-list entry.  Together they
# let :mod:`repro_torch.core.recover` rebuild the footer of a torn file from the
# data region alone.  Footer-based readers never look at either — cluster
# byte offsets in the page list point at the payload, so the framing is
# invisible padding to them (v1 readers read v2 data regions unchanged; only
# the anchor version gates compatibility).

CLUSTER_ENV_MAGIC = b"RJCE"
JOURNAL_MAGIC = b"RJJR"

# magic, version, flags, seq, payload_len, desc_crc, env_crc, pad
_CLUSTER_ENV = struct.Struct("<4sHHIQII4x")
CLUSTER_ENV_SIZE = _CLUSTER_ENV.size  # 32 bytes

JREC_BUFFERED = 1  # flags bit: page offsets are cluster-relative

_JREC_HDR = struct.Struct("<4sI")  # magic, payload_len (crc32 trails payload)
# seq, version, flags, cluster_off, cluster_size, first_entry, n_entries,
# n_columns, n_pages
_JREC_FIX = struct.Struct("<IHHQQQQII")
# v3 (multi-writer): the v2 fields followed by writer_id, epoch
_JREC_FIX3 = struct.Struct("<IHHQQQQIIII")


def journal_record_size(n_columns: int, n_pages: int, multi: bool = False) -> int:
    """On-disk size of one journal record — known before it is built, so
    the writer can reserve the whole framed extent in one call."""
    fix = _JREC_FIX3.size if multi else _JREC_FIX.size
    return (_JREC_HDR.size + fix + 8 * n_columns
            + _PAGE_REC.itemsize * n_pages + 4)


def build_cluster_envelope(seq: int, payload_len: int, desc_crc: int) -> bytes:
    body = _CLUSTER_ENV.pack(CLUSTER_ENV_MAGIC, VERSION, 0, seq, payload_len,
                             desc_crc, 0)
    env_crc = zlib.crc32(body[:24])
    return _CLUSTER_ENV.pack(CLUSTER_ENV_MAGIC, VERSION, 0, seq, payload_len,
                             desc_crc, env_crc)


def parse_cluster_envelope(buf: bytes, pos: int = 0) -> dict:
    magic, ver, flags, seq, plen, desc_crc, env_crc = _CLUSTER_ENV.unpack_from(
        buf, pos)
    if magic != CLUSTER_ENV_MAGIC:
        raise IOError("bad cluster envelope magic")
    if zlib.crc32(bytes(buf[pos:pos + 24])) != env_crc:
        raise IOError("cluster envelope checksum mismatch")
    return {"version": ver, "flags": flags, "seq": seq, "payload_len": plen,
            "desc_crc": desc_crc}


def _pack_page_recs(pages: List[PageDesc]) -> bytes:
    rec = np.zeros(len(pages), dtype=_PAGE_REC)
    for i, p in enumerate(pages):
        rec[i] = (p.column, p.codec, b"", p.n_elements, p.offset, p.size,
                  p.uncompressed_size, p.checksum, b"")
    return rec.tobytes()


def build_journal_body(n_elements: List[int], pages: List[PageDesc]) -> bytes:
    """Variable part of a journal record (per-column element counts + page
    records).  Page offsets are stored exactly as given — cluster-relative
    for buffered commits, absolute for unbuffered ones — so the body can be
    serialized *outside* the writer's critical section, before the extent
    offset is known."""
    return (np.asarray(n_elements, dtype="<u8").tobytes()
            + _pack_page_recs(pages))


def finish_journal_record(
    seq: int,
    flags: int,
    cluster_off: int,
    cluster_size: int,
    first_entry: int,
    n_entries: int,
    n_columns: int,
    body: bytes,
    writer_id: Optional[int] = None,
    epoch: Optional[int] = None,
) -> Tuple[bytes, int]:
    """Complete a journal record around a prebuilt body.  Returns the record
    bytes and the payload CRC (= the envelope's ``desc_crc``).

    Passing ``writer_id``/``epoch`` emits a v3 (multi-writer) record that
    carries the committing writer's fencing identity; recovery uses it to
    attribute clusters to writers and drop records from fenced epochs."""
    n_pages = (len(body) - 8 * n_columns) // _PAGE_REC.itemsize
    if writer_id is not None:
        fix = _JREC_FIX3.pack(seq, JREC_VERSION_MP, flags, cluster_off,
                              cluster_size, first_entry, n_entries, n_columns,
                              n_pages, writer_id, epoch or 0)
    else:
        fix = _JREC_FIX.pack(seq, VERSION, flags, cluster_off, cluster_size,
                             first_entry, n_entries, n_columns, n_pages)
    crc = zlib.crc32(body, zlib.crc32(fix))
    rec = b"".join((
        _JREC_HDR.pack(JOURNAL_MAGIC, len(fix) + len(body)),
        fix, body, struct.pack("<I", crc),
    ))
    return rec, crc


@dataclass
class JournalRecord:
    """One parsed commit-journal record (page offsets resolved to absolute)."""

    seq: int
    flags: int
    cluster_off: int
    cluster_size: int
    first_entry: int
    n_entries: int
    n_elements: List[int]
    pages: List[PageDesc]
    crc: int
    end: int = 0          # file offset just past this record (scan bookkeeping)
    writer_id: int = 0    # v3 only; 0 for single-writer records
    epoch: int = 0        # v3 only; fencing epoch the commit ran under

    @property
    def buffered(self) -> bool:
        return bool(self.flags & JREC_BUFFERED)


def parse_journal_record(buf, pos: int = 0) -> Tuple[JournalRecord, int]:
    """Parse one journal record at ``pos``; raises ``IOError`` on any
    corruption (bad magic, truncation, CRC mismatch).  Returns the record
    and the position just past it."""
    if len(buf) - pos < _JREC_HDR.size:
        raise IOError("truncated journal record")
    magic, plen = _JREC_HDR.unpack_from(buf, pos)
    if magic != JOURNAL_MAGIC:
        raise IOError("bad journal record magic")
    end = pos + _JREC_HDR.size + plen + 4
    if plen < _JREC_FIX.size or end > len(buf):
        raise IOError("truncated journal record")
    payload = bytes(buf[pos + _JREC_HDR.size : pos + _JREC_HDR.size + plen])
    (crc,) = struct.unpack_from("<I", buf, pos + _JREC_HDR.size + plen)
    if zlib.crc32(payload) != crc:
        raise IOError("journal record checksum mismatch")
    (seq, ver, flags, c_off, c_size, first_entry, n_entries, n_cols,
     n_pages) = _JREC_FIX.unpack_from(payload, 0)
    if ver not in SUPPORTED_VERSIONS:
        raise IOError(f"unsupported journal record version {ver}")
    writer_id = epoch = 0
    if ver >= JREC_VERSION_MP:
        if len(payload) < _JREC_FIX3.size:
            raise IOError("truncated journal record")
        (seq, ver, flags, c_off, c_size, first_entry, n_entries, n_cols,
         n_pages, writer_id, epoch) = _JREC_FIX3.unpack_from(payload, 0)
        body_pos = _JREC_FIX3.size
    else:
        body_pos = _JREC_FIX.size
    if len(payload) != body_pos + 8 * n_cols + _PAGE_REC.itemsize * n_pages:
        raise IOError("journal record length mismatch")
    n_elements = np.frombuffer(payload, dtype="<u8", count=n_cols,
                               offset=body_pos)
    rec = np.frombuffer(payload, dtype=_PAGE_REC, count=n_pages,
                        offset=body_pos + 8 * n_cols)
    base = c_off if (flags & JREC_BUFFERED) else 0
    pages = [
        PageDesc(
            column=int(r["column"]),
            n_elements=int(r["n_elements"]),
            offset=int(r["offset"]) + base,
            size=int(r["size"]),
            uncompressed_size=int(r["uncompressed_size"]),
            checksum=int(r["checksum"]),
            codec=int(r["codec"]),
        )
        for r in rec
    ]
    jr = JournalRecord(seq, flags, c_off, c_size, first_entry, n_entries,
                       [int(x) for x in n_elements], pages, crc, end,
                       writer_id, epoch)
    return jr, end


# ---------------------------------------------------------------------------
# framed-member side-car (optional)


def build_member_sidecar(clusters: List[ClusterMeta]) -> Optional[bytes]:
    """Optional side-car recording chunk-framed pages' member layout.

    For every page compressed as multiple independent members (DESIGN.md
    §5.2) it records the compressed byte size of each member plus the
    uncompressed bytes a full member decodes to — which is exactly what
    the read engine needs to decompress one page's members as parallel
    pool jobs instead of looping a decompressor serially.  Returns
    ``None`` when no page is framed (the envelope is then omitted and the
    footer carries no locator: old files and unframed files are
    indistinguishable and decode exactly as before).
    """
    recs: List[bytes] = []
    n = 0
    for ci, cm in enumerate(clusters):
        for pi, p in enumerate(cm.pages):
            if p.members and len(p.members) > 1:
                recs.append(struct.pack("<IIII", ci, pi, p.member_chunk,
                                        len(p.members)))
                recs.append(np.asarray(p.members, dtype="<u4").tobytes())
                n += 1
    if not n:
        return None
    payload = struct.pack("<I", n) + b"".join(recs)
    return wrap_envelope(ENV_MEMBERS, payload)


def parse_member_sidecar(buf: bytes, clusters: List[ClusterMeta]) -> None:
    """Attach the side-car's member layouts to the parsed page descriptors."""
    payload = unwrap_envelope(buf, ENV_MEMBERS)
    (n,) = struct.unpack_from("<I", payload, 0)
    pos = 4
    for _ in range(n):
        ci, pi, chunk, k = struct.unpack_from("<IIII", payload, pos)
        pos += 16
        sizes = np.frombuffer(payload, dtype="<u4", count=k, offset=pos)
        pos += 4 * k
        page = clusters[ci].pages[pi]
        page.members = [int(s) for s in sizes]
        page.member_chunk = int(chunk)


# ---------------------------------------------------------------------------
# zone maps (footer.extra["zonemaps"], DESIGN.md §11)
#
# Per cluster, per column: parallel per-page lists in page-list order —
# first/last entry index (cluster-relative, so raw cluster copies stay
# valid across merge/rebase) plus, for leaf columns, min/max over non-NaN
# elements and the NaN count.  Stored as plain JSON inside the footer:
# readers that predate the key (including the vendored seed reader)
# ignore unknown ``extra`` entries, and Python's json round-trips the
# NaN/±Infinity bounds of float pages.


def encode_zonemaps(per_cluster) -> Optional[dict]:
    """``footer.extra["zonemaps"]`` value from per-cluster zone-map dicts
    (``None`` per cluster = no stats, e.g. a raw-copied cluster from an
    old file).  Returns ``None`` when no cluster carries stats."""
    if not any(per_cluster):
        return None
    clusters = []
    for zm in per_cluster:
        if not zm:
            clusters.append(None)
        else:
            clusters.append({str(ci): d for ci, d in zm.items()})
    return {"v": 1, "clusters": clusters}


def decode_zonemaps(value, n_clusters: int):
    """Parse ``footer.extra["zonemaps"]`` back to per-cluster dicts keyed
    by column index.  Defensive: an unknown version, a cluster-count
    mismatch, or inconsistent per-column page lists degrade to "no
    stats" (``None``) — pruning is an optimization, never a correctness
    dependency."""
    if not isinstance(value, dict) or value.get("v") != 1:
        return None
    clusters = value.get("clusters")
    if not isinstance(clusters, list) or len(clusters) != n_clusters:
        return None
    out = []
    for zm in clusters:
        if not isinstance(zm, dict):
            out.append(None)
            continue
        cols = {}
        for key, d in zm.items():
            try:
                ci = int(key)
            except (TypeError, ValueError):
                continue
            if not isinstance(d, dict) or "fe" not in d or "le" not in d:
                continue
            n = len(d["fe"])
            if len(d["le"]) != n:
                continue
            if "lo" in d and not (
                len(d.get("lo", ())) == len(d.get("hi", ()))
                == len(d.get("nn", ())) == n
            ):
                continue
            cols[ci] = d
        out.append(cols or None)
    return out


# ---------------------------------------------------------------------------
# footer + anchor


def build_footer(
    n_entries: int,
    n_clusters: int,
    pagelist_loc: Tuple[int, int],
    extra: Optional[dict] = None,
) -> bytes:
    payload = json.dumps(
        {
            "n_entries": n_entries,
            "n_clusters": n_clusters,
            "pagelist": list(pagelist_loc),
            "extra": extra or {},
        },
        separators=(",", ":"),
    ).encode()
    return wrap_envelope(ENV_FOOTER, payload)


def parse_footer(buf: bytes) -> dict:
    return json.loads(unwrap_envelope(buf, ENV_FOOTER))


def build_anchor(
    header_loc: Tuple[int, int],
    footer_loc: Tuple[int, int],
    n_entries: int,
    n_clusters: int,
) -> bytes:
    body = _ANCHOR.pack(
        MAGIC, VERSION, header_loc[0], header_loc[1], footer_loc[0],
        footer_loc[1], n_entries, n_clusters, 0,
    )
    crc = zlib.crc32(body[:-8])
    return _ANCHOR.pack(
        MAGIC, VERSION, header_loc[0], header_loc[1], footer_loc[0],
        footer_loc[1], n_entries, n_clusters, crc,
    )


def parse_anchor(buf: bytes) -> dict:
    magic, ver, hoff, hsize, foff, fsize, n_entries, n_clusters, crc = _ANCHOR.unpack(buf)
    if magic != MAGIC:
        raise IOError("not an RNT-J file (bad anchor magic)")
    if ver not in SUPPORTED_VERSIONS:
        raise IOError(f"unsupported RNT-J version {ver}")
    body = _ANCHOR.pack(magic, ver, hoff, hsize, foff, fsize, n_entries, n_clusters, 0)
    if zlib.crc32(body[:-8]) != crc:
        raise IOError("anchor checksum mismatch")
    return {
        "header": (hoff, hsize),
        "footer": (foff, fsize),
        "n_entries": n_entries,
        "n_clusters": n_clusters,
    }
