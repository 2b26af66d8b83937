"""The page codec engine: registry, framed chunk-parallel compression,
and adaptive per-column codec policy.

ROOT supports DEFLATE, LZMA, LZ4 and Zstandard (paper §3).  This container
has the Python stdlib only, so DEFLATE (zlib), LZMA and BZ2 are always
registered plus an explicit ``none`` fast path; codec ids 4 (lz4) and
5 (zstd) are **auto-registered when the ``lz4`` / ``zstandard`` packages
are importable** and otherwise stay reserved with a clear error naming
the missing package — files written elsewhere with those codecs keep
stable ids either way.

Three properties make compressed configurations scale like uncompressed
ones (the point of the codec engine, see DESIGN.md §5):

* every registered codec releases the GIL while (de)compressing, which is
  what lets the paper's thread-parallel compression model work in Python:
  serialization+compression of a unit of writing runs with no
  synchronization (paper §4.1);
* **framed chunking**: a page whose preconditioned payload exceeds
  ``chunk_bytes`` is compressed as independent, concatenated *members*
  (complete codec streams).  Members compress concurrently on a worker
  pool — a single producer sealing one big page saturates the pool — and
  the decoder transparently loops a decompressor over the members, so the
  on-disk codec id does not change and per-page checksums fold over the
  member payloads incrementally (``crc32(b, crc32(a)) == crc32(a+b)``);
* an adaptive :class:`CodecPolicy` samples each column's first sealed
  pages and falls back to raw storage (``CODEC_NONE``, as ROOT does) when
  the achieved ratio is not worth the CPU.
"""

from __future__ import annotations

import bz2
import lzma
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

CODEC_NONE = 0
CODEC_ZLIB = 1
CODEC_LZMA = 2
CODEC_BZ2 = 3
CODEC_LZ4 = 4   # registered when the ``lz4`` package is importable
CODEC_ZSTD = 5  # registered when the ``zstandard`` package is importable

_NAMES: Dict[str, int] = {
    "none": CODEC_NONE,
    "zlib": CODEC_ZLIB,
    "deflate": CODEC_ZLIB,
    "lzma": CODEC_LZMA,
    "bz2": CODEC_BZ2,
    "lz4": CODEC_LZ4,
    "zstd": CODEC_ZSTD,
    "zstandard": CODEC_ZSTD,
}


@dataclass(frozen=True)
class Codec:
    """One registered entropy coder.

    ``compress`` emits a complete, self-terminating stream (a *member*);
    ``decompressor`` returns a fresh stdlib-style decompressor object with
    ``.decompress(buf)`` and ``.unused_data`` — the engine loops it over
    concatenated members, so chunk-framed pages need no extra metadata.
    """

    id: int
    name: str
    default_level: int
    compress: Callable[[bytes, int], bytes]
    decompressor: Callable[[], object]


def _zlib_compress(data, level: int) -> bytes:
    # compressobj produces the identical byte stream but manages the
    # output buffer more cheaply than zlib.compress (~10% on 64 KiB
    # pages); this path runs once per page member, so it matters
    c = zlib.compressobj(level)
    return c.compress(data) + c.flush()


_REGISTRY: Dict[int, Codec] = {}

# package that would provide each reserved codec id (for error messages)
_RESERVED_PACKAGES = {CODEC_LZ4: "lz4", CODEC_ZSTD: "zstandard"}


def register_codec(codec: Codec) -> None:
    _REGISTRY[codec.id] = codec
    _NAMES.setdefault(codec.name, codec.id)


register_codec(Codec(CODEC_ZLIB, "zlib", 1, _zlib_compress,
                     zlib.decompressobj))
register_codec(Codec(CODEC_LZMA, "lzma", 0,
                     lambda d, lvl: lzma.compress(d, preset=lvl),
                     lzma.LZMADecompressor))
register_codec(Codec(CODEC_BZ2, "bz2", 1,
                     lambda d, lvl: bz2.compress(d, max(1, lvl)),
                     bz2.BZ2Decompressor))


def _register_optional() -> None:
    """Detect importable lz4/zstandard and claim the reserved ids."""
    try:  # pragma: no cover - depends on installed packages
        import lz4.frame as _lz4f

        register_codec(Codec(
            CODEC_LZ4, "lz4", 0,
            lambda d, lvl: _lz4f.compress(bytes(d), compression_level=lvl),
            _lz4f.LZ4FrameDecompressor,
        ))
    except ImportError:
        pass
    try:  # pragma: no cover - depends on installed packages
        import io as _io

        import zstandard as _zstd

        class _ZstdMembers:
            """stdlib-decompressor facade over concatenated zstd frames."""

            unused_data = b""

            def decompress(self, buf):
                reader = _zstd.ZstdDecompressor().stream_reader(
                    _io.BytesIO(bytes(buf)), read_across_frames=True
                )
                return reader.read()

        register_codec(Codec(
            CODEC_ZSTD, "zstd", 3,
            lambda d, lvl: _zstd.ZstdCompressor(level=lvl).compress(bytes(d)),
            _ZstdMembers,
        ))
    except ImportError:
        pass


_register_optional()

# kept as a public alias: levels used when callers pass level < 0
DEFAULT_LEVEL = {cid: c.default_level for cid, c in _REGISTRY.items()}


def codec_id(name_or_id) -> int:
    if isinstance(name_or_id, int):
        return name_or_id
    try:
        return _NAMES[name_or_id.lower()]
    except KeyError:
        raise ValueError(f"unknown codec {name_or_id!r}") from None


def codec_name(cid: int) -> str:
    if cid == CODEC_NONE:
        return "none"
    c = _REGISTRY.get(cid)
    if c is not None:
        return c.name
    return _RESERVED_PACKAGES.get(cid, str(cid))


def is_available(cid: int) -> bool:
    return cid == CODEC_NONE or cid in _REGISTRY


def require(cid: int) -> Codec:
    """Availability check FIRST: unavailable ids raise ``ValueError``
    before any level lookup (reserved ids name the missing package)."""
    c = _REGISTRY.get(cid)
    if c is None:
        pkg = _RESERVED_PACKAGES.get(cid)
        if pkg is not None:
            raise ValueError(
                f"codec {cid} ({codec_name(cid)}) not available in this "
                f"build: requires the {pkg!r} package"
            )
        raise ValueError(f"codec {cid} not available in this build")
    return c


def make_pool(workers: int, prefix: str = "rntj-codec") -> Optional[ThreadPoolExecutor]:
    """Shared worker-pool plumbing for page codec work.

    One pool per writer (compression) or reader (decompression), sized
    independently of the producer/consumer count.  Because the codecs
    above release the GIL, page (de)compression submitted to the pool
    runs truly in parallel.  Returns ``None`` when ``workers`` is 0 so
    callers can keep a synchronous fast path.
    """
    if not workers:
        return None
    return ThreadPoolExecutor(max_workers=workers, thread_name_prefix=prefix)


# ---------------------------------------------------------------------------
# framed chunking


def chunk_ranges(n: int, chunk_bytes: int) -> List[Tuple[int, int]]:
    """Byte ranges of a payload's independent members.

    One member when chunking is disabled (``chunk_bytes <= 0``) or the
    payload fits in one chunk, else ``ceil(n / chunk_bytes)`` members.
    """
    if chunk_bytes <= 0 or n <= chunk_bytes:
        return [(0, n)]
    return [(i, min(i + chunk_bytes, n)) for i in range(0, n, chunk_bytes)]


def compress_parts(
    data, codec: int, level: int = -1, chunk_bytes: int = 0, pool=None
) -> List[bytes]:
    """Compress ``data`` into one or more independent members.

    Members are complete streams of the codec: concatenated, they form a
    payload :func:`decompress` (and any stdlib decompressor loop) accepts
    under the same codec id.  With ``pool`` the members compress
    concurrently — the chunk-parallel path a single producer uses to
    saturate the writer's pool on one large page.
    """
    c = require(codec)
    if level < 0:
        level = c.default_level
    mv = memoryview(data)
    ranges = chunk_ranges(len(mv), chunk_bytes)
    if len(ranges) == 1:
        return [c.compress(mv, level)]
    if pool is None:
        return [c.compress(mv[a:b], level) for a, b in ranges]
    return list(pool.map(lambda r: c.compress(mv[r[0]:r[1]], level), ranges))


def compress(data, codec: int, level: int = -1, chunk_bytes: int = 0,
             pool=None) -> bytes:
    if codec == CODEC_NONE:
        return data
    parts = compress_parts(data, codec, level, chunk_bytes, pool)
    return parts[0] if len(parts) == 1 else b"".join(parts)


def crc32_parts(parts: Sequence, crc: int = 0) -> int:
    """Fold member CRCs into one page checksum incrementally.

    ``crc32`` is streaming — ``crc32(a + b) == crc32(b, crc32(a))`` — so
    the fold over a chunked page's members equals the whole-payload CRC:
    chunk-framed files stay verifiable by any whole-page reader.
    """
    for p in parts:
        crc = zlib.crc32(p, crc)
    return crc


def decompress(data, codec: int, uncompressed_size: int) -> bytes:
    """Decompress a page payload, looping over concatenated members.

    A non-chunked page is simply a single member, so this is THE decode
    path for every codec id; the member loop adds no work to it.
    """
    if codec == CODEC_NONE:
        return data
    c = require(codec)
    d = c.decompressor()
    out = d.decompress(data)
    rest = d.unused_data
    if rest:
        parts = [out]
        total = len(out)
        while rest and total <= uncompressed_size:
            d = c.decompressor()
            part = d.decompress(rest)
            if not part and not d.unused_data:
                break  # no progress: corrupt trailing member
            parts.append(part)
            total += len(part)
            rest = d.unused_data
        out = b"".join(parts)
    if len(out) != uncompressed_size:
        raise IOError(
            f"decompressed size mismatch: {len(out)} != {uncompressed_size}"
        )
    return out


# ---------------------------------------------------------------------------
# adaptive per-column codec policy


class CodecPolicy:
    """Per-column adaptive codec decisions, shared by every builder of one
    writer (ROOT's "use no compression when it does not pay" heuristic,
    per column instead of per page).

    Each column starts in a *sampling* phase: its first ``sample_pages``
    compressed pages are trialed with the configured codec while the
    achieved in/out byte totals accumulate.  Once the sample is complete
    the column's codec is **locked**: kept if the sampled ratio
    (``out/in``) is at most ``threshold``, dropped to ``CODEC_NONE``
    otherwise.  Decisions are monotonic and thread-safe — concurrent
    producers share one policy, and pages already written under the trial
    codec stay valid because ``PageDesc.codec`` is per page.

    With ``rate_aware=True`` the decision also weighs measured
    **bandwidths**, not ratio alone: the commit path feeds the sink's
    observed drain rate through :meth:`observe_drain`, and a column whose
    ratio misses the threshold is still kept when its *savings rate* —
    bytes removed per second of compression CPU,
    ``(in - out) / compress_time`` — beats what the sink can drain.  A
    throttled disk (drain slower than the savings rate) keeps compression
    that a /dev/null-fast sink would drop, which is exactly the paper's
    storage-bandwidth-is-the-wall regime.  While no drain observation
    exists yet, a would-drop column keeps sampling (up to
    ``4 * sample_pages`` pages) instead of locking a decision the rate
    data could reverse.

    Constructor parameters are tabulated in DESIGN.md §7.3 (the writer
    builds one from the ``adaptive_*`` fields of DESIGN.md §7.1).
    """

    def __init__(self, n_columns: int, sample_pages: int = 8,
                 threshold: float = 0.9, rate_aware: bool = False):
        self.sample_pages = sample_pages
        self.threshold = threshold
        self.rate_aware = rate_aware
        self._lock = threading.Lock()
        self._pages = [0] * n_columns
        self._bytes_in = [0] * n_columns
        self._bytes_out = [0] * n_columns
        self._ns = [0] * n_columns       # compression CPU time of the sample
        self._drain_bytes = 0
        self._drain_ns = 0
        # None = sampling; True = keep the configured codec; False = raw
        self._keep: List[Optional[bool]] = [None] * n_columns

    def effective_codec(self, column: int, codec: int) -> int:
        """The codec to use for this column's next page."""
        if codec == CODEC_NONE or self._keep[column] is None or self._keep[column]:
            return codec
        return CODEC_NONE

    def observe_drain(self, nbytes: int, ns: int) -> None:
        """Account one drained write: the sink's observed bandwidth."""
        if not self.rate_aware:
            return
        with self._lock:
            self._drain_bytes += nbytes
            self._drain_ns += ns

    def _drain_rate(self) -> Optional[float]:
        """Observed sink bandwidth in bytes/s (None before any write)."""
        if not self._drain_ns:
            return None
        return self._drain_bytes / (self._drain_ns / 1e9)

    def record(self, column: int, raw_size: int, payload_size: int,
               ns: int = 0) -> None:
        """Account one compressed trial page; lock the decision once the
        sample is complete."""
        with self._lock:
            if self._keep[column] is not None:
                return
            self._pages[column] += 1
            self._bytes_in[column] += raw_size
            self._bytes_out[column] += payload_size
            self._ns[column] += ns
            if self._pages[column] < self.sample_pages:
                return
            ratio = self._bytes_out[column] / max(1, self._bytes_in[column])
            if ratio <= self.threshold:
                self._keep[column] = True
                return
            if not self.rate_aware:
                self._keep[column] = False
                return
            # ratio alone says drop — but if the sink drains slower than
            # this codec removes bytes, compression still buys wall time
            drain = self._drain_rate()
            if drain is None:
                # no bandwidth signal yet: keep sampling (bounded)
                if self._pages[column] >= 4 * self.sample_pages:
                    self._keep[column] = False
                return
            saved = self._bytes_in[column] - self._bytes_out[column]
            cpu_s = self._ns[column] / 1e9
            savings_rate = saved / cpu_s if cpu_s > 0 else 0.0
            self._keep[column] = savings_rate >= drain

    def decision(self, column: int) -> Optional[bool]:
        """None while sampling, else whether the codec was kept."""
        return self._keep[column]

    def remaining_sample(self, column: int) -> int:
        """Trial pages still wanted before this column's decision locks."""
        with self._lock:
            if self._keep[column] is not None:
                return 0
            return max(0, self.sample_pages - self._pages[column])

    def as_dict(self) -> dict:
        with self._lock:
            drain = self._drain_rate()
            return {
                "sample_pages": self.sample_pages,
                "threshold": self.threshold,
                "rate_aware": self.rate_aware,
                "drain_mb_s": round(drain / 1e6, 2) if drain else None,
                "columns": [
                    {
                        "pages": p,
                        "bytes_in": bi,
                        "bytes_out": bo,
                        "keep": k,
                    }
                    for p, bi, bo, k in zip(
                        self._pages, self._bytes_in, self._bytes_out, self._keep
                    )
                ],
            }
