"""Multi-process parallel writing into ONE RNT-J container (DESIGN.md §8.6).

The paper removes the single-thread writer bottleneck; this module removes
the single-process one.  The commit protocol is unchanged — seal without
synchronization, reserve an extent in a short critical section, positioned
``pwritev`` — but the critical section's shared state (the allocation
frontier + commit sequence) moves out of the writer lock into the
crash-consistent side-car reservation log (:mod:`repro_torch.core.extents`).

Roles:

* :class:`MultiWriterCoordinator` — creates the container + header + log,
  and owns finalization: the **footer-assembly rendezvous** at
  :meth:`~MultiWriterCoordinator.seal` waits for every joined writer's
  DONE with a straggler timeout, fences the dead and the late, then seals
  a valid footer over every fully-journaled cluster — from live and dead
  writers alike — recording salvaged/abandoned extents in ``footer.extra``.
* :class:`ParticipantWriter` — a :class:`~repro_torch.core.writer.ParallelWriter`
  whose extents come from the shared log: it writes no header, stamps each
  journal record with its ``(writer_id, epoch)``, keeps its lease alive
  from a heartbeat thread, and at close fsyncs its clusters and reports
  DONE instead of writing a footer.  Join from another process with
  :func:`join_container`.

Device (``device=``, default ``"cuda"``): a participant is a
:class:`~repro_torch.core.writer.ParallelWriter` of its own process, so its
offsets scan at fill time and its byte-plane split at seal time run as
CUDA kernels on that process's card, or as their plain PyTorch versions on
``device="cpu"``.  Without a card and without ``device="cpu"`` a join
raises ``RuntimeError`` before it registers with the log.  Processes that
share a card must be started with ``spawn``: a forked child cannot
re-initialise CUDA.

Crash-safety recap (the invariants live in :mod:`repro_torch.core.extents`):
abandoned extents are holes that are never reused, so a fenced writer's
late ``pwrite`` can only land inside its own abandoned extent — never
inside a committed cluster or the footer; the SEAL record is appended
*before* the first footer byte exists, so no reservation can overlap the
footer region.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from typing import Optional, Tuple

from repro_torch.kernels.ops import resolve_device

from .container import Sink, open_sink
from .extents import (
    ExtentLog,
    FencedError,
    LogState,
    Reservation,
    StaleLogError,
    WriterSession,
)
from .metadata import (
    ANCHOR_SIZE,
    CLUSTER_ENV_SIZE,
    ClusterMeta,
    _ENV_HDR,
    build_anchor,
    build_footer,
    build_header,
    build_pagelist,
    parse_cluster_envelope,
    parse_header,
    parse_journal_record,
)
from .recover import _read_exact, _verify_cluster_pages
from .schema import Schema
from .writer import ParallelWriter, WriteOptions

_POLL_S = 0.02  # rendezvous poll period


class SharedExtentSink:
    """Sink wrapper routing extent reservation through the shared log.

    Every ``reserve`` appends a RESERVE record (raising
    :class:`FencedError` once this writer is fenced) and remembers the
    :class:`Reservation` so the commit path can read the global seq and
    append the matching COMMIT.  Everything else delegates to the wrapped
    sink — positioned writes need no coordination at all.
    """

    def __init__(self, inner: Sink, session: WriterSession):
        self.inner = inner
        self.session = session
        self.pending = {}           # offset -> Reservation (COMMIT not yet sent)
        self.last: Optional[Reservation] = None

    def reserve(self, size: int) -> int:
        r = self.session.reserve(size)
        self.pending[r.offset] = r
        self.last = r
        return r.offset

    def take(self, offset: int) -> Optional[Reservation]:
        return self.pending.pop(offset, None)

    @property
    def io(self):
        return self.inner.io

    @property
    def size(self) -> int:
        return self.inner.size

    @property
    def native_ring(self) -> bool:
        return getattr(self.inner, "native_ring", False)

    @property
    def fd(self):  # pragma: no cover - only consulted by the native ring
        return getattr(self.inner, "fd", -1)

    def pwrite(self, offset: int, data) -> None:
        self.inner.pwrite(offset, data)

    def pwritev(self, offset: int, parts) -> None:
        self.inner.pwritev(offset, parts)

    def pread(self, offset: int, size: int) -> bytes:
        return self.inner.pread(offset, size)

    def pread_into(self, offset: int, buf) -> int:
        return self.inner.pread_into(offset, buf)

    def fallocate(self, offset: int, size: int) -> None:
        self.inner.fallocate(offset, size)

    def fsync(self) -> None:
        self.inner.fsync()

    def close(self) -> None:
        self.inner.close()

    def readable(self) -> bool:
        return self.inner.readable()


class ParticipantWriter(ParallelWriter):
    """A parallel writer whose extents come from the shared reservation log.

    Identical fill/seal/commit machinery to :class:`ParallelWriter`; the
    differences are exactly the multi-writer protocol: no header, v3
    journal records stamped ``(writer_id, epoch)``, a lease heartbeat
    thread, COMMIT after every extent write, and a close that makes this
    writer's clusters durable and reports DONE instead of finalizing.
    """

    _writes_header = False

    def __init__(self, schema: Schema, sink, session: WriterSession,
                 options: Optional[WriteOptions] = None,
                 owns_log: bool = False, device="cuda"):
        options = options or WriteOptions()
        if not options.buffered or not options.journal:
            raise ValueError(
                "multi-process writing requires buffered=True and "
                "journal=True (the journal records ARE the shared file's "
                "recoverable metadata)")
        self._mp_session = session
        self._owns_log = owns_log
        self._jrec_writer_id = session.writer_id
        self._jrec_epoch = session.epoch
        inner = (open_sink(sink, create=False)
                 if isinstance(sink, (str, os.PathLike)) else sink)
        super().__init__(schema, SharedExtentSink(inner, session), options,
                         device=device)
        self._hb_stop = threading.Event()
        self._hb = threading.Thread(
            target=self._heartbeat_loop, daemon=True,
            name=f"rntj-lease-w{session.writer_id}")
        self._hb.start()

    @property
    def writer_id(self) -> int:
        return self._mp_session.writer_id

    @property
    def epoch(self) -> int:
        return self._mp_session.epoch

    def _heartbeat_loop(self) -> None:
        # renew at half the lease period so one missed beat is survivable
        period = max(0.01, self._mp_session.lease_interval / 2)
        while not self._hb_stop.wait(period):
            try:
                self._mp_session.heartbeat()
            except FencedError as e:
                # a beat racing the shutdown may observe this writer's own
                # terminal DONE — that is a clean close, not a fencing
                if not self._hb_stop.is_set():
                    self._poison(e)
                return
            except OSError:
                pass  # transient side-car hiccup: the next beat retries

    def _commit_seq(self) -> int:
        # caller holds the writer lock, right after sink.reserve: `last`
        # is this commit's reservation and its seq is the global one
        return self.sink.last.seq

    def _post_commit(self, ext: int) -> None:
        r = self.sink.take(ext)
        if r is not None:
            try:
                self._mp_session.commit(r.rid)
            except FencedError as e:
                self._poison(e)
                raise

    def _stop_heartbeat(self) -> None:
        self._hb_stop.set()
        if self._hb.is_alive():
            self._hb.join(timeout=10)

    def _finalize(self) -> None:
        # the participant's half of the rendezvous: data durable FIRST,
        # DONE second — the coordinator may seal the moment every writer
        # is done, so DONE must never precede the bytes it vouches for.
        # The heartbeat keeps running through the drain + fsync above and
        # here: a close whose final fsync of large buffered clusters
        # outlasts the fencing grace (~2x lease_interval) must stay
        # leased, or the coordinator fences a healthy writer mid-close
        # and spuriously degrades the seal.
        self._io.fsync()
        self._stop_heartbeat()
        if self._commit_error is None:
            self._mp_session.done()

    def close(self) -> None:
        try:
            super().close()
        finally:
            # poisoned closes skip _finalize: make sure the beat dies
            self._stop_heartbeat()
            if self._owns_log:
                self._mp_session.log.close()


def join_container(path, schema: Optional[Schema] = None,
                   options: Optional[WriteOptions] = None,
                   sink: Optional[Sink] = None,
                   device="cuda") -> ParticipantWriter:
    """Join an open multi-writer container from any process.

    Reads the schema from the container header when not given; ``sink``
    lets tests interpose a fault-injection wrapper over the data file.
    The header is always read for the container's generation id, so a
    stale side-car log left next to the path by a previous run raises
    :class:`~repro_torch.core.extents.StaleLogError` instead of joining it.
    ``device`` is the participant's (see the module docstring); it is
    resolved first, so a join refused for want of a card registers nothing.
    """
    resolve_device(device)
    path = os.fspath(path)
    options = options or WriteOptions()
    inner = sink if sink is not None else open_sink(path, create=False)
    hdr16 = inner.pread(0, _ENV_HDR.size)
    _m, _t, plen = _ENV_HDR.unpack(hdr16)
    hdr_schema, hdr_opts = parse_header(
        inner.pread(0, _ENV_HDR.size + plen + 4))
    if schema is None:
        schema = hdr_schema
    log = ExtentLog(ExtentLog.sidecar_path(path), fsync=options.mpw_log_fsync)
    try:
        session = log.join(options.lease_interval,
                           expect_generation=hdr_opts.get("mpw_gen"))
    except BaseException:
        log.close()
        raise
    return ParticipantWriter(schema, inner, session, options, owns_log=True,
                             device=device)


class MultiWriterCoordinator:
    """Owns one shared container: header first, footer rendezvous last.

    Usage::

        coord = MultiWriterCoordinator(schema, path, options)
        # spawn N processes, each: join_container(path).fill(...).close()
        # (or in-process: coord.participant())
        report = coord.seal(expect_writers=N)
        coord.close()
    """

    def __init__(self, schema: Schema, path, options: Optional[WriteOptions] = None):
        self.schema = schema
        self.path = os.fspath(path)
        self.options = options or WriteOptions()
        if not self.options.buffered or not self.options.journal:
            raise ValueError(
                "multi-process writing requires buffered=True and journal=True")
        # the generation id binds header, side-car log, and every join to
        # THIS file instance: a stale log (or a stale writer) from a prior
        # run at the same path can never be mistaken for ours
        self.generation = uuid.uuid4().hex
        self.sink = open_sink(self.path, create=True)
        hdr = self._header_bytes()
        self.sink.pwrite(self.sink.reserve(len(hdr)), hdr)
        self.sink.fsync()  # participants + recovery read it right away
        self._header_loc = (0, len(hdr))
        # a leftover side-car from a crashed or degraded-sealed previous
        # run (only a CLEAN seal unlinks it) must not be adopted: if
        # sealed it would fence every join, and its reservations point
        # into the file we just truncated
        try:
            os.unlink(ExtentLog.sidecar_path(self.path))
        except FileNotFoundError:
            pass
        self.log = ExtentLog.create(self.path, len(hdr),
                                    fsync=self.options.mpw_log_fsync,
                                    generation=self.generation)
        self._sealed = False
        self.report: Optional[dict] = None

    def _header_bytes(self) -> bytes:
        hdr_opts = self.options.as_dict()
        hdr_opts["mpw_gen"] = self.generation
        if self.options.precondition:
            hdr_opts["encodings"] = [c.encoding for c in self.schema.columns]
        else:
            hdr_opts["encodings"] = ["none"] * self.schema.n_columns
        return build_header(self.schema, hdr_opts)

    def participant(self, options: Optional[WriteOptions] = None,
                    device="cuda") -> ParticipantWriter:
        """An in-process participant (shares this coordinator's log fd)."""
        resolve_device(device)
        opts = options or self.options
        session = self.log.join(opts.lease_interval,
                                expect_generation=self.generation)
        return ParticipantWriter(self.schema, open_sink(self.path, create=False),
                                 session, opts, device=device)

    # -- the footer-assembly rendezvous -----------------------------------

    def seal(self, expect_writers: Optional[int] = None,
             timeout: Optional[float] = None) -> dict:
        """Wait for every joined writer's DONE, fence stragglers at the
        timeout, then seal a footer over every fully-journaled cluster.

        ``expect_writers`` additionally waits (within the same timeout)
        for that many writers to have joined — use it when the workers
        are spawned but may not have registered yet.  Degrades
        gracefully: a dead or fenced writer's committed clusters are
        verified page-by-page and salvaged; torn extents become permanent
        holes recorded in ``footer.extra["mpw"]["abandoned"]``.
        """
        if self._sealed:
            return self.report
        timeout = (self.options.rendezvous_timeout if timeout is None
                   else timeout)
        deadline = time.monotonic() + timeout
        while True:
            st = self.log.snapshot()
            # lease deadlines are wall-clock (written by other processes);
            # the rendezvous timeout is local, so monotonic is fine for it
            now_wall = time.time()
            for w in st.writers.values():
                # 2x lease-interval grace: one missed heartbeat survives,
                # a silent writer is fenced without waiting for the full
                # rendezvous timeout
                if (not w.done and not w.fenced
                        and now_wall > w.lease_deadline + w.lease_interval):
                    self.log.fence(w.writer_id, "lease expired")
                    w.fenced = True
            undone = [w for w in st.writers.values()
                      if not w.done and not w.fenced]
            waiting_join = (expect_writers is not None
                            and len(st.writers) < expect_writers)
            if not undone and not waiting_join:
                break
            if time.monotonic() >= deadline:
                for w in undone:
                    self.log.fence(w.writer_id, "rendezvous timeout")
                break
            time.sleep(_POLL_S)
        # freeze allocation BEFORE any footer byte exists: after SEAL no
        # reservation can be appended, so nothing can overlap the footer
        self.log.seal({"coordinator_pid": os.getpid()})
        st = self.log.snapshot()
        metas, n_entries, mpw = self._assemble(st)
        self._write_footer(st, metas, n_entries, mpw)
        self._sealed = True
        self.report = mpw
        clean = not (mpw["fenced"] or mpw["salvaged"] or mpw["abandoned"])
        if clean:
            self.log.unlink()  # the sealed file is fully self-contained
        return mpw

    def _assemble(self, st: LogState):
        """Build the cluster list from the log + targeted extent reads.

        A reservation from a writer that finished cleanly (DONE, not
        fenced) is trusted on its framing (envelope + journal record CRCs
        — the writer fsynced before DONE); anything else gets full
        page-CRC verification, because the writer may have died mid-write.
        """
        keyed = []
        salvaged, abandoned = [], []
        for rid in sorted(st.reservations):
            r = st.reservations[rid]
            w = st.writers.get(r.writer_id)
            clean = w is not None and w.done and not w.fenced
            info = {"writer": r.writer_id, "epoch": r.epoch,
                    "offset": r.offset, "size": r.size}
            if r.released:
                abandoned.append(dict(info, reason="released"))
                continue
            cm, reason = self._load_cluster(st, r, verify_pages=not clean)
            if cm is None:
                abandoned.append(dict(info, reason=reason))
            elif clean and r.committed:
                keyed.append((r.seq, cm))
            else:
                # journaled bytes from a dead/fenced writer (or a COMMIT
                # record the crash swallowed): verified above, salvaged
                keyed.append((r.seq, cm))
                salvaged.append(dict(info, entries=cm.n_entries))
        keyed.sort(key=lambda kv: kv[0])
        metas, n = [], 0
        for _seq, cm in keyed:
            cm.first_entry = n
            n += cm.n_entries
            metas.append(cm)
        mpw = {
            "writers": len(st.writers),
            "done": sorted(w.writer_id for w in st.writers.values() if w.done),
            "fenced": sorted(w.writer_id for w in st.writers.values() if w.fenced),
            "clusters": len(metas),
            "entries": n,
            "salvaged": salvaged,
            "abandoned": abandoned,
        }
        return metas, n, mpw

    def _load_cluster(self, st: LogState, r: Reservation,
                      verify_pages: bool) -> Tuple[Optional[ClusterMeta], str]:
        """Read + validate one reserved extent; None + reason on failure."""
        sink = self.sink
        env_buf = _read_exact(sink, r.offset, CLUSTER_ENV_SIZE)
        if env_buf is None:
            return None, "extent unreadable"
        try:
            env = parse_cluster_envelope(env_buf)
        except IOError:
            return None, "cluster envelope torn"
        jr_off = r.offset + CLUSTER_ENV_SIZE + env["payload_len"]
        if env["seq"] != r.seq or jr_off >= r.offset + r.size:
            return None, "envelope/reservation disagree"
        jbuf = _read_exact(sink, jr_off, r.offset + r.size - jr_off)
        if jbuf is None:
            return None, "journal record unreadable"
        try:
            jr, _end = parse_journal_record(jbuf, 0)
        except IOError:
            return None, "journal record torn"
        if (jr.seq != r.seq or jr.crc != env["desc_crc"]
                or jr.cluster_off != r.offset + CLUSTER_ENV_SIZE
                or jr.cluster_size != env["payload_len"]):
            return None, "envelope/journal disagree"
        if jr.writer_id != r.writer_id or jr.epoch != r.epoch:
            # a stale-epoch writer wrote into space it does not own under
            # its current identity: fencing says this data is dead
            return None, "journal record from a fenced epoch"
        reason = _verify_cluster_pages(sink, jr, st.next_offset, verify_pages)
        if reason is not None:
            return None, reason
        return ClusterMeta(
            first_entry=0,  # renumbered by the caller
            n_entries=jr.n_entries,
            n_elements=list(jr.n_elements),
            pages=list(jr.pages),
            byte_offset=jr.cluster_off,
            byte_size=jr.cluster_size,
        ), ""

    def _write_footer(self, st: LogState, metas, n_entries: int,
                      mpw: dict) -> None:
        sink = self.sink
        # finalization begins exactly at the sealed allocation frontier;
        # abandoned extents before it stay as holes (never reused)
        sink._end = max(sink.size, st.next_offset)
        pl = build_pagelist(metas, self.schema.n_columns)
        pl_off = sink.reserve(len(pl))
        sink.pwrite(pl_off, pl)
        ftr = build_footer(n_entries, len(metas), (pl_off, len(pl)),
                           extra={"mpw": mpw})
        f_off = sink.reserve(len(ftr))
        sink.pwrite(f_off, ftr)
        anchor = build_anchor(self._header_loc, (f_off, len(ftr)),
                              n_entries, len(metas))
        sink.pwrite(sink.reserve(ANCHOR_SIZE), anchor)
        sink.fsync()

    def close(self) -> None:
        if not self._sealed:
            self.seal()
        self.sink.close()
        self.log.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        else:  # do not mask the in-flight error with a rendezvous
            self.sink.close()
            self.log.close()
