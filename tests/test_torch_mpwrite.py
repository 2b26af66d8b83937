"""The port's crash-consistent multi-process writing (DESIGN.md §8.6), on
the CPU.

The cases of ``tests/test_mpwrite.py`` run on ``repro_torch.core``, every
participant and writer with ``device="cpu"``: the side-car reservation log
(leases, fencing epochs, torn-tail replay), the footer-assembly
rendezvous (clean seal, degraded seal, straggler fencing), recovery of
multi-writer files, and real worker subprocesses (``python -c``: a
process that has used a card may only ``spawn`` its children).  Then the
two packages share files: a participant of either joins the other's
container, their multi-writer files hold the same entry sets, and both
recover a dropped coordinator's file to the same bytes.
"""

import os
import shutil
import struct
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from repro_torch.core import (
    Collection,
    FencedError,
    Leaf,
    MemorySink,
    MultiWriterCoordinator,
    RNTJReader,
    RetryPolicy,
    Schema,
    SequentialWriter,
    StaleLogError,
    WriteOptions,
    join_container,
    recover_container,
    scan_container,
    open_sink,
)
from repro_torch.core.extents import (
    ExtentLog,
    XREC_SEAL,
    iter_records,
    replay_log,
)
from repro_torch.core.metadata import (
    JREC_VERSION_MP,
    finish_journal_record,
    journal_record_size,
    parse_journal_record,
    build_journal_body,
)

REPO = Path(__file__).resolve().parent.parent

SCHEMA = Schema([
    Leaf("id", "int64"),
    Collection("vals", Leaf("_0", "float32")),
])

FAST = RetryPolicy(max_attempts=6, backoff_base=0.0001, backoff_cap=0.0005)


def mp_options(**kw):
    base = dict(cluster_bytes=2048, retry_policy=FAST, lease_interval=0.3,
                rendezvous_timeout=5.0, mpw_log_fsync=False)
    base.update(kw)
    return WriteOptions(**base)


def make_entries(n, seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 6, size=n)
    return [
        {"id": int(i),
         "vals": [float(v) for v in rng.random(lens[i], dtype=np.float32)]}
        for i in range(n)
    ]


def read_all(source):
    r = RNTJReader(source, device="cpu")
    got = list(r.iter_entries())
    r.close()
    return got


# ---------------------------------------------------------------------------
# side-car reservation log


def test_xlog_join_reserve_commit(tmp_path):
    c = str(tmp_path / "f.rntj")
    log = ExtentLog.create(c, data_start=100, fsync=False)
    s1 = log.join(1.0)
    s2 = log.join(1.0)
    assert (s1.writer_id, s2.writer_id) == (1, 2)
    assert s2.epoch > s1.epoch  # epochs are globally monotonic

    r1 = s1.reserve(50)
    r2 = s2.reserve(30)
    assert r1.offset == 100 and r2.offset == 150  # disjoint, frontier-ordered
    assert (r1.seq, r2.seq) == (0, 1)
    s1.commit(r1.rid)
    st = log.snapshot()
    assert st.reservations[r1.rid].committed
    assert not st.reservations[r2.rid].committed
    s2.release(r2.rid)
    st = log.snapshot()
    assert st.reservations[r2.rid].released
    # released extents are permanent holes: the frontier never rolls back
    r3 = s1.reserve(10)
    assert r3.offset == 180
    log.close()


def test_xlog_fencing_is_terminal(tmp_path):
    c = str(tmp_path / "f.rntj")
    log = ExtentLog.create(c, data_start=64, fsync=False)
    s = log.join(1.0)
    r = s.reserve(10)
    log.fence(s.writer_id, "test")
    with pytest.raises(FencedError):
        s.reserve(10)
    with pytest.raises(FencedError):
        s.commit(r.rid)
    with pytest.raises(FencedError):
        s.heartbeat()
    with pytest.raises(FencedError):
        s.done()
    log.close()


def test_xlog_done_is_terminal(tmp_path):
    c = str(tmp_path / "f.rntj")
    log = ExtentLog.create(c, data_start=64, fsync=False)
    s = log.join(1.0)
    s.done()
    # a post-DONE reservation would race the coordinator's seal
    with pytest.raises(FencedError):
        s.reserve(10)
    log.close()


def test_xlog_seal_refuses_everything(tmp_path):
    c = str(tmp_path / "f.rntj")
    log = ExtentLog.create(c, data_start=64, fsync=False)
    s = log.join(1.0)
    log.seal({"by": "test"})
    with pytest.raises(FencedError):
        s.reserve(10)
    with pytest.raises(FencedError):
        log.join(1.0)
    st = log.snapshot()
    assert st.sealed and st.seal_info["by"] == "test"
    log.close()


def test_xlog_torn_tail_replay(tmp_path):
    c = str(tmp_path / "f.rntj")
    log = ExtentLog.create(c, data_start=64, fsync=False)
    s = log.join(1.0)
    s.reserve(10)
    log.close()
    raw = Path(ExtentLog.sidecar_path(c)).read_bytes()
    # a crash mid-append tears the last record: every truncation of the
    # final record must replay to the pre-append state
    whole = replay_log(raw)
    assert len(whole.reservations) == 1
    records = list(iter_records(raw))
    assert len(records) == 3  # CREATE, JOIN, RESERVE
    for cut in range(1, 40):
        torn = replay_log(raw[:-cut])
        assert len(torn.reservations) <= 1
        assert torn.data_start == 64  # the intact prefix survives verbatim
    # corrupt tail CRC: record dropped, prefix intact
    bad = bytearray(raw)
    bad[-1] ^= 0xFF
    assert len(replay_log(bytes(bad)).reservations) == 0


def test_xlog_lease_expiry(tmp_path):
    c = str(tmp_path / "f.rntj")
    log = ExtentLog.create(c, data_start=64, fsync=False)
    s = log.join(0.05)
    time.sleep(0.15)
    st = log.snapshot()
    # lease deadlines are wall-clock: they cross process boundaries
    assert st.writers[s.writer_id].expired(time.time())
    s.heartbeat()  # not fenced yet: the lease can still be renewed
    st = log.snapshot()
    assert not st.writers[s.writer_id].expired(time.time())
    log.close()


def test_xlog_append_after_torn_tail_truncates(tmp_path):
    c = str(tmp_path / "f.rntj")
    log = ExtentLog.create(c, data_start=64, fsync=False)
    s = log.join(1.0)
    s.reserve(10)
    log.close()
    p = Path(ExtentLog.sidecar_path(c))
    raw = bytearray(p.read_bytes())
    raw[-1] ^= 0xFF  # tear the RESERVE record (crash mid-append)
    p.write_bytes(bytes(raw))

    # the next transaction must truncate the torn tail and append at the
    # valid end — a record appended past the tear would be invisible to
    # every replay, freezing next_offset and handing out overlaps
    log = ExtentLog(str(p), fsync=False)
    r = log.reserve(s.writer_id, s.epoch, 20)
    assert r.offset == 64  # the torn RESERVE never happened
    st = replay_log(p.read_bytes())
    assert len(st.reservations) == 1
    assert st.next_offset == 84
    r2 = log.reserve(s.writer_id, s.epoch, 5)
    assert r2.offset == 84  # frontier advanced: no overlapping extents
    log.close()


def test_xlog_create_refuses_leftover_log(tmp_path):
    c = str(tmp_path / "f.rntj")
    log = ExtentLog.create(c, data_start=64, fsync=False)
    log.join(1.0)
    log.close()
    with pytest.raises(StaleLogError):
        ExtentLog.create(c, data_start=64, fsync=False)


def test_xlog_join_checks_generation(tmp_path):
    c = str(tmp_path / "f.rntj")
    log = ExtentLog.create(c, data_start=64, fsync=False, generation="genA")
    log.join(1.0, expect_generation="genA")
    with pytest.raises(StaleLogError):
        log.join(1.0, expect_generation="genB")
    log.close()


# ---------------------------------------------------------------------------
# v3 journal records


def test_v3_journal_record_roundtrip():
    body = build_journal_body([3], [])
    size = journal_record_size(1, 0, multi=True)
    rec, _crc = finish_journal_record(
        7, 1, 4096, 512, 0, 3, 1, body, writer_id=9, epoch=4)
    assert len(rec) == size
    assert size > journal_record_size(1, 0, multi=False)
    jr, _pos = parse_journal_record(rec)
    assert (jr.seq, jr.writer_id, jr.epoch) == (7, 9, 4)
    assert jr.cluster_off == 4096 and jr.n_entries == 3


def test_v2_journal_record_still_parses():
    body = build_journal_body([2], [])
    rec, _ = finish_journal_record(1, 1, 64, 32, 0, 2, 1, body)
    jr, _pos = parse_journal_record(rec)
    assert (jr.writer_id, jr.epoch) == (0, 0)
    assert jr.seq == 1 and jr.n_entries == 2


# ---------------------------------------------------------------------------
# coordinator + participants (in-process)


def test_multiwriter_clean_seal(tmp_path):
    path = str(tmp_path / "mp.rntj")
    entries = make_entries(150)
    opts = mp_options()
    coord = MultiWriterCoordinator(SCHEMA, path, opts)

    def writer(slice_):
        w = coord.participant(device="cpu")
        ctx = w.create_fill_context()
        for e in slice_:
            ctx.fill(e)
        ctx.close()
        w.close()

    threads = [threading.Thread(target=writer, args=(entries[i::3],))
               for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    report = coord.seal(expect_writers=3)
    coord.close()

    assert report["writers"] == 3 and not report["fenced"]
    assert report["entries"] == 150
    assert not os.path.exists(ExtentLog.sidecar_path(path)), (
        "clean seal must unlink the side-car log")
    got = read_all(path)
    assert sorted(e["id"] for e in got) == list(range(150))
    by_id = {e["id"]: e for e in entries}
    assert all(e == by_id[e["id"]] for e in got)
    # the sealed footer is a *valid* footer: recovery has nothing to do
    rep = recover_container(path, dry_run=True)
    assert rep.footer_valid


def test_multiwriter_entry_renumbering(tmp_path):
    # interleaved commits from two writers: reader order must follow the
    # global reservation seq with contiguous first_entry ranges
    path = str(tmp_path / "mp.rntj")
    opts = mp_options(cluster_bytes=512)
    coord = MultiWriterCoordinator(SCHEMA, path, opts)
    w1, w2 = coord.participant(device="cpu"), coord.participant(device="cpu")
    c1, c2 = w1.create_fill_context(), w2.create_fill_context()
    entries = make_entries(60)
    for i, e in enumerate(entries):
        (c1 if i % 2 else c2).fill(e)
        if i % 10 == 9:  # force alternating small clusters
            c1.flush_cluster()
            c2.flush_cluster()
    c1.close(); c2.close()
    w1.close(); w2.close()
    report = coord.seal(expect_writers=2)
    coord.close()
    assert report["entries"] == 60
    got = read_all(path)
    assert len(got) == 60
    assert sorted(e["id"] for e in got) == list(range(60))


def test_multiwriter_degraded_seal_salvages_commits(tmp_path):
    path = str(tmp_path / "mp.rntj")
    entries = make_entries(120)
    opts = mp_options(cluster_bytes=1024)
    coord = MultiWriterCoordinator(SCHEMA, path, opts)

    good = coord.participant(device="cpu")
    gctx = good.create_fill_context()
    for e in entries[:60]:
        gctx.fill(e)
    gctx.close()
    good.close()

    # the dying writer commits some clusters, then leaves a dangling
    # reservation and stops heartbeating (= SIGKILL mid-save)
    dead = coord.participant(device="cpu")
    dctx = dead.create_fill_context()
    for e in entries[60:100]:
        dctx.fill(e)
    dctx.flush_cluster()
    dangling = dead._mp_session.reserve(512)  # reserved, never written
    dead._hb_stop.set()
    dead._hb.join()

    report = coord.seal(expect_writers=2)
    # the fenced writer can no longer touch the log
    with pytest.raises(FencedError):
        dead._mp_session.reserve(16)
    coord.close()
    assert report["fenced"] == [dead.writer_id]
    assert any(s["writer"] == dead.writer_id for s in report["salvaged"])
    assert any(a["offset"] == dangling.offset for a in report["abandoned"])
    assert os.path.exists(ExtentLog.sidecar_path(path)), (
        "degraded seal keeps the side-car for forensics")

    got = read_all(path)
    ids = [e["id"] for e in got]
    assert set(range(60)) <= set(ids), "clean writer lost entries"
    assert set(ids) <= set(range(100))
    by_id = {e["id"]: e for e in entries}
    assert all(e == by_id[e["id"]] for e in got)

    # salvage is decode-identical to a single-writer file of the same set
    ref = MemorySink()
    w = SequentialWriter(SCHEMA, ref, mp_options(cluster_bytes=1024), device="cpu")
    for e in got:
        w.fill(e)
    w.close()
    assert read_all(ref) == got


def test_fenced_straggler_cannot_corrupt_sealed_file(tmp_path):
    path = str(tmp_path / "mp.rntj")
    entries = make_entries(80)
    opts = mp_options(rendezvous_timeout=0.5)
    coord = MultiWriterCoordinator(SCHEMA, path, opts)
    w = coord.participant(device="cpu")
    ctx = w.create_fill_context()
    for e in entries[:40]:
        ctx.fill(e)
    ctx.flush_cluster()
    # writer stays alive (heartbeating) but never reports DONE: the
    # rendezvous deadline fences it
    report = coord.seal(expect_writers=1, timeout=0.5)
    assert report["fenced"] == [w.writer_id]
    sealed = read_all(path)

    # late commits from the fenced epoch must be refused...
    with pytest.raises((FencedError, RuntimeError, OSError)):
        for e in entries[40:]:
            ctx.fill(e)
        ctx.flush_cluster()
    # ...and whatever bytes it managed to pwrite can only have landed in
    # its own abandoned extents — the sealed content is untouched
    assert read_all(path) == sealed
    rep = recover_container(path, dry_run=True)
    assert rep.footer_valid
    coord.close()
    w._hb_stop.set()


def test_new_session_replaces_stale_sidecar_log(tmp_path):
    # run 1 ends DEGRADED, which keeps the (sealed) side-car log on disk.
    # run 2 at the same path must not adopt it: a sealed stale log would
    # fence every new join, and its reservations point into a file that
    # the new coordinator just truncated.
    path = str(tmp_path / "mp.rntj")
    entries = make_entries(40)
    opts = mp_options(cluster_bytes=1024)
    coord = MultiWriterCoordinator(SCHEMA, path, opts)
    w = coord.participant(device="cpu")
    ctx = w.create_fill_context()
    for e in entries[:20]:
        ctx.fill(e)
    ctx.flush_cluster()
    w._hb_stop.set()
    w._hb.join()
    report = coord.seal(expect_writers=1)  # lease expiry → degraded
    coord.close()
    assert report["fenced"] == [w.writer_id]
    assert os.path.exists(ExtentLog.sidecar_path(path))

    coord = MultiWriterCoordinator(SCHEMA, path, opts)
    w2 = coord.participant(device="cpu")
    ctx2 = w2.create_fill_context()
    for e in entries:
        ctx2.fill(e)
    ctx2.close()
    w2.close()
    report = coord.seal(expect_writers=1)
    coord.close()
    assert not report["fenced"] and not report["salvaged"]
    assert report["entries"] == 40
    got = read_all(path)
    assert sorted(e["id"] for e in got) == list(range(40))


def test_join_refuses_foreign_generation_log(tmp_path):
    path = str(tmp_path / "mp.rntj")
    coord = MultiWriterCoordinator(SCHEMA, path, mp_options())
    # swap in a log created for a DIFFERENT container instance
    os.unlink(ExtentLog.sidecar_path(path))
    foreign = ExtentLog.create(path, 64, fsync=False,
                               generation="someone-else")
    foreign.close()
    with pytest.raises(StaleLogError):
        join_container(path, schema=SCHEMA, options=mp_options(), device="cpu")
    coord.sink.close()
    coord.log.close()


class _SlowFsyncSink:
    """Delegating sink whose data fsync stalls — models a close whose
    final drain/fsync of large buffered clusters outlasts the fencing
    grace (~2x lease_interval)."""

    def __init__(self, inner, delay):
        self.inner = inner
        self.delay = delay

    def fsync(self):
        time.sleep(self.delay)
        self.inner.fsync()

    def __getattr__(self, name):
        return getattr(self.inner, name)


def test_slow_close_is_not_fenced(tmp_path):
    # the lease heartbeat must keep running through close's drain + data
    # fsync: a healthy writer whose final fsync exceeds the fencing grace
    # would otherwise be fenced mid-close and spuriously degrade the seal
    path = str(tmp_path / "mp.rntj")
    entries = make_entries(40)
    opts = mp_options(lease_interval=0.2)
    coord = MultiWriterCoordinator(SCHEMA, path, opts)
    inner = open_sink(path, create=False)
    w = join_container(path, schema=SCHEMA, options=opts,
                       sink=_SlowFsyncSink(inner, delay=1.2), device="cpu")
    ctx = w.create_fill_context()
    for e in entries:
        ctx.fill(e)

    def closer():
        ctx.close()
        w.close()

    t = threading.Thread(target=closer)
    t.start()
    report = coord.seal(expect_writers=1, timeout=30.0)
    coord.close()
    t.join()
    assert not report["fenced"] and not report["salvaged"], (
        "healthy writer fenced during its close-time fsync")
    assert report["entries"] == 40
    got = read_all(path)
    assert sorted(e["id"] for e in got) == list(range(40))


# ---------------------------------------------------------------------------
# recovery of multi-writer files


def _write_unsealed(path, entries, n_writers=2, **opt_kw):
    """Build a multi-writer file whose coordinator died before the seal."""
    opts = mp_options(**opt_kw)
    coord = MultiWriterCoordinator(SCHEMA, path, opts)
    writers = [coord.participant(device="cpu") for _ in range(n_writers)]
    ctxs = [w.create_fill_context() for w in writers]
    for i, e in enumerate(entries):
        ctxs[i % n_writers].fill(e)
    for c in ctxs:
        c.close()
    for w in writers:
        w.close()
    # coordinator crash: no seal record, no footer
    coord.sink.close()
    coord.log.close()


def test_recover_unsealed_multiwriter(tmp_path):
    path = str(tmp_path / "mp.rntj")
    entries = make_entries(100)
    _write_unsealed(path, entries, n_writers=2, cluster_bytes=1024)
    rep = recover_container(path)
    assert rep.rebuilt and not rep.footer_valid
    assert rep.multiwriter is not None
    assert len(rep.multiwriter["writers"]) == 2
    got = read_all(path)
    assert sorted(e["id"] for e in got) == list(range(100))
    by_id = {e["id"]: e for e in entries}
    assert all(e == by_id[e["id"]] for e in got)


def test_recover_mid_rendezvous_crash(tmp_path):
    # the coordinator appended SEAL but died before any footer byte:
    # the file has no footer, the log says sealed — recovery still
    # rebuilds from the journal records + reservations
    path = str(tmp_path / "mp.rntj")
    entries = make_entries(80)
    opts = mp_options(cluster_bytes=1024)
    coord = MultiWriterCoordinator(SCHEMA, path, opts)
    w = coord.participant(device="cpu")
    ctx = w.create_fill_context()
    for e in entries:
        ctx.fill(e)
    ctx.close()
    w.close()
    coord.log.seal({"coordinator_pid": os.getpid()})  # SEAL, then "crash"
    coord.sink.close()
    coord.log.close()

    rep = recover_container(path)
    assert rep.rebuilt
    assert rep.multiwriter is not None and rep.multiwriter["sealed"]
    got = read_all(path)
    assert sorted(e["id"] for e in got) == list(range(80))


def test_recover_drops_unreserved_and_stale_epoch_extents(tmp_path):
    path = str(tmp_path / "mp.rntj")
    entries = make_entries(60)
    _write_unsealed(path, entries, n_writers=2, cluster_bytes=1024)
    sink = open_sink(path, create=False)
    log = ExtentLog(ExtentLog.sidecar_path(path), fsync=False)
    state = log.snapshot()
    log.close()

    # sanity: with the true log state every cluster is attributed
    _sch, _opts, clusters, rep = scan_container(sink, xlog_state=state)
    full = rep.clusters_salvaged
    assert full >= 2 and not rep.clusters_dropped

    # forge a stale epoch on one reservation: its (pristine, CRC-valid)
    # cluster must now be rejected as a fenced writer's late write
    rid = min(state.reservations)
    state.reservations[rid].epoch += 1
    _sch, _opts, clusters, rep = scan_container(sink, xlog_state=state)
    assert rep.clusters_salvaged == full - 1
    assert any("fenced epoch" in d["reason"] for d in rep.clusters_dropped)

    # drop the reservation entirely: same rejection, different reason
    del state.reservations[rid]
    _sch, _opts, clusters, rep = scan_container(sink, xlog_state=state)
    assert rep.clusters_salvaged == full - 1
    assert any("no reservation" in d["reason"] for d in rep.clusters_dropped)
    sink.close()


def test_recover_ignores_stale_foreign_log(tmp_path):
    # a single-writer file written at a path where a crashed multi-writer
    # run left its side-car log behind: fencing enforcement from that log
    # would drop every valid cluster ("no reservation"), so recovery must
    # detect the generation mismatch and fall back to a plain scan
    path = str(tmp_path / "f.rntj")
    entries = make_entries(30)
    w = SequentialWriter(SCHEMA, open_sink(path, create=True),
                         mp_options(cluster_bytes=1024), device="cpu")
    for e in entries:
        w.fill(e)
    w.close()
    stale = ExtentLog.create(path, 64, fsync=False, generation="dead-run")
    stale.close()

    rep = recover_container(path, force=True)
    assert rep.multiwriter == {"stale_log_ignored": True}
    assert rep.clusters_salvaged >= 1 and not rep.clusters_dropped
    got = read_all(path)
    assert sorted(e["id"] for e in got) == list(range(30))


def test_recover_orphaned_reservations_reported(tmp_path):
    path = str(tmp_path / "mp.rntj")
    entries = make_entries(40)
    opts = mp_options(cluster_bytes=1024)
    coord = MultiWriterCoordinator(SCHEMA, path, opts)
    w = coord.participant(device="cpu")
    ctx = w.create_fill_context()
    for e in entries:
        ctx.fill(e)
    ctx.close()
    w._mp_session.reserve(999)  # orphan: reserved, never committed
    w._hb_stop.set()
    w._hb.join()
    coord.sink.close()
    coord.log.close()

    rep = recover_container(path)
    assert len(rep.multiwriter["orphaned_reservations"]) >= 1
    got = read_all(path)
    assert sorted(e["id"] for e in got) == list(range(40))


# ---------------------------------------------------------------------------
# real multi-process crash cells


_WORKER_PROG = textwrap.dedent("""\
    import os, sys
    sys.path.insert(0, {src!r})
    from repro_torch.core import (Collection, Leaf, RetryPolicy, Schema,
                                  WriteOptions, join_container)
    SCHEMA = Schema([Leaf("id", "int64"),
                     Collection("vals", Leaf("_0", "float32"))])
    opts = WriteOptions(cluster_bytes=1024, lease_interval=0.3,
                        mpw_log_fsync=False,
                        retry_policy=RetryPolicy(max_attempts=6,
                                                 backoff_base=0.0001,
                                                 backoff_cap=0.0005))
    lo, hi, crash_at = {lo}, {hi}, {crash_at}
    w = join_container({path!r}, schema=SCHEMA, options=opts, device="cpu")
    ctx = w.create_fill_context()
    for i in range(lo, hi):
        ctx.fill({{"id": i, "vals": [float(i), float(i) * 0.5]}})
        if crash_at is not None and i == crash_at:
            ctx.flush_cluster()
            os._exit(9)   # SIGKILL-equivalent: no DONE, no close
    ctx.close()
    w.close()
""")


def _spawn_worker(path, lo, hi, crash_at=None):
    prog = _WORKER_PROG.format(src=str(REPO / "src"), path=path,
                               lo=lo, hi=hi, crash_at=crash_at)
    return subprocess.Popen([sys.executable, "-c", prog],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


@pytest.mark.parametrize("n_writers", [2, 4])
def test_real_processes_clean_seal(tmp_path, n_writers):
    path = str(tmp_path / "mp.rntj")
    per = 60
    coord = MultiWriterCoordinator(SCHEMA, path, mp_options())
    procs = [_spawn_worker(path, w * per, (w + 1) * per)
             for w in range(n_writers)]
    report = coord.seal(expect_writers=n_writers, timeout=30.0)
    coord.close()
    for p in procs:
        _out, err = p.communicate(timeout=30)
        assert p.returncode == 0, err.decode()
    assert report["entries"] == n_writers * per and not report["fenced"]
    got = read_all(path)
    assert sorted(e["id"] for e in got) == list(range(n_writers * per))


def test_real_process_killed_mid_save_is_salvaged(tmp_path):
    path = str(tmp_path / "mp.rntj")
    coord = MultiWriterCoordinator(SCHEMA, path, mp_options())
    ok = _spawn_worker(path, 0, 60)
    bad = _spawn_worker(path, 60, 120, crash_at=90)  # dies halfway
    report = coord.seal(expect_writers=2, timeout=30.0)
    coord.close()
    ok.communicate(timeout=30)
    bad.communicate(timeout=30)
    assert ok.returncode == 0 and bad.returncode == 9

    assert len(report["fenced"]) == 1
    got = read_all(path)
    ids = [e["id"] for e in got]
    assert set(range(60)) <= set(ids), "live writer lost entries"
    dead_ids = sorted(i for i in ids if i >= 60)
    # the dead writer's salvage is a prefix of its commit order
    assert dead_ids == list(range(60, 60 + len(dead_ids)))
    assert all(e["vals"] == [float(e["id"]), e["id"] * 0.5] for e in got)
    # byte-level: decode-identical to a single-writer file of the same set
    ref = MemorySink()
    w = SequentialWriter(SCHEMA, ref, mp_options(cluster_bytes=1024), device="cpu")
    for e in got:
        w.fill(e)
    w.close()
    assert read_all(ref) == got


# ---------------------------------------------------------------------------
# both packages on one container


def _pkg_schema(pkg):
    return pkg.Schema([pkg.Leaf("id", "int64"),
                       pkg.Collection("vals", pkg.Leaf("_0", "float32"))])


def _pkg_options(pkg, **kw):
    # a lease long enough for a participant's first fill to import the
    # reference's kernel modules without being fenced
    base = dict(cluster_bytes=1024, lease_interval=5.0,
                rendezvous_timeout=30.0, mpw_log_fsync=False,
                retry_policy=pkg.RetryPolicy(max_attempts=6,
                                             backoff_base=0.0001,
                                             backoff_cap=0.0005))
    base.update(kw)
    return pkg.WriteOptions(**base)


def _join(pkg, path):
    kw = {"device": "cpu"} if pkg is T else {}
    return pkg.join_container(path, options=_pkg_options(pkg), **kw)


def _fill(w, lo, hi):
    ctx = w.create_fill_context()
    for i in range(lo, hi):
        ctx.fill({"id": i, "vals": [float(i), float(i) * 0.5]})
    ctx.close()
    w.close()


def _entries(pkg, path):
    kw = {"device": "cpu"} if pkg is T else {}
    with pkg.RNTJReader(path, **kw) as r:
        return sorted((e["id"], tuple(e["vals"])) for e in r.iter_entries())


_REF_WORKER_PROG = _WORKER_PROG.replace("repro_torch.core", "repro.core").replace(
    ', device="cpu"', "")


@pytest.mark.parametrize("owner", ["repro", "repro_torch"])
def test_each_package_joins_the_others_container(tmp_path, owner):
    """A coordinator of either package; one worker process of each package
    joins its container (separate processes, as the extent log's
    ``fcntl`` locks require)."""
    coord_pkg = R if owner == "repro" else T
    path = str(tmp_path / "shared.rntj")
    coord = coord_pkg.MultiWriterCoordinator(_pkg_schema(coord_pkg), path,
                                             _pkg_options(coord_pkg))
    procs = []
    for prog, lo, hi in ((_REF_WORKER_PROG, 0, 150), (_WORKER_PROG, 150, 300)):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", prog.format(
                src=str(REPO / "src"), path=path, lo=lo, hi=hi,
                crash_at=None)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    report = coord.seal(expect_writers=2, timeout=60.0)
    coord.close()
    for p in procs:
        _out, err = p.communicate(timeout=60)
        assert p.returncode == 0, err.decode()
    assert report["writers"] == 2 and report["entries"] == 300
    assert not (report["fenced"] or report["salvaged"] or report["abandoned"])
    assert not os.path.exists(path + ".mpwlog")
    want = [(i, (float(i), i * 0.5)) for i in range(300)]
    assert _entries(R, path) == want
    assert _entries(T, path) == want


@pytest.mark.parametrize("n_writers", [1, 3])
def test_multi_writer_files_hold_the_reference_entry_sets(tmp_path, n_writers):
    got = {}
    for pkg in (R, T):
        path = str(tmp_path / f"{pkg.__name__}.rntj")
        coord = pkg.MultiWriterCoordinator(_pkg_schema(pkg), path,
                                           _pkg_options(pkg))
        kw = {"device": "cpu"} if pkg is T else {}
        writers = [coord.participant(**kw) for _ in range(n_writers)]
        ts = [threading.Thread(target=_fill, args=(w, k * 100, (k + 1) * 100))
              for k, w in enumerate(writers)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        coord.seal()
        coord.close()
        got[pkg] = _entries(pkg, path)
        # the other package reads it too
        assert _entries(R if pkg is T else T, path) == got[pkg]
    assert got[R] == got[T]
    assert [i for i, _v in got[T]] == list(range(n_writers * 100))


def test_recovery_of_a_dropped_coordinator_is_byte_identical(tmp_path):
    """A coordinator dropped before ``seal`` leaves a torn shared file and
    its side-car log; each package recovers a copy of the same bytes, and
    the outputs are byte-identical."""
    path = str(tmp_path / "mp.rntj")
    coord = T.MultiWriterCoordinator(_pkg_schema(T), path, _pkg_options(T))
    # one participant of each package, one after the other: in one
    # process the two packages' logs do not share the in-process lock
    _fill(_join(T, path), 0, 80)
    _fill(_join(R, path), 80, 200)
    coord.sink.close()  # dropped before seal: no footer
    coord.log.close()
    outs = []
    for pkg in (R, T):
        d = tmp_path / pkg.__name__
        d.mkdir()
        p = str(d / "mp.rntj")
        shutil.copyfile(path, p)
        shutil.copyfile(path + ".mpwlog", p + ".mpwlog")
        rep = pkg.recover_container(p)
        assert rep.clusters_salvaged >= 2 and not rep.clusters_dropped
        outs.append(open(p, "rb").read())
    assert outs[0] == outs[1]
    p = str(tmp_path / T.__name__ / "mp.rntj")
    assert [i for i, _v in _entries(R, p)] == list(range(200))
    assert _entries(T, p) == _entries(R, p)


def test_join_refuses_without_a_card(tmp_path, monkeypatch):
    import torch

    path = str(tmp_path / "mp.rntj")
    coord = T.MultiWriterCoordinator(_pkg_schema(T), path, _pkg_options(T))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.join_container(path, options=_pkg_options(T))
    with pytest.raises(RuntimeError):
        coord.participant()
    # neither refusal registered a writer: the seal waits for nobody
    assert coord.seal(timeout=1.0)["writers"] == 0
    coord.close()
