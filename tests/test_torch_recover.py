"""The port's fault injection, retrying I/O, crash recovery and object-store
sinks (DESIGN.md §8, §10), on the CPU.

The cases of ``tests/test_faults_recovery.py`` (the fault sink, the
engine's retry chokepoint and degradation paths, the envelope/journal
format, recovery and the crash matrix) and of ``tests/test_remote_sink.py``
(the hermetic ``FakeTransport``: byte identity, retries, deadlines,
hedging, interrupted-multipart salvage, degraded mode, reader retries) run
on ``repro_torch.core``, every writer and reader with ``device="cpu"``;
the cases that drive ``tools/*.py`` stay with the reference.  Then the two
packages meet: each recovers the other's torn files to the same bytes,
each tolerant reader opens the other's torn file, and a ``mem-s3://``
object holds the bytes of the same write to a file.
"""

import errno
import os
import random
import shutil
import struct
import subprocess
import sys
import threading
import zlib
from pathlib import Path

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from repro_torch.core import (
    Collection,
    ColumnBatch,
    FaultInjectingSink,
    FaultSchedule,
    FaultSpec,
    Leaf,
    MemorySink,
    ParallelWriter,
    ProcessKilled,
    ReadOptions,
    RecoveryError,
    RNTJReader,
    RetryPolicy,
    Schema,
    SequentialWriter,
    WriteOptions,
    merge_files,
    open_sink,
    recover_container,
    scan_container,
)
from repro_torch.core.faults import crashed_file_bytes, memory_sink_from_bytes
from repro_torch.core.ioengine import IOEngine, _ExtentGroup
from repro_torch.core import metadata as md
from repro_torch.core.pages import PageDesc
from repro_torch.core.remote import (
    FakeTransport,
    ObjectBucket,
    ObjectStoreSink,
    RemoteOptions,
    _add_interval,
    mem_bucket,
    parse_remote_url,
    reset_mem_buckets,
    salvage_remote,
)

REPO_ROOT = Path(__file__).resolve().parent.parent

SCHEMA = Schema([
    Leaf("id", "int64"),
    Collection("vals", Leaf("_0", "float32")),
])

# fast deterministic backoff: tests must not sleep for real
FAST = RetryPolicy(max_attempts=6, backoff_base=0.0001, backoff_cap=0.0005)
FAST_OPTS = RemoteOptions(part_bytes=256, retry_policy=FAST)


def make_entries(n, seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 6, size=n)
    return [
        {"id": int(i),
         "vals": [float(v) for v in rng.random(lens[i], dtype=np.float32)]}
        for i in range(n)
    ]


def write_seq(sink, entries, **kw):
    opts = WriteOptions(cluster_bytes=kw.pop("cluster_bytes", 2048),
                        retry_policy=kw.pop("retry_policy", FAST), **kw)
    w = SequentialWriter(SCHEMA, sink, opts, device="cpu")
    for e in entries:
        w.fill(e)
    w.close()
    return w


def reference_bytes(entries, **kw):
    ms = MemorySink()
    write_seq(ms, entries, **kw)
    data = bytes(ms.buf[: ms.size])
    ms.close()
    return data


def read_all(sink_or_path, options=None):
    r = RNTJReader(sink_or_path, options=options, device="cpu")
    try:
        return list(r.iter_entries())
    finally:
        r.close()


# ---------------------------------------------------------------------------
# FaultInjectingSink units


def test_fault_sink_transparent_without_rules():
    fs = FaultInjectingSink(MemorySink())
    off = fs.reserve(10)
    fs.pwrite(off, b"0123456789")
    assert fs.pread(off, 10) == b"0123456789"
    assert fs.persisted_bytes == 10
    assert fs.faults.injected == 0


def test_fault_sink_at_call_and_count():
    fs = FaultInjectingSink(MemorySink(), [
        FaultSpec.transient_error(at_call=1, count=1),
    ])
    fs.reserve(30)
    fs.pwrite(0, b"aaaaaaaaaa")                     # call 0: fine
    with pytest.raises(OSError):
        fs.pwrite(10, b"bbbbbbbbbb")                # call 1: EIO, no bytes
    assert fs.persisted_bytes == 10
    fs.pwrite(10, b"bbbbbbbbbb")                    # call 2: rule exhausted
    assert fs.pread(0, 20) == b"aaaaaaaaaabbbbbbbbbb"


def test_fault_sink_offset_window():
    fs = FaultInjectingSink(MemorySink(), [
        FaultSpec(op="write", kind="error", count=-1, at_offset=(100, 200)),
    ])
    fs.reserve(300)
    fs.pwrite(0, b"x" * 50)                          # below the window
    with pytest.raises(OSError):
        fs.pwrite(150, b"y")                         # inside
    with pytest.raises(OSError):
        fs.pwrite(90, b"z" * 20)                     # overlaps the boundary
    fs.pwrite(200, b"w")                             # past it


def test_fault_sink_short_write_persists_prefix():
    fs = FaultInjectingSink(MemorySink(), [FaultSpec.short_write(fraction=0.3)])
    fs.reserve(100)
    with pytest.raises(OSError):
        fs.pwrite(0, b"A" * 100)
    assert fs.persisted_bytes == 30                  # the torn prefix landed
    assert fs.pread(0, 30) == b"A" * 30
    assert fs.faults.short_writes == 1


def test_fault_sink_kill_at_byte_freezes_file():
    fs = FaultInjectingSink(MemorySink(), [FaultSpec.kill_at(25)])
    fs.reserve(100)
    fs.pwrite(0, b"a" * 20)
    with pytest.raises(ProcessKilled):
        fs.pwrite(20, b"b" * 20)                     # crosses byte 25
    assert fs.persisted_bytes == 25                  # exactly 5 of the 20
    assert fs.killed_at == 25 and fs.dead
    with pytest.raises(ProcessKilled):
        fs.pwrite(60, b"later")                      # dead sink stays dead
    with pytest.raises(ProcessKilled):
        fs.fsync()
    fs.close()                                       # teardown always works
    assert crashed_file_bytes(fs)[:25] == b"a" * 20 + b"b" * 5


def test_fault_sink_seeded_schedule_is_deterministic():
    def run(seed):
        fs = FaultInjectingSink(MemorySink(), seed=seed, error_rate=0.3)
        fs.reserve(1000)
        outcomes = []
        for i in range(50):
            try:
                fs.pwrite(i * 10, b"0123456789")
                outcomes.append(1)
            except OSError:
                outcomes.append(0)
        return outcomes
    assert run(7) == run(7)
    assert run(7) != run(8)


def test_fault_sink_latency_and_fsync_rules():
    fs = FaultInjectingSink(MemorySink(), [
        FaultSpec.latency(0.0, op="write", count=2),
        FaultSpec.fsync_error(count=1),
    ])
    fs.reserve(20)
    fs.pwrite(0, b"x" * 10)
    fs.pwrite(10, b"y" * 10)
    assert fs.faults.latencies == 2
    with pytest.raises(OSError):
        fs.fsync()
    fs.fsync()
    assert fs.faults.fsync_errors == 1


# ---------------------------------------------------------------------------
# RetryPolicy units


def test_retry_policy_retryable_classification():
    pol = RetryPolicy()
    assert pol.retryable(OSError(errno.EIO, "io"))
    assert pol.retryable(OSError(errno.ENOSPC, "nospc"))
    assert not pol.retryable(OSError(errno.EBADF, "badf"))
    assert not pol.retryable(ValueError("nope"))
    assert not pol.retryable(ProcessKilled("dead"))


def test_retry_policy_backoff_grows_and_caps():
    pol = RetryPolicy(backoff_base=0.01, backoff_cap=0.05, jitter=False)
    rng = random.Random(0)
    delays = [pol.backoff(a, rng) for a in range(1, 8)]
    assert delays[0] == pytest.approx(0.01)
    assert delays[1] == pytest.approx(0.02)
    assert all(d <= 0.05 + 1e-9 for d in delays)
    assert delays[-1] == pytest.approx(0.05)
    jit = RetryPolicy(backoff_base=0.01, backoff_cap=0.05, jitter=True)
    for a in range(1, 8):
        d = jit.backoff(a, random.Random(1))
        assert 0 < d <= 0.05 * 1.5


# ---------------------------------------------------------------------------
# engine retry paths


def test_transient_errors_retried_zero_loss():
    entries = make_entries(400)
    fs = FaultInjectingSink(MemorySink(), [
        FaultSpec.transient_error(count=3),
        FaultSpec.short_write(at_call=5),
    ])
    w = write_seq(fs, entries)
    d = w.stats.as_dict()
    assert d["io_retries"] >= 4
    assert d["io_giveups"] == 0
    assert read_all(fs.inner) == entries


def test_permanent_error_poisons_and_counts_giveup():
    entries = make_entries(400)
    fs = FaultInjectingSink(MemorySink(), [
        FaultSpec(op="write", kind="error", err=errno.EIO, count=-1,
                  at_offset=(2000, 1 << 62)),
    ])
    w = SequentialWriter(SCHEMA, fs,
                         WriteOptions(cluster_bytes=2048, retry_policy=FAST), device="cpu")
    with pytest.raises(OSError):
        for e in entries:
            w.fill(e)
        w.close()
    # first close surfaces the poison, any further close is
    # an exception-safe no-op
    with pytest.raises(RuntimeError, match="NOT finalized"):
        w.close()
    w.close()
    w.close()
    d = w.stats.as_dict()
    assert d["io_giveups"] >= 1
    assert d["io_retries"] >= FAST.max_attempts - 1
    # nothing was finalized: the torn file has no valid footer
    with pytest.raises(IOError):
        RNTJReader(memory_sink_from_bytes(crashed_file_bytes(fs)), device="cpu")


def test_non_retryable_errno_fails_fast():
    entries = make_entries(200)
    fs = FaultInjectingSink(MemorySink(), [
        FaultSpec(op="write", kind="error", err=errno.EBADF, count=-1,
                  at_offset=(2000, 1 << 62)),
    ])
    w = SequentialWriter(SCHEMA, fs,
                         WriteOptions(cluster_bytes=2048, retry_policy=FAST), device="cpu")
    with pytest.raises(OSError):
        for e in entries:
            w.fill(e)
        w.close()
    try:
        w.close()
    except RuntimeError:
        pass
    d = w.stats.as_dict()
    assert d["io_retries"] == 0          # EBADF is not in retryable_errnos


def test_retry_deadline_bounds_attempts():
    pol = RetryPolicy(max_attempts=1000, backoff_base=0.05, backoff_cap=0.05,
                      jitter=False, deadline=0.12)
    entries = make_entries(100)
    fs = FaultInjectingSink(MemorySink(), [
        FaultSpec(op="write", kind="error", err=errno.EIO, count=-1,
                  at_offset=(2000, 1 << 62)),
    ])
    w = SequentialWriter(SCHEMA, fs,
                         WriteOptions(cluster_bytes=2048, retry_policy=pol), device="cpu")
    with pytest.raises((OSError, RuntimeError)):
        for e in entries:
            w.fill(e)
        w.close()
    try:
        w.close()
    except RuntimeError:
        pass
    d = w.stats.as_dict()
    assert d["io_giveups"] >= 1
    assert d["io_retries"] <= 6          # the deadline cut the 1000 attempts


def test_write_behind_transient_errors_retried():
    entries = make_entries(400)
    fs = FaultInjectingSink(MemorySink(), [FaultSpec.transient_error(count=4)])
    opts = WriteOptions(cluster_bytes=1024, retry_policy=FAST,
                        io_inflight_bytes=1 << 20, io_ring=0)
    w = ParallelWriter(SCHEMA, fs, opts, device="cpu")
    ctx = w.create_fill_context()
    for e in entries:
        ctx.fill(e)
    ctx.close()
    w.close()
    d = w.stats.as_dict()
    assert d["io_retries"] >= 1
    assert read_all(fs.inner) == entries


def test_striped_failure_degrades_to_monolithic():
    entries = make_entries(600)
    fs = FaultInjectingSink(MemorySink(), [
        FaultSpec.transient_error(err=errno.EBADF, at_call=4, count=1),
    ])
    w = write_seq(fs, entries, cluster_bytes=16384,
                  io_stripe_bytes=2048, io_workers=2)
    d = w.stats.as_dict()
    assert d["io_stripe_fallbacks"] >= 1
    assert read_all(fs.inner) == entries


def test_fsync_transient_retried_permanent_poisons():
    entries = make_entries(300)
    # transient: retried, run completes, zero loss
    fs = FaultInjectingSink(MemorySink(), [FaultSpec.fsync_error(count=2)])
    w = write_seq(fs, entries, fsync_policy="every_cluster")
    assert w.stats.as_dict()["io_retries"] >= 2
    assert read_all(fs.inner) == entries

    # permanent: mid-run fsync failure must NOT be swallowed
    fs = FaultInjectingSink(MemorySink(), [FaultSpec.fsync_error(count=-1)])
    w = SequentialWriter(SCHEMA, fs, WriteOptions(
        cluster_bytes=2048, retry_policy=FAST, fsync_policy="every_cluster"), device="cpu")
    with pytest.raises((OSError, RuntimeError)):
        for e in entries:
            w.fill(e)
        w.close()
    try:
        w.close()
    except RuntimeError:
        pass
    d = w.stats.as_dict()
    assert d["io_fsync_failures"] >= 1


def test_ring_fallback_executes_live_ops():
    """UringRing._fallback_execute: a broken submission ring runs its
    in-flight ops synchronously through the engine instead of failing
    them (unit-level: the native ring needs liburing + a real fd)."""
    from repro_torch.core.ioengine import UringRing, _RingOp

    sink = MemorySink()
    engine = IOEngine(sink, workers=0, inflight_bytes=1 << 20,
                      retry=FAST, ring="emulated")
    try:
        ring = UringRing.__new__(UringRing)
        ring._engine = engine
        ring._degraded = False
        ring._live = {}
        payload = b"R" * 512
        off = sink.reserve(len(payload))
        # mirror the submit path's accounting so _job_end balances
        with engine._cv:
            engine._inflight += len(payload)
            engine._pending += 1
        group = _ExtentGroup(1, len(payload), None, False)
        op = _RingOp(group, off, [payload], len(payload))
        ring._live[1] = (op, None, None, engine._job_begin())
        ring._fallback_execute(OSError(errno.ENOMEM, "submit broke"))
        assert ring._degraded
        assert not ring._live
        assert engine.ring_fallbacks == 1
        assert sink.pread(off, len(payload)) == payload
        engine.drain()                   # the group completed: no hang
        assert engine.error is None
    finally:
        engine.close()


# ---------------------------------------------------------------------------
# journal format


def test_cluster_envelope_roundtrip_and_corruption():
    env = md.build_cluster_envelope(seq=7, payload_len=1234, desc_crc=0xABCD)
    assert len(env) == md.CLUSTER_ENV_SIZE
    d = md.parse_cluster_envelope(env)
    assert (d["seq"], d["payload_len"], d["desc_crc"]) == (7, 1234, 0xABCD)
    bad = bytearray(env)
    bad[9] ^= 0xFF
    with pytest.raises(IOError):
        md.parse_cluster_envelope(bytes(bad))
    with pytest.raises(IOError):
        md.parse_cluster_envelope(b"XXXX" + env[4:])


def _pages(offsets, base_col=0):
    return [PageDesc(column=base_col, n_elements=10, offset=o, size=40,
                     uncompressed_size=40, checksum=123, codec=0)
            for o in offsets]


def test_journal_record_roundtrip_buffered_offsets():
    pages = _pages([0, 40, 80])
    body = md.build_journal_body([10, 20], pages)
    rec, crc = md.finish_journal_record(
        seq=3, flags=md.JREC_BUFFERED, cluster_off=5000, cluster_size=120,
        first_entry=100, n_entries=10, n_columns=2, body=body)
    assert len(rec) == md.journal_record_size(2, 3)
    jr, end = md.parse_journal_record(rec)
    assert end == len(rec)
    assert jr.seq == 3 and jr.buffered and jr.crc == crc
    assert jr.n_elements == [10, 20]
    # cluster-relative offsets resolved to absolute
    assert [p.offset for p in jr.pages] == [5000, 5040, 5080]


def test_journal_record_unbuffered_keeps_absolute_offsets():
    pages = _pages([9000, 9040])
    body = md.build_journal_body([20], pages)
    rec, _ = md.finish_journal_record(0, 0, 0, 0, 0, 5, 1, body)
    jr, _ = md.parse_journal_record(rec)
    assert not jr.buffered
    assert [p.offset for p in jr.pages] == [9000, 9040]


def test_journal_record_corruption_detected():
    body = md.build_journal_body([10], _pages([0]))
    rec, _ = md.finish_journal_record(1, md.JREC_BUFFERED, 100, 40, 0, 5, 1,
                                      body)
    bad = bytearray(rec)
    bad[20] ^= 0x01
    with pytest.raises(IOError):
        md.parse_journal_record(bytes(bad))
    with pytest.raises(IOError):
        md.parse_journal_record(rec[: len(rec) - 3])   # truncated


def test_v1_anchor_still_parses():
    body = md._ANCHOR.pack(md.MAGIC, 1, 0, 64, 100, 32, 10, 2, 0)
    crc = zlib.crc32(body[:-8])
    anchor = md._ANCHOR.pack(md.MAGIC, 1, 0, 64, 100, 32, 10, 2, crc)
    d = md.parse_anchor(anchor)
    assert d["n_entries"] == 10
    bad = md._ANCHOR.pack(md.MAGIC, 9, 0, 64, 100, 32, 10, 2, crc)
    with pytest.raises(IOError):
        md.parse_anchor(bad)


def test_journal_framing_is_invisible_to_footer_readers():
    """byte_offset/byte_size point at the payload, so a journaled and an
    unjournaled file decode identically (framing = invisible padding)."""
    entries = make_entries(300)
    with_j, without_j = MemorySink(), MemorySink()
    write_seq(with_j, entries, retry_policy=None)
    write_seq(without_j, entries, retry_policy=None, journal=False)
    assert with_j.size > without_j.size         # framing occupies bytes
    assert read_all(with_j) == read_all(without_j) == entries


# ---------------------------------------------------------------------------
# recovery


def torn_copy(sink, cut):
    """The first ``cut`` bytes of a written file, as recovery sees them."""
    return memory_sink_from_bytes(bytes(sink.buf[:cut]))


def test_scan_complete_file_matches_footer():
    entries = make_entries(500)
    sink = MemorySink()
    write_seq(sink, entries)
    r = RNTJReader(sink, device="cpu")
    footer_clusters = [(cm.first_entry, cm.n_entries, cm.byte_offset,
                        cm.byte_size) for cm in r.clusters]
    r.close()
    _schema, _opts, clusters, rep = scan_container(sink)
    assert rep.entries_salvaged == len(entries)
    assert [(cm.first_entry, cm.n_entries, cm.byte_offset, cm.byte_size)
            for cm in clusters] == footer_clusters
    assert not rep.clusters_dropped


def test_recover_truncated_file_and_read_back():
    entries = make_entries(500)
    sink = MemorySink()
    write_seq(sink, entries)
    ms = torn_copy(sink, int(sink.size * 0.6))
    rep = recover_container(ms)
    assert rep.rebuilt and rep.clusters_salvaged > 0
    got = read_all(ms)
    assert got == entries[: len(got)]
    assert len(got) == rep.entries_salvaged > 0


def test_recover_valid_file_is_a_noop():
    entries = make_entries(200)
    sink = MemorySink()
    write_seq(sink, entries)
    size_before = sink.size
    rep = recover_container(sink)
    assert rep.footer_valid and not rep.rebuilt
    assert sink.size == size_before


def test_recover_force_rebuilds_valid_file():
    entries = make_entries(200)
    sink = MemorySink()
    write_seq(sink, entries)
    rep = recover_container(sink, force=True)
    assert rep.rebuilt
    assert read_all(sink) == entries


def test_recover_dry_run_writes_nothing():
    entries = make_entries(300)
    sink = MemorySink()
    write_seq(sink, entries)
    ms = torn_copy(sink, int(sink.size * 0.5))
    size_before = ms.size
    rep = recover_container(ms, dry_run=True)
    assert rep.clusters_salvaged > 0 and not rep.rebuilt
    assert ms.size == size_before
    with pytest.raises(IOError):
        RNTJReader(memory_sink_from_bytes(bytes(ms.buf[:ms.size])), device="cpu")


def test_recover_drops_cluster_with_corrupt_payload():
    entries = make_entries(500)
    sink = MemorySink()
    write_seq(sink, entries)
    _s, _o, clusters, _rep = scan_container(sink)
    assert len(clusters) >= 3
    victim = clusters[1]
    data = bytearray(bytes(sink.buf[: sink.size]))
    data[victim.byte_offset + 5] ^= 0xFF            # flip a payload byte
    ms = memory_sink_from_bytes(bytes(data))
    rep = recover_container(ms, force=True)
    assert any(d["seq"] == 1 for d in rep.clusters_dropped)
    assert rep.clusters_salvaged == len(clusters) - 1
    # surviving entries read back identical; the dropped cluster's range
    # is renumbered away (entry bytes never lie, ranges may shift)
    got = read_all(ms)
    survivors = []
    for i, cm in enumerate(clusters):
        if i != 1:
            survivors.extend(
                entries[cm.first_entry : cm.first_entry + cm.n_entries])
    assert got == survivors


def test_recover_unbuffered_file():
    entries = make_entries(400)
    sink = MemorySink()
    write_seq(sink, entries, buffered=False)
    ms = torn_copy(sink, int(sink.size * 0.7))
    rep = recover_container(ms)
    assert rep.clusters_salvaged > 0
    got = read_all(ms)
    assert got == entries[: len(got)]


def test_recover_merged_file():
    """Merge raw-copies clusters through _commit_raw_cluster: the merged
    output carries the same envelope/journal framing and salvages."""
    a, b = MemorySink(), MemorySink()
    ents_a, ents_b = make_entries(200, seed=1), make_entries(200, seed=2)
    write_seq(a, ents_a, retry_policy=None)
    write_seq(b, ents_b, retry_policy=None)
    out = MemorySink()
    merge_files([a, b], out, options=WriteOptions(cluster_bytes=2048), device="cpu")
    all_entries = ents_a + ents_b
    assert read_all(out) == all_entries
    ms = torn_copy(out, int(out.size * 0.55))
    rep = recover_container(ms)
    assert rep.clusters_salvaged > 0
    got = read_all(ms)
    assert got == all_entries[: len(got)]


def test_recover_header_torn_is_unrecoverable():
    entries = make_entries(100)
    sink = MemorySink()
    write_seq(sink, entries)
    with pytest.raises(RecoveryError):
        recover_container(torn_copy(sink, 40))
    with pytest.raises(RecoveryError):
        recover_container(memory_sink_from_bytes(b"not an rntj file at all"))


def test_recover_file_paths_and_output_copy(tmp_path):
    entries = make_entries(300)
    sink = MemorySink()
    write_seq(sink, entries)
    cut = int(sink.size * 0.6)
    torn = tmp_path / "torn.rntj"
    torn.write_bytes(bytes(sink.buf[:cut]))

    out = tmp_path / "recovered.rntj"
    rep = recover_container(str(torn), output=str(out))
    assert rep.rebuilt
    assert torn.stat().st_size == cut               # source untouched
    r = RNTJReader(str(out), device="cpu")
    got = list(r.iter_entries())
    r.close()
    assert got == entries[: len(got)] and got

    rep2 = recover_container(str(torn))             # now in place
    assert rep2.rebuilt
    r = RNTJReader(str(torn), device="cpu")
    assert list(r.iter_entries()) == got
    r.close()


def test_tolerant_reader_salvages_torn_file():
    entries = make_entries(400)
    sink = MemorySink()
    write_seq(sink, entries)
    ms = torn_copy(sink, int(sink.size * 0.6))
    with pytest.raises(IOError):
        RNTJReader(ms, device="cpu")
    r = RNTJReader(ms, options=ReadOptions(tolerant=True), device="cpu")
    assert r.salvage is not None and r.salvage.clusters_salvaged > 0
    got = list(r.iter_entries())
    r.close()
    assert got == entries[: len(got)] and got
    # a healthy file opened tolerant reports no salvage
    r = RNTJReader(sink, options=ReadOptions(tolerant=True), device="cpu")
    assert r.salvage is None
    r.close()


# ---------------------------------------------------------------------------
# the crash matrix


def _journal_ends(sink):
    """Per-cluster journal-record end offsets of a cleanly written file,
    in commit order — cluster seq is fully durable iff the file reaches
    its record's end."""
    ends = {}
    _m, _t, plen = md._ENV_HDR.unpack(sink.pread(0, md._ENV_HDR.size))
    pos = md._ENV_HDR.size + plen + 4
    size = sink.size
    while pos + 4 <= size:
        magic = bytes(sink.pread(pos, 4))
        if magic == md.CLUSTER_ENV_MAGIC:
            env = md.parse_cluster_envelope(sink.pread(pos, md.CLUSTER_ENV_SIZE))
            pos += md.CLUSTER_ENV_SIZE + env["payload_len"]
        elif magic == md.JOURNAL_MAGIC:
            jr, end_rel = md.parse_journal_record(
                sink.pread(pos, size - pos), 0)
            ends[jr.seq] = pos + end_rel
            pos = ends[jr.seq]
        elif magic == md._ENV_MAGIC:
            _m2, _t2, plen2 = md._ENV_HDR.unpack(
                sink.pread(pos, md._ENV_HDR.size))
            pos += md._ENV_HDR.size + plen2 + 4
        elif magic == md.MAGIC:
            pos += md.ANCHOR_SIZE
        else:
            raise AssertionError(f"unexpected bytes at {pos} in clean file")
    return ends


def test_crash_matrix_salvage_is_byte_identical_and_maximal():
    entries = make_entries(700, seed=3)
    ref = MemorySink()
    write_seq(ref, entries, cluster_bytes=1024, retry_policy=None)
    size = ref.size
    ends = _journal_ends(ref)
    r = RNTJReader(ref, device="cpu")
    ranges = {i: (cm.first_entry, cm.n_entries)
              for i, cm in enumerate(r.clusters)}
    r.close()
    assert len(ranges) >= 8, "workload too small for a meaningful matrix"

    hdr_end = min(cm_end for cm_end in ends.values())
    kill_points = sorted(set(
        [int(k) for k in np.linspace(600, size + 128, 14)]
        + [hdr_end - 4, hdr_end, hdr_end + 1]        # around the 1st record
        + [size - 80, size - 8]                      # inside footer/anchor
    ))
    assert len(kill_points) >= 18

    for K in kill_points:
        fs = FaultInjectingSink(MemorySink(), [FaultSpec.kill_at(K)])
        crashed = False
        try:
            write_seq(fs, entries, cluster_bytes=1024, retry_policy=None)
        except (ProcessKilled, OSError, RuntimeError):
            crashed = True
        data = crashed_file_bytes(fs)
        # single producer, no write-behind: bytes persisted before the
        # kill are exactly the reference file's prefix; anything past the
        # kill byte is a reserved-but-unwritten (all-zero) sparse tail
        kbyte = fs.killed_at if crashed and fs.killed_at is not None else len(data)
        if crashed:
            assert data[:kbyte] == bytes(ref.buf[:kbyte]), f"K={K}: divergence"
        expected = sum(1 for e in ends.values() if e <= kbyte)
        ms = memory_sink_from_bytes(data)
        try:
            rep = recover_container(ms)
        except RecoveryError:
            assert expected == 0, (
                f"K={K}: unrecoverable but {expected} clusters were durable")
            continue
        if rep.footer_valid:                         # kill never fired
            assert not crashed and read_all(ms) == entries
            continue
        assert rep.clusters_salvaged == expected, (
            f"K={K}: salvaged {rep.clusters_salvaged}, journal says "
            f"{expected} were fully committed")
        assert not rep.clusters_dropped, f"K={K}: dropped {rep.clusters_dropped}"
        got = read_all(ms)
        assert got == entries[: len(got)], f"K={K}: salvage not identical"
        assert len(got) == sum(
            ranges[s][1] for s in range(rep.clusters_salvaged))


def test_crash_during_parallel_write_recovers_committed_prefix():
    """Write-behind + kill: every salvaged cluster must read back
    byte-identical (the salvage count is whatever was durable)."""
    entries = make_entries(600, seed=5)
    fs = FaultInjectingSink(MemorySink(), [FaultSpec.kill_at(6000)])
    opts = WriteOptions(cluster_bytes=1024, io_inflight_bytes=1 << 20,
                        io_ring=0)
    w = ParallelWriter(SCHEMA, fs, opts, device="cpu")
    try:
        ctx = w.create_fill_context()
        for e in entries:
            ctx.fill(e)
        ctx.close()
        w.close()
    except (ProcessKilled, OSError, RuntimeError):
        pass
    try:
        w.close()
    except (ProcessKilled, OSError, RuntimeError):
        pass
    data = crashed_file_bytes(fs)
    ms = memory_sink_from_bytes(data)
    try:
        rep = recover_container(ms)
    except RecoveryError:
        return                                       # killed before header
    got = read_all(ms)
    assert len(got) == rep.entries_salvaged
    assert got == entries[: len(got)]                # sequential fill order


# ---------------------------------------------------------------------------
# RetryPolicy x fault interaction on the fsync path:
# a footer must never cover clusters whose fsync did not succeed


def test_fsync_transient_failure_retries_then_seals(tmp_path):
    """fsync fails transiently under a RetryPolicy: the engine retries to
    success and close() seals a VALID footer (the data really is synced)."""
    fs = FaultInjectingSink(MemorySink(), [FaultSpec.fsync_error(count=2)])
    w = SequentialWriter(SCHEMA, fs, WriteOptions(
        cluster_bytes=2048, retry_policy=FAST, fsync_policy="on_close"), device="cpu")
    entries = make_entries(200, 0)
    for e in entries:
        w.fill(e)
    w.close()  # the close-time fsync absorbs both injected failures
    d = w.stats.as_dict()
    assert d["io_retries"] >= 2 and d["io_giveups"] == 0
    assert fs.faults.fsync_errors == 2
    rep = recover_container(fs.inner, dry_run=True)
    assert rep.footer_valid
    verify = RNTJReader(fs.inner, device="cpu")
    assert list(verify.iter_entries()) == entries
    verify.close()


def test_fsync_permanent_failure_never_seals_footer(tmp_path):
    """fsync fails permanently: retries exhaust, close() poisons — and the
    file must NOT end in a valid footer (its clusters were never synced).
    The journal still makes every committed cluster salvageable."""
    fs = FaultInjectingSink(MemorySink(), [FaultSpec.fsync_error(count=-1)])
    w = SequentialWriter(SCHEMA, fs, WriteOptions(
        cluster_bytes=2048, retry_policy=FAST, fsync_policy="every_cluster"), device="cpu")
    entries = make_entries(200, 0)
    with pytest.raises((OSError, RuntimeError)):
        for e in entries:
            w.fill(e)
        w.close()
    with pytest.raises((OSError, RuntimeError)):
        w.close()  # surfaces the latched poison (and merges engine stats)
    d = w.stats.as_dict()
    assert d["io_fsync_failures"] >= 1 and d["io_giveups"] >= 1

    rep = recover_container(fs.inner, dry_run=True)
    assert not rep.footer_valid, (
        "footer sealed over clusters whose fsync never succeeded")
    # the journaled prefix is still salvageable after the crash
    ms = memory_sink_from_bytes(crashed_file_bytes(fs))
    rep = recover_container(ms)
    assert rep.rebuilt
    r = RNTJReader(ms, device="cpu")
    got = list(r.iter_entries())
    r.close()
    assert got == entries[: len(got)]


def test_mp_participant_fsync_failure_withholds_done(tmp_path):
    """Multi-writer flavor: a participant whose finalize-fsync fails must
    not report DONE — the coordinator fences it and page-verifies its
    clusters instead of trusting the missing durability handshake."""
    from repro_torch.core import (FencedError, MultiWriterCoordinator,
                            join_container, open_sink)
    from repro_torch.core.extents import ExtentLog

    path = str(tmp_path / "mp.rntj")
    opts = WriteOptions(cluster_bytes=1024, retry_policy=FAST,
                        lease_interval=0.3, rendezvous_timeout=5.0,
                        mpw_log_fsync=False)
    coord = MultiWriterCoordinator(SCHEMA, path, opts)
    fs = FaultInjectingSink(open_sink(path, create=False),
                            [FaultSpec.fsync_error(count=-1)])
    w = join_container(path, schema=SCHEMA, options=opts, sink=fs, device="cpu")
    ctx = w.create_fill_context()
    entries = make_entries(60, 0)
    for e in entries:
        ctx.fill(e)
    with pytest.raises((OSError, RuntimeError)):
        ctx.close()
        w.close()

    log = ExtentLog(ExtentLog.sidecar_path(path), fsync=False)
    st = log.snapshot()
    log.close()
    assert not st.writers[w.writer_id].done, (
        "DONE reported despite a failed durability fsync")

    report = coord.seal(expect_writers=1)
    coord.close()
    assert report["fenced"] == [w.writer_id]
    r = RNTJReader(path, device="cpu")
    got = list(r.iter_entries())
    r.close()
    assert got == entries[: len(got)] and got, "committed clusters lost"


# ---------------------------------------------------------------------------
# Part-interval bookkeeping unit
# ---------------------------------------------------------------------------


def test_add_interval_merges():
    iv = []
    _add_interval(iv, 10, 20)
    _add_interval(iv, 30, 40)
    assert iv == [(10, 20), (30, 40)]
    _add_interval(iv, 20, 30)          # bridges the gap
    assert iv == [(10, 40)]
    _add_interval(iv, 0, 5)
    _add_interval(iv, 5, 10)           # touching merges
    assert iv == [(0, 40)]
    _add_interval(iv, 50, 60)
    _add_interval(iv, 45, 55)
    assert iv == [(0, 40), (45, 60)]


def test_parse_remote_url():
    scheme, bucket, key, opts, params = parse_remote_url(
        "mem-s3://bkt/dir/file.rntj?part_bytes=4096&remote_hedge_ms=5&rtt_ms=10")
    assert (scheme, bucket, key) == ("mem-s3", "bkt", "dir/file.rntj")
    assert opts.part_bytes == 4096 and opts.hedge_ms == 5.0
    assert params == {"rtt_ms": "10"}
    with pytest.raises(ValueError):
        parse_remote_url("mem-s3://bucketonly")
    with pytest.raises(ValueError):
        open_sink("no-such-scheme://b/k")


# ---------------------------------------------------------------------------
# Byte identity under zero faults
# ---------------------------------------------------------------------------


def test_byte_identity_zero_faults(tmp_path):
    entries = make_entries(400)
    ref = reference_bytes(entries)

    # vs FileSink
    from repro_torch.core import FileSink
    fsink = FileSink(str(tmp_path / "ref.rntj"))
    write_seq(fsink, entries)
    fsink.close()
    assert (tmp_path / "ref.rntj").read_bytes() == ref

    # remote multipart
    t = FakeTransport(ObjectBucket())
    s = ObjectStoreSink(t, "k", FAST_OPTS)
    write_seq(s, entries)
    s.close()
    assert t.bucket.objects["k"] == ref
    # zero faults -> zero retries, hedges, degradations
    assert s.io.retries == 0 and s.io.giveups == 0
    assert s.io.hedges == 0 and s.io.degradations == 0
    # multipart actually ran: nothing left dangling
    assert t.bucket.uploads.get("k", {}) == {}

    # remote serial-put mode is identical too
    t2 = FakeTransport(ObjectBucket())
    s2 = ObjectStoreSink(t2, "k", RemoteOptions(part_bytes=256,
                                                retry_policy=FAST,
                                                multipart=False))
    write_seq(s2, entries)
    s2.close()
    assert t2.bucket.objects["k"] == ref
    assert s2.io.degradations == 0


def test_url_roundtrip_and_reader_routing():
    reset_mem_buckets()
    entries = make_entries(300, seed=3)
    sink = open_sink("mem-s3://rt/test.rntj?part_bytes=512")
    assert isinstance(sink, ObjectStoreSink)
    write_seq(sink, entries)
    sink.close()
    assert mem_bucket("rt").objects["test.rntj"] == reference_bytes(entries)
    # RNTJReader routes URLs through open_sink(create=False)
    got = read_all("mem-s3://rt/test.rntj")
    assert [dict(e) for e in got] == entries


def test_write_mode_local_reads_and_flush():
    t = FakeTransport(ObjectBucket())
    s = ObjectStoreSink(t, "k", FAST_OPTS)
    off = s.reserve(600)
    s.pwrite(off, b"x" * 600)
    # write-mode preads serve from retained buffers, holes read as zeros
    assert s.pread(0, 600) == b"x" * 600
    assert s.pread(600, 10) == b"\x00" * 10
    # parts 0 and 1 are fully covered by the 600-byte write: flush (and the
    # pwrite itself) ships them
    s.flush()
    parts = next(iter(t.bucket.uploads["k"].values()))
    assert sorted(parts) == [1, 2]
    s.close()
    assert t.bucket.objects["k"] == b"x" * 600


# ---------------------------------------------------------------------------
# Retry semantics
# ---------------------------------------------------------------------------


def test_retry_until_success():
    entries = make_entries(400)
    ref = reference_bytes(entries)
    sched = FaultSchedule([FaultSpec.transient_error(op="part", count=3)])
    t = FakeTransport(ObjectBucket(), schedule=sched)
    s = ObjectStoreSink(t, "k", FAST_OPTS)
    write_seq(s, entries)
    s.close()
    assert t.bucket.objects["k"] == ref
    assert s.io.retries >= 3
    assert s.io.giveups == 0 and s.io.degradations == 0


def test_torn_part_retried_idempotently():
    entries = make_entries(400)
    ref = reference_bytes(entries)
    # two torn part uploads: a prefix lands in the store, the call fails,
    # the retry re-uploads the full part over the same part number
    sched = FaultSchedule([FaultSpec(op="part", kind="short", count=2,
                                     fraction=0.5)])
    t = FakeTransport(ObjectBucket(), schedule=sched)
    s = ObjectStoreSink(t, "k", FAST_OPTS)
    write_seq(s, entries)
    s.close()
    assert t.bucket.objects["k"] == ref
    assert sched.stats.short_writes == 2
    assert s.io.retries >= 2


def test_read_retry_exhaustion_counts_giveup():
    ref = reference_bytes(make_entries(200))
    sched = FaultSchedule([FaultSpec.permanent_error(op="get")])
    t = FakeTransport(ObjectBucket(), schedule=sched)
    t.bucket.objects["k"] = ref
    s = ObjectStoreSink(t, "k", RemoteOptions(retry_policy=FAST),
                        create=False)
    with pytest.raises(OSError):
        s.pread(0, 100)
    assert s.io.retries == FAST.max_attempts - 1
    assert s.io.giveups == 1
    s.close()


def test_torn_get_retried():
    ref = reference_bytes(make_entries(200))
    sched = FaultSchedule([FaultSpec.short_read(op="get", count=2,
                                                fraction=0.25)])
    t = FakeTransport(ObjectBucket(), schedule=sched)
    t.bucket.objects["k"] = ref
    s = ObjectStoreSink(t, "k", RemoteOptions(retry_policy=FAST),
                        create=False)
    assert s.pread(0, 200) == ref[:200]
    assert sched.stats.short_reads == 2
    assert s.io.retries >= 2
    s.close()


def test_deadline_enforcement():
    ref = reference_bytes(make_entries(200))
    # one slow GET (80 ms service) against a 20 ms per-attempt deadline:
    # the attempt burns its deadline, fails with ETIMEDOUT (retryable),
    # and the retry — no longer hit by the latency rule — succeeds
    sched = FaultSchedule([FaultSpec.latency(0.08, op="get", count=1)])
    t = FakeTransport(ObjectBucket(), schedule=sched)
    t.bucket.objects["k"] = ref
    s = ObjectStoreSink(t, "k", RemoteOptions(deadline_ms=20,
                                              retry_policy=FAST),
                        create=False)
    assert s.pread(0, 128) == ref[:128]
    assert s.io.retries >= 1
    s.close()

    # permanent slowness exhausts the retry budget with ETIMEDOUT
    sched = FaultSchedule([FaultSpec.latency(0.05, op="get", count=-1)])
    t = FakeTransport(ObjectBucket(), schedule=sched)
    t.bucket.objects["k"] = ref
    s = ObjectStoreSink(t, "k",
                        RemoteOptions(deadline_ms=10,
                                      retry_policy=RetryPolicy(
                                          max_attempts=3,
                                          backoff_base=0.0001,
                                          backoff_cap=0.0005)),
                        create=False)
    with pytest.raises(OSError) as ei:
        s.pread(0, 64)
    assert ei.value.errno == errno.ETIMEDOUT
    assert s.io.giveups == 1
    s.close()


def test_hedge_wins_race():
    entries = make_entries(300)
    ref = reference_bytes(entries)
    # scripted slow tail on the FIRST ranged GET only: the primary stalls
    # 200 ms, the hedge (the second "get" call) is instant and wins —
    # deterministic because the schedule is scripted, not sampled
    sched = FaultSchedule([FaultSpec.latency(0.2, op="get", count=1)])
    t = FakeTransport(ObjectBucket(), schedule=sched)
    t.bucket.objects["k"] = ref
    s = ObjectStoreSink(t, "k", RemoteOptions(hedge_ms=10,
                                              retry_policy=FAST),
                        create=False)
    r = RNTJReader(s, device="cpu")
    got = list(r.iter_entries())
    r.close()
    assert [dict(e) for e in got] == entries
    d = r.stats.as_dict()
    assert d["io_hedges"] >= 1
    assert d["io_hedge_wins"] >= 1
    assert d["retries"] == 0  # the hedge raced, nothing had to fail


def test_hedge_survives_failing_primary():
    # the hedged pair tolerates one of the two attempts erroring outright
    ref = reference_bytes(make_entries(100))
    sched = FaultSchedule([
        FaultSpec.latency(0.2, op="get", count=1),
        FaultSpec.transient_error(op="get", count=1, at_call=1),
    ])
    t = FakeTransport(ObjectBucket(), schedule=sched)
    t.bucket.objects["k"] = ref
    s = ObjectStoreSink(t, "k", RemoteOptions(hedge_ms=10,
                                              retry_policy=FAST),
                        create=False)
    # hedge (call 1) errors; the slow primary (call 0) still answers
    assert s.pread(0, 100) == ref[:100]
    assert s.io.hedges >= 1
    s.close()


# ---------------------------------------------------------------------------
# Degraded mode
# ---------------------------------------------------------------------------


def test_degraded_fallback_is_lossless():
    entries = make_entries(400)
    ref = reference_bytes(entries)
    sched = FaultSchedule([FaultSpec.permanent_error(op="part")])
    t = FakeTransport(ObjectBucket(), schedule=sched)
    s = ObjectStoreSink(t, "k", FAST_OPTS)
    write_seq(s, entries)
    s.close()
    # multipart never succeeded; the serial put carried the bytes
    assert t.bucket.objects["k"] == ref
    assert s.io.degradations == 1
    assert s.io.retries > 0
    # the dangling upload was aborted during close
    assert t.bucket.uploads.get("k", {}) == {}
    assert [dict(e) for e in
            read_all(ObjectStoreSink(FakeTransport(t.bucket), "k",
                                     create=False))] == entries


def test_degraded_create_multipart():
    entries = make_entries(200)
    ref = reference_bytes(entries)
    sched = FaultSchedule([FaultSpec.permanent_error(op="create")])
    t = FakeTransport(ObjectBucket(), schedule=sched)
    s = ObjectStoreSink(t, "k", FAST_OPTS)
    assert s.io.degradations == 1  # degraded at open, before any write
    write_seq(s, entries)
    s.close()
    assert t.bucket.objects["k"] == ref


def test_degraded_complete_multipart():
    entries = make_entries(300)
    ref = reference_bytes(entries)
    sched = FaultSchedule([FaultSpec.permanent_error(op="complete")])
    t = FakeTransport(ObjectBucket(), schedule=sched)
    s = ObjectStoreSink(t, "k", FAST_OPTS)
    write_seq(s, entries)
    s.close()
    assert t.bucket.objects["k"] == ref
    assert s.io.degradations == 1


# ---------------------------------------------------------------------------
# Interrupted multipart -> salvage
# ---------------------------------------------------------------------------


def _kill_mid_multipart(entries, at_call=10, part_bytes=256):
    sched = FaultSchedule([FaultSpec(op="part", kind="kill",
                                     at_call=at_call)])
    bkt = ObjectBucket()
    t = FakeTransport(bkt, schedule=sched)
    s = ObjectStoreSink(t, "k", RemoteOptions(part_bytes=part_bytes,
                                              retry_policy=FAST))
    with pytest.raises((ProcessKilled, RuntimeError)):
        write_seq(s, entries)
    s.close()  # poisoned teardown must not raise
    assert "k" not in bkt.objects
    assert bkt.uploads["k"], "interrupted upload must survive the crash"
    return bkt


def test_interrupted_multipart_salvage_roundtrip():
    entries = make_entries(2000, seed=11)
    bkt = _kill_mid_multipart(entries)
    # a fresh transport over the same bucket is the recovery process
    report = salvage_remote(FakeTransport(bkt), "k")
    assert report.remote["mode"] == "multipart"
    assert report.remote["parts_salvaged"] >= 10
    assert report.rebuilt
    assert report.entries_salvaged > 0
    # the rebuilt object is a readable container with a salvaged prefix
    assert "k" in bkt.objects
    assert bkt.uploads.get("k", {}) == {}, "dangling upload aborted"
    got = read_all(ObjectStoreSink(FakeTransport(bkt), "k", create=False))
    assert [dict(e) for e in got] == entries[: len(got)]
    assert len(got) == report.entries_salvaged


def test_salvage_dry_run_leaves_store_untouched():
    entries = make_entries(2000, seed=11)
    bkt = _kill_mid_multipart(entries)
    report = salvage_remote(FakeTransport(bkt), "k", dry_run=True)
    assert report.entries_salvaged > 0 and not report.rebuilt
    assert "k" not in bkt.objects
    assert bkt.uploads["k"]


def test_recover_container_routes_remote_urls():
    reset_mem_buckets()
    entries = make_entries(2000, seed=5)
    sched = FaultSchedule([FaultSpec(op="part", kind="kill", at_call=10)])
    bkt = mem_bucket("rec")
    t = FakeTransport(bkt, schedule=sched)
    s = ObjectStoreSink(t, "file.rntj", RemoteOptions(part_bytes=256,
                                                      retry_policy=FAST))
    with pytest.raises((ProcessKilled, RuntimeError)):
        write_seq(s, entries)
    s.close()
    with pytest.raises(ValueError):
        recover_container("mem-s3://rec/file.rntj", output="/tmp/x")
    report = recover_container("mem-s3://rec/file.rntj")
    assert report.remote["mode"] == "multipart"
    assert report.rebuilt and report.entries_salvaged > 0
    got = read_all("mem-s3://rec/file.rntj")
    assert [dict(e) for e in got] == entries[: len(got)]


def test_salvage_existing_object_with_valid_footer_is_noop():
    entries = make_entries(300)
    bkt = ObjectBucket()
    s = ObjectStoreSink(FakeTransport(bkt), "k", FAST_OPTS)
    write_seq(s, entries)
    s.close()
    before = bkt.objects["k"]
    report = salvage_remote(FakeTransport(bkt), "k")
    assert report.remote["mode"] == "object"
    assert report.footer_valid and not report.rebuilt
    assert bkt.objects["k"] == before


def test_salvage_nothing_there():
    with pytest.raises(RecoveryError):
        salvage_remote(FakeTransport(ObjectBucket()), "missing")


# ---------------------------------------------------------------------------
# Satellite: FaultInjectingSink covers pread_into (zero-copy read path)
# ---------------------------------------------------------------------------


def test_fault_sink_pread_into_injects():
    ref = b"0123456789" * 20
    fs = FaultInjectingSink(memory_sink_from_bytes(ref),
                            faults=[FaultSpec.transient_error(op="read")])
    buf = bytearray(50)
    with pytest.raises(OSError):
        fs.pread_into(0, buf)
    assert fs.faults.errors == 1
    # next call goes through (count=1 consumed) and lands real bytes
    assert fs.pread_into(0, buf) == 50
    assert bytes(buf) == ref[:50]


def test_fault_sink_pread_into_torn_fills_prefix():
    ref = bytes(range(200))
    fs = FaultInjectingSink(memory_sink_from_bytes(ref),
                            faults=[FaultSpec.short_read(fraction=0.5)])
    buf = bytearray(b"\xff" * 100)
    with pytest.raises(OSError):
        fs.pread_into(0, buf)
    assert fs.faults.short_reads == 1
    # the torn response delivered exactly the prefix; the tail is the
    # caller's stale buffer — the contract recycled-pool readers must
    # survive
    assert bytes(buf[:50]) == ref[:50]
    assert bytes(buf[50:]) == b"\xff" * 50


def test_fault_sink_pread_torn_raises_without_prefix():
    ref = bytes(range(100))
    fs = FaultInjectingSink(memory_sink_from_bytes(ref),
                            faults=[FaultSpec.short_read(fraction=0.5)])
    with pytest.raises(OSError):
        fs.pread(0, 64)
    assert fs.faults.short_reads == 1
    assert fs.pread(0, 64) == ref[:64]


def test_fault_sink_pwritev_decomposition_sees_every_part():
    # base-class pwritev decomposes into pwrites, so per-part faults fire
    fs = FaultInjectingSink(MemorySink(),
                            faults=[FaultSpec.transient_error(at_call=1)])
    fs.reserve(8)
    with pytest.raises(OSError):
        fs.pwritev(0, [b"aaaa", b"bbbb"])
    assert fs.faults.errors == 1
    assert fs.persisted_bytes == 4  # first part landed before the fault


# ---------------------------------------------------------------------------
# Satellite: reader-level retry policy
# ---------------------------------------------------------------------------


def test_reader_retries_transient_pread_faults():
    entries = make_entries(400)
    ref = reference_bytes(entries)
    fs = FaultInjectingSink(memory_sink_from_bytes(ref),
                            faults=[FaultSpec.transient_error(op="read",
                                                              count=3)])
    got = read_all(fs, options=ReadOptions(retry_policy=FAST))
    assert [dict(e) for e in got] == entries
    r = RNTJReader(memory_sink_from_bytes(ref), device="cpu")
    r.close()


def test_reader_retry_stats_and_default_fail_fast():
    entries = make_entries(400)
    ref = reference_bytes(entries)

    fs = FaultInjectingSink(memory_sink_from_bytes(ref),
                            faults=[FaultSpec.transient_error(op="read",
                                                              count=2)])
    r = RNTJReader(fs, options=ReadOptions(retry_policy=FAST), device="cpu")
    list(r.iter_entries())
    r.close()
    d = r.stats.as_dict()
    assert d["retries"] >= 2 and d["giveups"] == 0

    # default ReadOptions: first transient error raises (fail fast)
    fs2 = FaultInjectingSink(memory_sink_from_bytes(ref),
                             faults=[FaultSpec.transient_error(op="read")])
    with pytest.raises((IOError, OSError)):
        read_all(fs2)


def test_reader_gives_up_on_permanent_faults():
    entries = make_entries(200)
    ref = reference_bytes(entries)
    fs = FaultInjectingSink(memory_sink_from_bytes(ref),
                            faults=[FaultSpec.permanent_error(op="read")])
    r = None
    with pytest.raises((IOError, OSError)):
        r = RNTJReader(fs, options=ReadOptions(retry_policy=FAST), device="cpu")
        list(r.iter_entries())
    if r is not None:
        r.close()


# ---------------------------------------------------------------------------
# Acceptance: 100 ms RTT, seeded transient faults, parallel write
# ---------------------------------------------------------------------------


def test_acceptance_high_rtt_faulty_parallel_write():
    entries = make_entries(600, seed=42)

    sched = FaultSchedule(seed=1234, error_rate=0.05,
                          errnos=(errno.EIO, errno.ETIMEDOUT),
                          random_ops=("put", "part", "get", "create",
                                      "complete"))
    t = FakeTransport(ObjectBucket(), schedule=sched, rtt_s=0.1)
    s = ObjectStoreSink(t, "k", RemoteOptions(part_bytes=256,
                                              retry_policy=FAST))
    w = ParallelWriter(SCHEMA, s, WriteOptions(cluster_bytes=4096,
                                               retry_policy=FAST), device="cpu")

    def fill(tid):
        ctx = w.create_fill_context()
        for e in entries[tid::4]:
            ctx.fill(e)
        ctx.close()

    threads = [threading.Thread(target=fill, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    w.close()

    stats = w.stats.as_dict()
    # faults were actually sampled, and every one shows up as a retry:
    # zero retries ≠ zero faults, in both directions
    assert sched.stats.random_errors > 0, "fault schedule never fired"
    assert stats["io_retries"] > 0
    assert stats["io_retries"] >= sched.stats.random_errors - \
        stats["io_degradations"] * FAST.max_attempts
    assert stats["io_giveups"] == 0 or stats["io_degradations"] > 0

    # parallel commit order (and hence cluster packing) is nondeterministic,
    # so verify losslessness through the readers rather than byte equality
    # with the sequential reference
    assert t.bucket.objects["k"]

    sys.path.insert(0, str(REPO_ROOT / "benchmarks"))
    try:
        from _legacy_seed_reader import SeedRNTJReader
    finally:
        sys.path.pop(0)
    seed_r = SeedRNTJReader(
        ObjectStoreSink(FakeTransport(t.bucket), "k", create=False))
    assert seed_r.n_entries == len(entries)
    ids = np.concatenate(
        [seed_r.read_cluster(i)[0] for i in range(seed_r.n_clusters)]
    )
    seed_r.close()
    assert ids.dtype == np.int64
    assert sorted(ids.tolist()) == [e["id"] for e in entries]

    got = read_all(ObjectStoreSink(FakeTransport(t.bucket), "k",
                                   create=False))
    assert sorted(e["id"] for e in got) == [e["id"] for e in entries]

    # and the inverse direction: a clean transport reports zero retries
    t2 = FakeTransport(ObjectBucket(), rtt_s=0.0)
    s2 = ObjectStoreSink(t2, "k", FAST_OPTS)
    write_seq(s2, entries, cluster_bytes=4096)
    s2.close()
    assert s2.io.retries == 0


def test_idempotent_reupload_skips_unchanged_parts():
    t = FakeTransport(ObjectBucket())
    s = ObjectStoreSink(t, "k", RemoteOptions(part_bytes=128,
                                              retry_policy=FAST))
    s.reserve(256)
    s.pwrite(0, b"a" * 256)   # ships parts 1 and 2
    sched_calls_before = len(next(iter(t.bucket.uploads["k"].values())))
    assert sched_calls_before == 2
    s.flush()                  # nothing new: CRC-keyed skip
    s.close()                  # close re-walks all parts; unchanged -> skip
    assert t.bucket.objects["k"] == b"a" * 256


def test_rewritten_part_reuploads_under_same_number():
    t = FakeTransport(ObjectBucket())
    s = ObjectStoreSink(t, "k", RemoteOptions(part_bytes=128,
                                              retry_policy=FAST))
    s.reserve(300)
    s.pwrite(0, b"a" * 300)
    s.pwrite(0, b"b" * 64)     # dirties part 0 after it was shipped
    s.close()
    obj = t.bucket.objects["k"]
    assert obj == b"b" * 64 + b"a" * 236


# ---------------------------------------------------------------------------
# both packages on the same bytes


def _pkg_torn(pkg, buffered, frac, n=600):
    """A file of ``pkg`` (one producer, journaled) cut at ``frac`` of its
    bytes, as a crash leaves it."""
    s = pkg.Schema([pkg.Leaf("id", "int64"),
                    pkg.Collection("vals", pkg.Leaf("_0", "float32"))])
    kw = {"device": "cpu"} if pkg is T else {}
    sink = pkg.MemorySink()
    w = pkg.SequentialWriter(s, sink, pkg.WriteOptions(
        cluster_bytes=2048, buffered=buffered), **kw)
    for e in make_entries(n):
        w.fill(e)
    w.close()
    return bytes(sink.buf[: int(sink.size * frac)])


def _pkg_entries(pkg, path, tolerant=False):
    kw = {"device": "cpu"} if pkg is T else {}
    with pkg.RNTJReader(path, options=pkg.ReadOptions(tolerant=tolerant),
                        **kw) as r:
        return list(r.iter_entries())


@pytest.mark.parametrize("frac", [0.35, 0.7, 0.95])
@pytest.mark.parametrize("buffered", [True, False])
@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_each_package_recovers_the_others_torn_file(tmp_path, writer,
                                                    buffered, frac):
    torn = _pkg_torn(R if writer == "repro" else T, buffered, frac)
    outs, reports = [], []
    for pkg in (R, T):
        p = tmp_path / f"{pkg.__name__}.rntj"
        p.write_bytes(torn)
        reports.append(pkg.recover_container(str(p)))
        outs.append(p.read_bytes())
    assert outs[0] == outs[1]
    a, b = reports
    assert (a.clusters_salvaged, a.entries_salvaged) == (
        b.clusters_salvaged, b.entries_salvaged)
    assert b.entries_salvaged > 0
    p = str(tmp_path / f"{T.__name__}.rntj")
    got = _pkg_entries(T, p)
    assert got == _pkg_entries(R, p)
    assert got == make_entries(600)[: len(got)]


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_each_tolerant_reader_opens_the_others_torn_file(tmp_path, writer):
    p = tmp_path / "torn.rntj"
    p.write_bytes(_pkg_torn(R if writer == "repro" else T, True, 0.6))
    with pytest.raises(IOError):
        T.RNTJReader(str(p), device="cpu")
    got = _pkg_entries(T, str(p), tolerant=True)
    assert got and got == _pkg_entries(R, str(p), tolerant=True)
    assert got == make_entries(600)[: len(got)]
    with T.RNTJReader(str(p), options=ReadOptions(tolerant=True),
                      device="cpu") as r:
        assert r.salvage.entries_salvaged == len(got)
    assert p.read_bytes() == _pkg_torn(R if writer == "repro" else T,
                                       True, 0.6)  # opening wrote nothing


@pytest.mark.parametrize("kernels", ["plain_kernels", "numpy"])
def test_remote_object_holds_the_bytes_of_a_file_write(tmp_path, monkeypatch,
                                                       kernels):
    """One producer writes to ``mem-s3://`` and to a file through the port
    (every fill and seal through the plain K1 and K2, or numpy): the
    object's bytes equal both files and the reference's file, and the
    object reads back equal."""
    if kernels == "plain_kernels":
        monkeypatch.setenv("REPRO_TORCH_OFFSETS_MIN", "0")
        monkeypatch.setenv("REPRO_TORCH_SHUFFLE_MIN", "0")
    else:
        monkeypatch.setenv("REPRO_TORCH_KERNEL_BACKEND", "numpy")
    reset_mem_buckets()
    entries = make_entries(2000, seed=5)
    opts = dict(cluster_bytes=16 * 1024, page_size=4096)
    url = "mem-s3://port/paper.rntj?part_bytes=4096"
    w = SequentialWriter(SCHEMA, url, WriteOptions(**opts), device="cpu")
    for e in entries:
        w.fill(e)
    w.close()
    obj = mem_bucket("port").objects["paper.rntj"]
    w = SequentialWriter(SCHEMA, str(tmp_path / "t.rntj"), WriteOptions(**opts),
                         device="cpu")
    for e in entries:
        w.fill(e)
    w.close()
    rs = R.Schema([R.Leaf("id", "int64"),
                   R.Collection("vals", R.Leaf("_0", "float32"))])
    with R.SequentialWriter(rs, str(tmp_path / "r.rntj"),
                            R.WriteOptions(**opts)) as w:
        for e in entries:
            w.fill(e)
    assert obj == (tmp_path / "t.rntj").read_bytes()
    assert obj == (tmp_path / "r.rntj").read_bytes()
    assert [dict(e) for e in read_all(url.split("?")[0])] == entries
