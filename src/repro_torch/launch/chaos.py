"""Chaos driver: run the port's write path under injected storage faults,
the twin of the JAX package's ``tools/chaos.py``.

Each scenario builds a file through a :class:`FaultInjectingSink` and
asserts the robustness contract that DESIGN.md §8 promises for it:

* ``transient``     — scripted EIO/EAGAIN bursts + a torn (short) write:
                      the run completes, retry counters are nonzero, and
                      the file reads back with zero loss.
* ``seeded``        — seeded random transient errors at an error rate:
                      same seed → same fault schedule; zero loss.
* ``enospc``        — persistent ENOSPC on an offset window: retries
                      exhaust, the writer poisons, close() raises, and a
                      second close() is a safe no-op.
* ``fsync``         — transient then permanent fsync failure: the former
                      is retried, the latter poisons (never swallowed).
* ``stripe``        — a non-retryable stripe error: the engine rewrites
                      the extent monolithically and disables striping.
* ``ring``          — write-behind (emulated ring) under transient
                      faults: completes with zero loss.
* ``latency``       — injected latency spikes: slow but lossless.
* ``kill``          — a matrix of process-kill points across the file:
                      each torn file is salvaged by ``recover_container``
                      and every salvaged entry reads back byte-identical.
* ``skim``          — selective (zone-map pruned) filtered reads under
                      transient pread faults (retried, results equal the
                      clean run) and after a kill+recover (zone maps
                      dropped with a reason, filtered results exact).
* ``mpkill``        — N processes x kill point x fault type over
                      one shared container (DESIGN.md §8.6), and a
                      straggler fenced at the rendezvous.
* ``mprecover``     — the coordinator dies before its seal:
                      ``recover_container`` rebuilds the file from the
                      journal and the side-car log.
* ``remote``        — the object-store sink cell matrix (DESIGN.md §10):
                      clean multipart byte-identity, transient transport
                      faults retried, seeded random faults, torn ranged
                      GETs, hedged slow tails, multipart→serial-put
                      degradation, and a writer killed mid-multipart
                      whose interrupted upload ``recover_container``
                      salvages back into a readable object.

Device (``--device``, default ``cuda``): every writer, reader and
participant runs on it, so each fill's offsets scan and each seal's
byte-plane split go through the CUDA kernels on a card (above their size
floors: ``REPRO_TORCH_OFFSETS_MIN=0`` and ``REPRO_TORCH_SHUFFLE_MIN=0``
send every one through them), or through their plain PyTorch versions
with ``--device cpu``.  Without a card and without ``--device cpu`` the
run raises.  Every salvaged or recovered file is also read through the
device decode chain (``RNTJReader.iter_clusters_device``) and held
against the host decode, column for column.

The multi-process scenarios fork their participants from a
``forkserver`` that imported this module (and so torch) but never opens
CUDA: a child of the caller, which may hold a CUDA context, could not
re-initialise CUDA, and a spawned child would import torch anew (seconds
a child).  Each child takes the caller's ``REPRO_TORCH_*`` variables,
opens the device and loads the kernels before it joins, and the
coordinator's rendezvous starts only once every child is ready, so a
child's start-up never counts against a lease or the rendezvous
deadline; ``mpkill`` starts the participants of the next cells while one
runs.  :func:`stop_forkserver` ends the server (it also ends with the
caller).

Run:
    python -m repro_torch.launch.chaos                      # all, on the card
    python -m repro_torch.launch.chaos --device cpu         # all, on the CPU
    python -m repro_torch.launch.chaos --scenario kill      # one scenario
    python -m repro_torch.launch.chaos --seed 3 --entries 2000

Exit status: 0 when every scenario holds its invariant, 1 otherwise.
"""

from __future__ import annotations

import argparse
import errno
import multiprocessing
import os
import sys
import tempfile
import time
import warnings

import numpy as np

from repro_torch.core import (
    Collection,
    F,
    FaultInjectingSink,
    FaultSchedule,
    FaultSpec,
    FencedError,
    Leaf,
    MemorySink,
    MultiWriterCoordinator,
    ParallelWriter,
    ProcessKilled,
    ReadOptions,
    RecoveryError,
    RetryPolicy,
    RNTJReader,
    Schema,
    SequentialWriter,
    WriteOptions,
    join_container,
    open_sink,
    recover_container,
)
from repro_torch.core.faults import crashed_file_bytes, memory_sink_from_bytes
from repro_torch.core.remote import (
    FakeTransport,
    ObjectBucket,
    ObjectStoreSink,
    RemoteOptions,
    salvage_remote,
)
from repro_torch.kernels import _build, ops
from repro_torch.kernels.byteshuffle import byteshuffle_pages_host
from repro_torch.kernels.offsets_scan import offsets_scan_host

# Under ``python -m`` a participant re-runs this module as its main module,
# which the fork server has already imported: runpy's warning says so.
warnings.filterwarnings(
    "ignore", message="'repro_torch.launch.chaos' found in sys.modules",
    category=RuntimeWarning)

SCHEMA = Schema([
    Leaf("id", "int64"),
    Collection("vals", Leaf("_0", "float32")),
])

# fast deterministic backoff so chaos runs stay quick
POLICY = RetryPolicy(max_attempts=8, backoff_base=0.0002, backoff_cap=0.002)

#: seconds a participant may take to become ready (the device and the
#: kernels), and to run to its end after that
CHILD_START_S = 300
CHILD_RUN_S = 120
#: the port's variables, which a participant takes from its parent
ENV_PREFIX = "REPRO_TORCH_"

#: launch counts of the multi-process scenarios' children, summed over
#: every child since the last :func:`reset_child_launches` (each process
#: counts its own launches; a child sends its counts before it exits)
CHILD_LAUNCHES = dict.fromkeys(ops.KERNELS, 0)
#: seconds from each participant's start to its ``"ready"``, since the
#: last :func:`reset_child_launches`
CHILD_READY_S = []


def reset_child_launches() -> None:
    for k in CHILD_LAUNCHES:
        CHILD_LAUNCHES[k] = 0
    CHILD_READY_S.clear()


def make_entries(n: int, seed: int):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 6, size=n)
    return [
        {"id": int(i), "vals": [float(v) for v in rng.random(lens[i],
                                                             dtype=np.float32)]}
        for i in range(n)
    ]


def write_through(sink, entries, device, **opt_kw):
    opts = WriteOptions(cluster_bytes=opt_kw.pop("cluster_bytes", 8192),
                        retry_policy=POLICY, **opt_kw)
    w = SequentialWriter(SCHEMA, sink, opts, device=device)
    for e in entries:
        w.fill(e)
    w.close()
    return w


def verify_lossless(inner_sink, entries, label, device):
    r = RNTJReader(inner_sink, device=device)
    got = list(r.iter_entries())
    r.close()
    assert len(got) == len(entries), (
        f"{label}: {len(got)} of {len(entries)} entries read back")
    assert got == entries, f"{label}: entries differ after faults"


def verify_device(sink, label, device) -> int:
    """Read a salvaged or recovered file through the device decode chain
    and hold every cluster's columns against the host decode; -> the
    clusters read."""
    n = 0
    with RNTJReader(sink, device=device) as r:
        for i, cols in r.iter_clusters_device():
            host = r.read_cluster(i)
            assert set(cols) == set(host), (
                f"{label}: cluster {i} decoded columns {sorted(cols)} on "
                f"the device, {sorted(host)} on the host")
            for ci, arr in cols.items():
                a = arr.cpu().numpy() if hasattr(arr, "cpu") else arr
                assert np.array_equal(a.astype(host[ci].dtype), host[ci]), (
                    f"{label}: cluster {i} column {ci}: device decode "
                    "differs from the host decode")
            n += 1
    return n


# -- scenarios ---------------------------------------------------------------


def scenario_transient(entries, seed, device):
    fs = FaultInjectingSink(MemorySink(), [
        FaultSpec.transient_error(count=3),
        FaultSpec.transient_error(err=errno.EAGAIN, count=2, at_call=11),
        FaultSpec.short_write(at_call=6),
    ])
    w = write_through(fs, entries, device)
    d = w.stats.as_dict()
    assert d["io_retries"] >= 5, f"retries not counted: {d['io_retries']}"
    assert d["io_giveups"] == 0
    verify_lossless(fs.inner, entries, "transient", device)
    return {"retries": d["io_retries"], "injected": fs.faults.injected}


def scenario_seeded(entries, seed, device):
    # a 10% per-call rate needs enough write calls to fire with near
    # certainty — pad tiny --entries workloads deterministically
    if len(entries) < 2000:
        entries = entries + make_entries(2000 - len(entries), seed + 1)
    fs = FaultInjectingSink(MemorySink(), seed=seed, error_rate=0.1)
    w = write_through(fs, entries, device, cluster_bytes=2048)
    d = w.stats.as_dict()
    assert fs.faults.random_errors >= 1, "seeded schedule injected nothing"
    assert d["io_retries"] >= fs.faults.random_errors
    verify_lossless(fs.inner, entries, "seeded", device)
    return {"retries": d["io_retries"],
            "injected": fs.faults.random_errors}


def scenario_enospc(entries, seed, device):
    fs = FaultInjectingSink(MemorySink(), [
        FaultSpec(op="write", kind="error", err=errno.ENOSPC, count=-1,
                  at_offset=(4096, 1 << 62)),
    ])
    w = SequentialWriter(SCHEMA, fs, WriteOptions(cluster_bytes=2048,
                                                  retry_policy=POLICY),
                         device=device)
    poisoned = False
    try:
        for e in entries:
            w.fill(e)
        w.close()
    except (OSError, RuntimeError):
        poisoned = True
    assert poisoned, "persistent ENOSPC did not fail the writer"
    try:
        w.close()  # the first close after a poisoned commit surfaces it
    except (OSError, RuntimeError):
        pass
    w.close()      # ... and any further close is a safe no-op (§8.2)
    d = w.stats.as_dict()
    assert d["io_giveups"] >= 1, "exhausted retries not counted as giveup"
    return {"giveups": d["io_giveups"], "retries": d["io_retries"]}


def scenario_fsync(entries, seed, device):
    fs = FaultInjectingSink(MemorySink(), [FaultSpec.fsync_error(count=2)])
    w = write_through(fs, entries, device, fsync_policy="every_cluster")
    assert w.stats.as_dict()["io_retries"] >= 2
    verify_lossless(fs.inner, entries, "fsync-transient", device)

    fs = FaultInjectingSink(MemorySink(), [FaultSpec.fsync_error(count=-1)])
    w = SequentialWriter(SCHEMA, fs, WriteOptions(
        cluster_bytes=8192, retry_policy=POLICY,
        fsync_policy="every_cluster"), device=device)
    poisoned = False
    try:
        for e in entries:
            w.fill(e)
        w.close()
    except (OSError, RuntimeError):
        poisoned = True
    try:
        w.close()
    except (OSError, RuntimeError):
        pass
    assert poisoned, "permanent fsync failure was swallowed"
    assert w.stats.as_dict()["io_fsync_failures"] >= 1
    return {"fsync_failures": w.stats.as_dict()["io_fsync_failures"]}


def scenario_stripe(entries, seed, device):
    fs = FaultInjectingSink(MemorySink(), [
        FaultSpec.transient_error(err=errno.EBADF, at_call=4, count=1),
    ])
    w = write_through(fs, entries, device, cluster_bytes=16384,
                      io_stripe_bytes=2048, io_workers=2)
    d = w.stats.as_dict()
    assert d["io_stripe_fallbacks"] >= 1, "stripe failure did not degrade"
    verify_lossless(fs.inner, entries, "stripe", device)
    return {"stripe_fallbacks": d["io_stripe_fallbacks"]}


def scenario_ring(entries, seed, device):
    fs = FaultInjectingSink(MemorySink(), [
        FaultSpec.transient_error(count=4),
    ])
    opts = WriteOptions(cluster_bytes=4096, retry_policy=POLICY,
                        io_inflight_bytes=1 << 20, io_ring=0)
    w = ParallelWriter(SCHEMA, fs, opts, device=device)
    ctx = w.create_fill_context()
    for e in entries:
        ctx.fill(e)
    ctx.close()
    w.close()
    d = w.stats.as_dict()
    assert d["io_retries"] >= 1
    verify_lossless(fs.inner, entries, "ring", device)
    return {"retries": d["io_retries"]}


def scenario_latency(entries, seed, device):
    fs = FaultInjectingSink(MemorySink(), [
        FaultSpec.latency(0.002, count=5),
    ])
    write_through(fs, entries, device)
    assert fs.faults.latencies == 5
    verify_lossless(fs.inner, entries, "latency", device)
    return {"latencies": fs.faults.latencies}


def scenario_kill(entries, seed, device):
    # reference file: the same workload written cleanly
    ref = MemorySink()
    write_through(ref, entries, device, cluster_bytes=2048)
    size = ref.size
    kills = [int(k) for k in np.linspace(200, size + 64, 12)]
    results = []
    for K in kills:
        fs = FaultInjectingSink(MemorySink(), [FaultSpec.kill_at(K)])
        try:
            write_through(fs, entries, device, cluster_bytes=2048)
            crashed = False
        except (ProcessKilled, OSError, RuntimeError):
            crashed = True
        ms = memory_sink_from_bytes(crashed_file_bytes(fs))
        try:
            recover_container(ms)
        except RecoveryError:
            assert K < 1024, f"header-only loss expected near 0, not K={K}"
            results.append((K, "unrecoverable"))
            continue
        r = RNTJReader(ms, device=device)
        got = list(r.iter_entries())
        r.close()
        assert got == entries[: len(got)], (
            f"K={K}: salvaged entries not byte-identical")
        if not crashed:
            assert len(got) == len(entries)
        verify_device(ms, f"K={K}", device)
        results.append((K, len(got)))
    return {"kill_points": len(kills), "salvage": results}


def scenario_skim(entries, seed, device):
    """Selective (zone-map pruned) reads under the §8.2 fault schedule.

    Three invariants: (a) a pruned filtered read through a faulty sink
    equals the clean pruned read (transient pread errors retried, not
    surfaced); (b) pruned ≡ unpruned on the same faulty sink; (c) a file
    torn by a mid-write kill recovers with its zone maps DROPPED (the
    journal cannot attest them) and the filtered read over the salvaged
    file is exact — stale bounds are never served.
    """
    pred = (F("vals._0") > 0.8) | (F("id") < 10)

    def filtered(sink, prune, retry=None):
        r = RNTJReader(sink, options=ReadOptions(filter=pred, prune=prune,
                                                 retry_policy=retry),
                       device=device)
        try:
            return list(r.iter_filtered_entries()), r.stats
        finally:
            r.close()

    clean = MemorySink()
    write_through(clean, entries, device, cluster_bytes=2048,
                  page_size=512, codec="none")
    ref, _ref_stats = filtered(clean, prune=True)
    full, _ = filtered(clean, prune=False)
    assert ref == full, "pruned filtered read differs from full scan"

    # (a)+(b) transient pread faults under the reader's retry policy
    fs = FaultInjectingSink(
        memory_sink_from_bytes(bytes(clean.buf[:clean.size])), [
            FaultSpec.transient_error(count=3, op="read"),
            FaultSpec.transient_error(err=errno.EAGAIN, count=2, op="read",
                                      at_call=5),
        ])
    got, stats = filtered(fs, prune=True, retry=POLICY)
    assert got == ref, "faulty-sink pruned read differs from clean read"
    assert stats.retries >= 1, "transient pread faults were not retried"

    # (c) kill mid-write, recover, re-filter: zone maps dropped, results exact
    fs = FaultInjectingSink(MemorySink(), [FaultSpec.kill_at(clean.size // 2)])
    try:
        write_through(fs, entries, device, cluster_bytes=2048,
                      page_size=512, codec="none")
    except (ProcessKilled, OSError, RuntimeError):
        pass
    ms = memory_sink_from_bytes(crashed_file_bytes(fs))
    rep = recover_container(ms)
    assert rep.rebuilt, "kill point did not tear the footer"
    assert rep.zonemaps is not None and not rep.zonemaps["preserved"], (
        "recovery must drop unattested zone maps with a reason")
    pruned, _ = filtered(ms, prune=True)
    unpruned, _ = filtered(ms, prune=False)
    assert pruned == unpruned, "salvaged file: pruned differs from full scan"
    verify_device(ms, "skim salvage", device)
    return {"matched": len(ref), "retries": stats.retries,
            "salvaged_matches": len(pruned)}


# -- multi-process crash matrix (DESIGN.md §8.6) -----------------------------

# WriteOptions for every mp cell: tiny clusters, fast leases, no side-car
# fsync (the matrix kills processes, not the kernel)
def _mp_options():
    return WriteOptions(cluster_bytes=2048, retry_policy=POLICY,
                        lease_interval=0.3, rendezvous_timeout=5.0,
                        mpw_log_fsync=False)


def _mp_fault_specs(fault: str, point: int):
    if fault == "eio":
        return [FaultSpec.transient_error(count=3)]
    if fault == "torn":
        return [FaultSpec.short_write(at_call=3)]
    if fault == "enospc":  # a persistent wall at this writer's Nth byte
        return [FaultSpec(op="write", kind="error", err=errno.ENOSPC,
                          count=-1, at_byte=point)]
    if fault == "fsync":
        return [FaultSpec.fsync_error(count=-1)]
    if fault == "kill":
        return [FaultSpec.kill_at(point)]
    return []


def _open_device(device):
    """Open ``device`` and load the write path's kernels: one call of each
    host entry on a few values (the CUDA context, the libraries and their
    modules load here, not inside a fill), then zero the counts."""
    dev = ops.resolve_device(device)
    offsets_scan_host(np.ones(4, dtype=np.int64), dev)
    byteshuffle_pages_host(np.zeros((1, 16, 4), dtype=np.uint8), dev)
    ops.reset_launch_counts()
    return dev


def _mp_exit(conn, code: int):
    """Send this process's launch counts to the parent, then exit."""
    conn.send(("exit", ops.launch_counts()))
    conn.close()
    os._exit(code)


def _mp_chaos_worker(path, entries, fault, point, device, conn, t_start,
                     env):
    """Child: join the shared container with an injected fault.

    Takes the parent's ``REPRO_TORCH_*`` variables ``env`` (the fork
    server's environment is the one it started with), then sends
    ``("ready", seconds since its start)`` once its device and
    kernels are loaded, and joins only at the parent's ``("go",)`` (the
    rendezvous starts then); a straggler also sends ``("flushed",)`` after
    its first ``flush_cluster``, and every child its launch counts before
    it exits.

    Exit codes: 0 clean DONE; 2 poisoned (fault surfaced, no DONE);
    3 process-killed mid-write; 4 fenced straggler correctly refused;
    5 fencing VIOLATED (a fenced writer's commit went through).
    """
    for k in [k for k in os.environ if k.startswith(ENV_PREFIX)]:
        del os.environ[k]
    os.environ.update(env)
    dev = _open_device(device)
    conn.send(("ready", time.time() - t_start))
    try:
        if conn.recv() != ("go",):
            os._exit(1)
    except EOFError:  # the parent abandoned this cell
        os._exit(1)
    fs = FaultInjectingSink(open_sink(path, create=False),
                            _mp_fault_specs(fault, point))
    try:
        w = join_container(path, schema=SCHEMA, options=_mp_options(),
                           sink=fs, device=dev)
        ctx = w.create_fill_context()
        if fault == "straggler":
            half = len(entries) // 2
            for e in entries[:half]:
                ctx.fill(e)
            ctx.flush_cluster()
            conn.send(("flushed",))
            time.sleep(point)  # sleep past the rendezvous deadline
            try:
                for e in entries[half:]:
                    ctx.fill(e)
                ctx.flush_cluster()
                _mp_exit(conn, 5)  # must be unreachable: we were fenced
            except (FencedError, RuntimeError, OSError):
                _mp_exit(conn, 4)
        for e in entries:
            ctx.fill(e)
        ctx.close()
        w.close()
    except ProcessKilled:
        _mp_exit(conn, 3)
    except (OSError, RuntimeError):
        _mp_exit(conn, 2)
    _mp_exit(conn, 0)


def _mp_expect(conn, what: str, proc):
    """Wait for message ``what`` from a child (it may take its start-up);
    -> the message."""
    if not conn.poll(CHILD_START_S):
        raise AssertionError(f"a participant sent no {what!r} within "
                             f"{CHILD_START_S} s")
    try:
        msg = conn.recv()
    except EOFError:
        proc.join()
        raise AssertionError(f"a participant exited ({proc.exitcode}) "
                             f"before {what!r}") from None
    assert msg[0] == what, f"a participant sent {msg!r}, not {what!r}"
    return msg


def _forkserver():
    """The participants' start method: a fork server with this module
    imported.  The server imports it on the path of its environment, so it
    starts here with the package's root on ``PYTHONPATH``."""
    from multiprocessing import forkserver

    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["repro_torch.launch.chaos"])
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    old = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join([root] + ([old] if old else []))
    try:
        forkserver.ensure_running()
    finally:
        if old is None:
            del os.environ["PYTHONPATH"]
        else:
            os.environ["PYTHONPATH"] = old
    return ctx


def stop_forkserver() -> None:
    """Stop the fork server of the participants, if one runs."""
    from multiprocessing import forkserver

    forkserver._forkserver._stop()


def _load_parent_kernels(device) -> None:
    """Build and load every kernel library in the parent, once, before
    any child starts: the children then only load them (N children would
    otherwise race one build)."""
    if ops.resolve_device(device).type == "cuda":
        _build.library("scans")


class _Cell:
    """One multi-process cell: a container with its coordinator, and one
    participant process per slice, started at once; the participants join
    at :meth:`go`.  ``fault`` is one kind for every writer, or a
    per-writer list."""

    def __init__(self, entries, n_writers, fault, point, device):
        self.tmp = tempfile.TemporaryDirectory(prefix="rntj-chaos-")
        self.path = os.path.join(self.tmp.name, "mp.rntj")
        chunk = (len(entries) + n_writers - 1) // n_writers
        self.slices = [entries[w * chunk: (w + 1) * chunk]
                       for w in range(n_writers)]
        self.faults = (fault if isinstance(fault, list)
                       else [fault] * n_writers)
        _load_parent_kernels(device)
        self.coord = MultiWriterCoordinator(SCHEMA, self.path, _mp_options())
        ctx = _forkserver()
        env = {k: v for k, v in os.environ.items()
               if k.startswith(ENV_PREFIX)}
        self.procs, self.conns = [], []
        for s, f in zip(self.slices, self.faults):
            r, w = ctx.Pipe()
            p = ctx.Process(target=_mp_chaos_worker, args=(
                self.path, s, f, point, str(device), w, time.time(), env))
            p.start()
            w.close()  # the child holds the only other end: EOF once gone
            self.procs.append(p)
            self.conns.append(r)

    def go(self) -> None:
        """Wait until every child is ready, then let them join."""
        for p, c in zip(self.procs, self.conns):
            CHILD_READY_S.append(_mp_expect(c, "ready", p)[1])
        for c in self.conns:
            c.send(("go",))

    def finish(self) -> list:
        """Join the children, add their launch counts; -> exit codes."""
        for p, c in zip(self.procs, self.conns):
            p.join(CHILD_RUN_S)
            if p.is_alive():
                raise AssertionError(
                    f"a participant ran past {CHILD_RUN_S} s")
            try:
                while c.poll():
                    msg = c.recv()
                    if msg[0] == "exit":
                        for k, v in msg[1].items():
                            CHILD_LAUNCHES[k] = CHILD_LAUNCHES.get(k, 0) + v
            except EOFError:
                pass
            c.close()
        return [p.exitcode for p in self.procs]

    def abandon(self) -> None:
        """Stop the children and drop the container unsealed."""
        for p in self.procs:
            p.kill()
            p.join()
        for c in self.conns:
            c.close()
        self.coord.sink.close()
        self.coord.log.close()
        self.tmp.cleanup()


def _mp_run_cell(cell: _Cell, device, rendezvous_timeout=None):
    """Run one matrix cell: the children join, the coordinator seals;
    returns (salvaged entries in file order, per-writer slices, exitcodes,
    report, container path, tmpdir handle)."""
    try:
        cell.go()
        for p, c, f in zip(cell.procs, cell.conns, cell.faults):
            if f == "straggler":  # its late write comes after the seal
                _mp_expect(c, "flushed", p)
        report = cell.coord.seal(expect_writers=len(cell.procs),
                                 timeout=rendezvous_timeout)
        cell.coord.close()
        exitcodes = cell.finish()
    except BaseException:
        cell.abandon()
        raise
    r = RNTJReader(cell.path, device=device)
    got = list(r.iter_entries())
    r.close()
    return got, cell.slices, exitcodes, report, cell.path, cell.tmp


def _mp_check_cell(got, slices, exitcodes, label, device):
    """The salvage contract for one cell: every clean writer's entries are
    all present; a crashed writer's surviving entries are a prefix of what
    it wrote; every salvaged entry is byte-identical to its source."""
    by_id = {e["id"]: e for s in slices for e in s}
    for e in got:
        assert e == by_id[e["id"]], f"{label}: salvaged entry differs"
    ids = [e["id"] for e in got]
    assert len(ids) == len(set(ids)), f"{label}: duplicate salvaged entries"
    for w, s in enumerate(slices):
        mine = [e for e in got if e["id"] in {x["id"] for x in s}]
        if exitcodes[w] == 0:
            assert mine == s, (
                f"{label}: clean writer {w} lost "
                f"{len(s) - len(mine)} of {len(s)} entries")
        else:
            assert mine == s[: len(mine)], (
                f"{label}: writer {w} salvage is not a prefix of its commits")
    # byte-level check: the salvaged set re-written single-writer must
    # decode identically (same codec path, same framing semantics)
    ref = MemorySink()
    write_through(ref, got, device, cluster_bytes=2048)
    rr = RNTJReader(ref, device=device)
    assert list(rr.iter_entries()) == got, (
        f"{label}: salvaged decode differs from single-writer reference")
    rr.close()


#: the crash matrix: (writers, fault, point) — points straddle the commit
#: stream: before the first cluster lands (total loss), mid-stream
#: (partial salvage), past the end (no fault fires — clean)
MP_CELLS = tuple(
    cell for n in (2, 4) for cell in (
        [(n, fault, 0) for fault in ("eio", "torn", "fsync")]
        + [(n, fault, point) for fault in ("enospc", "kill")
           for point in (900, 1400, 3000)]))
#: the straggler's cell: 2 writers, one of which sleeps this many seconds
#: after its first cluster, against a rendezvous timeout of a second
STRAGGLER = (2, ["none", "straggler"], 3)
#: cells whose participants start ahead of their turn (the current one
#: included): a participant's start-up (interpreter, torch, the device, the
#: kernels) takes seconds, a cell's run a fraction of one
MP_AHEAD = 4


def mp_cell(entries, n, fault, point, device, cell=None):
    """One cell of the crash matrix (its participants already started in
    ``cell``, or started here), run and held to its invariants; -> its
    row of ``scenario_mpkill``'s matrix."""
    label = f"mpkill[N={n},{fault},@{point}]"
    cell = cell or _Cell(entries[: 160 * n], n, fault, point, device)
    got, slices, codes, report, path, tmp = _mp_run_cell(cell, device)
    with tmp:
        _mp_check_cell(got, slices, codes, label, device)
        if fault in ("eio", "torn"):  # retried to success: zero loss
            assert codes == [0] * n, f"{label}: {codes}"
            assert not report["fenced"], f"{label}: {report}"
        if fault == "fsync":  # fsync poison: DONE withheld, fenced
            assert all(c != 0 for c in codes), f"{label}: {codes}"
            assert len(report["fenced"]) == n, f"{label}: {report}"
        # a degraded seal keeps the side-car; cross-check recovery's
        # view of the sealed file (footer must already be valid)
        rep = recover_container(path, dry_run=True)
        assert rep.footer_valid, f"{label}: sealed footer invalid"
        verify_device(path, label, device)
    return (f"N={n}", fault, point, len(got),
            {"codes": codes, "fenced": report["fenced"]})


def mp_straggler(entries, device, cell=None):
    """The fencing invariant: a straggler fenced mid-rendezvous can never
    corrupt what the seal committed; -> its row of the matrix."""
    cell = cell or _Cell(entries[:320], *STRAGGLER, device)
    got, slices, codes, report, path, tmp = _mp_run_cell(
        cell, device, rendezvous_timeout=1.0)
    with tmp:
        sealed = got
        assert codes[0] == 0 and codes[1] == 4, (
            f"straggler: exit codes {codes} (4 = fenced write refused)")
        assert len(report["fenced"]) == 1, f"straggler: {report}"
        r = RNTJReader(path, device=device)  # AFTER the late attempt
        assert list(r.iter_entries()) == sealed, (
            "straggler: sealed entries changed after a fenced write")
        r.close()
        rep = recover_container(path, dry_run=True)
        assert rep.footer_valid, "straggler: footer damaged by fenced writer"
        verify_device(path, "straggler", device)
    return ("N=2", "straggler", STRAGGLER[2], len(sealed),
            {"codes": codes, "fenced": report["fenced"]})


def scenario_mpkill(entries, seed, device):
    """N-process × kill-point × fault-type crash matrix through real
    worker processes sharing one container file.  The cells run one after
    another in the reference's order; the participants of the next
    ``MP_AHEAD - 1`` cells start while one runs."""
    runs = [(mp_cell, (entries, n, fault, point, device),
             (entries[: 160 * n], n, fault, point))
            for n, fault, point in MP_CELLS]
    runs.append((mp_straggler, (entries, device),
                 (entries[:320],) + STRAGGLER))
    started, results = [], []
    try:
        for i, (run_cell, args, _start) in enumerate(runs):
            while len(started) < min(i + MP_AHEAD, len(runs)):
                started.append(_Cell(*runs[len(started)][2], device))
            results.append(run_cell(*args, cell=started[i]))
    finally:
        for cell in started[len(results) + 1:]:
            cell.abandon()
    return {"cells": len(results), "matrix": results}


def scenario_mprecover(entries, seed, device):
    """Coordinator dies mid-rendezvous (no footer): recover_container
    rebuilds the file from the journal + side-car log alone."""
    n = 2
    cell = _Cell(entries, n, "none", 0, device)
    with cell.tmp:
        try:
            cell.go()
            codes = cell.finish()
        except BaseException:
            cell.abandon()
            raise
        assert codes == [0, 0], f"mprecover: exit codes {codes}"
        # coordinator "crashes" here: no seal, no footer — just drop it
        cell.coord.sink.close()
        cell.coord.log.close()
        path, slices = cell.path, cell.slices
        rep = recover_container(path)
        assert not rep.footer_valid, "unsealed file cannot have a footer"
        assert rep.multiwriter is not None, "side-car state not consulted"
        r = RNTJReader(path, device=device)
        got = list(r.iter_entries())
        r.close()
        assert sorted(e["id"] for e in got) == sorted(
            e["id"] for s in slices for e in s), "recovery lost entries"
        by_id = {e["id"]: e for s in slices for e in s}
        assert all(e == by_id[e["id"]] for e in got), "recovered entry differs"
        verify_device(path, "mprecover", device)
        return {"writers": n, "recovered": len(got),
                "clusters": rep.clusters_salvaged}


def scenario_remote(entries, seed, device):
    """The object-store cell matrix: every remote failure mode in one run."""
    ROPTS = RemoteOptions(part_bytes=1024, retry_policy=POLICY)

    def remote_write(transport, entries, **kw):
        s = ObjectStoreSink(transport, "chaos.rntj", ROPTS)
        return s, write_through(s, entries, device, **kw)

    def remote_verify(bucket, entries, label):
        verify_lossless(
            ObjectStoreSink(FakeTransport(bucket), "chaos.rntj",
                            create=False),
            entries, label, device)

    info = {}

    # cell: clean multipart is byte-identical to the local reference
    ms = MemorySink()
    write_through(ms, entries, device)
    ref = bytes(ms.buf[: ms.size])
    ms.close()
    t = FakeTransport(ObjectBucket())
    s, w = remote_write(t, entries)
    s.close()
    assert t.bucket.objects["chaos.rntj"] == ref, "remote bytes differ"
    assert w.stats.as_dict()["io_retries"] == 0
    info["object_bytes"] = len(ref)

    # cell: scripted transient part/put faults are retried, zero loss
    sched = FaultSchedule([
        FaultSpec.transient_error(op="part", count=3),
        FaultSpec(op="part", kind="short", count=1, fraction=0.5),
    ])
    t = FakeTransport(ObjectBucket(), schedule=sched)
    s, w = remote_write(t, entries)
    s.close()
    d = w.stats.as_dict()
    assert d["io_retries"] >= 4, f"transport retries: {d['io_retries']}"
    assert d["io_degradations"] == 0
    assert t.bucket.objects["chaos.rntj"] == ref
    info["transient_retries"] = d["io_retries"]

    # cell: seeded random transport faults — same seed, same schedule.
    # Transport ops are per-part (far fewer than per-pwrite), so a tiny
    # --entries workload is padded and the rate is high enough that the
    # schedule fires for any seed with near certainty.
    seeded_entries = entries
    if len(seeded_entries) < 2000:
        seeded_entries = entries + make_entries(2000 - len(entries),
                                                seed + 1)
    sched = FaultSchedule(seed=seed, error_rate=0.35,
                          errnos=(errno.EIO, errno.ETIMEDOUT),
                          random_ops=("put", "part", "get"))
    t = FakeTransport(ObjectBucket(), schedule=sched)
    s, w = remote_write(t, seeded_entries)
    s.close()
    d = w.stats.as_dict()
    assert sched.stats.random_errors >= 1, "seeded schedule injected nothing"
    assert d["io_retries"] + d["io_degradations"] >= 1
    remote_verify(t.bucket, seeded_entries, "remote-seeded")
    info["seeded_injected"] = sched.stats.random_errors

    # cell: torn ranged GETs + reader-level retry policy
    sched = FaultSchedule([
        FaultSpec.short_read(op="get", count=2, fraction=0.5),
        FaultSpec.transient_error(op="get", count=2),
    ])
    bkt = ObjectBucket()
    bkt.objects["chaos.rntj"] = ref
    rs = ObjectStoreSink(FakeTransport(bkt, schedule=sched), "chaos.rntj",
                         RemoteOptions(retry_policy=POLICY), create=False)
    r = RNTJReader(rs, options=ReadOptions(retry_policy=POLICY),
                   device=device)
    got = list(r.iter_entries())
    r.close()
    assert got == entries, "torn/faulty GETs lost entries"
    d = r.stats.as_dict()
    assert d["io_retries"] >= 2, "transport-level read retries not counted"
    info["read_retries"] = d["io_retries"]

    # cell: hedged slow tail — scripted latency on the first GET only
    sched = FaultSchedule([FaultSpec.latency(0.2, op="get", count=1)])
    bkt = ObjectBucket()
    bkt.objects["chaos.rntj"] = ref
    rs = ObjectStoreSink(FakeTransport(bkt, schedule=sched), "chaos.rntj",
                         RemoteOptions(retry_policy=POLICY, hedge_ms=10),
                         create=False)
    r = RNTJReader(rs, device=device)
    got = list(r.iter_entries())
    r.close()
    assert got == entries
    d = r.stats.as_dict()
    assert d["io_hedges"] >= 1 and d["io_hedge_wins"] >= 1, (
        f"hedge did not win the race: {d['io_hedges']}/{d['io_hedge_wins']}")
    info["hedge_wins"] = d["io_hedge_wins"]

    # cell: permanent part failure degrades multipart -> serial put
    sched = FaultSchedule([FaultSpec.permanent_error(op="part")])
    t = FakeTransport(ObjectBucket(), schedule=sched)
    s, w = remote_write(t, entries)
    s.close()
    d = w.stats.as_dict()
    assert d["io_degradations"] >= 1, "degradation not counted"
    assert t.bucket.objects["chaos.rntj"] == ref, "degraded put lost bytes"
    info["degradations"] = d["io_degradations"]

    # cell: writer killed mid-multipart -> salvage the interrupted upload
    sched = FaultSchedule([FaultSpec(op="part", kind="kill", at_call=4)])
    bkt = ObjectBucket()
    s = ObjectStoreSink(FakeTransport(bkt, schedule=sched), "chaos.rntj",
                        ROPTS)
    killed = False
    try:
        write_through(s, entries, device, cluster_bytes=2048)
    except (ProcessKilled, RuntimeError):
        killed = True
    s.close()
    assert killed, "kill point never fired"
    assert "chaos.rntj" not in bkt.objects
    rep = salvage_remote(FakeTransport(bkt), "chaos.rntj")
    assert rep.remote["mode"] == "multipart"
    assert rep.rebuilt and rep.entries_salvaged > 0
    r = RNTJReader(ObjectStoreSink(FakeTransport(bkt), "chaos.rntj",
                                   create=False), device=device)
    got = list(r.iter_entries())
    r.close()
    assert got == entries[: len(got)], "salvaged entries differ"
    assert len(got) == rep.entries_salvaged
    verify_device(ObjectStoreSink(FakeTransport(bkt), "chaos.rntj",
                                  create=False), "remote salvage", device)
    info["salvaged_entries"] = rep.entries_salvaged
    return info


SCENARIOS = {
    "transient": scenario_transient,
    "seeded": scenario_seeded,
    "enospc": scenario_enospc,
    "fsync": scenario_fsync,
    "stripe": scenario_stripe,
    "ring": scenario_ring,
    "latency": scenario_latency,
    "kill": scenario_kill,
    "skim": scenario_skim,
    "mpkill": scenario_mpkill,
    "mprecover": scenario_mprecover,
    "remote": scenario_remote,
}


def run(name: str, entries, seed: int, device="cuda"):
    """Scenario ``name`` on ``device`` (resolved first: without a card and
    without ``device="cpu"`` this raises before any writer exists, so no
    scenario can take the refusal for an injected fault); -> its info."""
    return SCENARIOS[name](list(entries), seed, ops.resolve_device(device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="RNT-J chaos scenarios")
    ap.add_argument("--scenario", default="all",
                    choices=["all"] + sorted(SCENARIOS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--entries", type=int, default=800)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: needs a card) or cpu")
    args = ap.parse_args(argv)

    device = ops.resolve_device(args.device)
    names = sorted(SCENARIOS) if args.scenario == "all" else [args.scenario]
    entries = make_entries(args.entries, args.seed)
    failed = []
    for name in names:
        try:
            info = run(name, entries, args.seed, device)
        except AssertionError as e:
            print(f"FAIL {name}: {e}", flush=True)
            failed.append(name)
            continue
        print(f"ok   {name}: {info}", flush=True)
    if failed:
        print(f"{len(failed)} scenario(s) failed: {', '.join(failed)}")
        return 1
    print(f"all {len(names)} scenario(s) held their invariants")
    return 0


if __name__ == "__main__":
    sys.exit(main())
