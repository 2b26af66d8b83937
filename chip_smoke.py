#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's write -> read path on one NVIDIA card.

    python3 chip_smoke.py [--entries 1000000] [--producers 4] [--seed 0]
                          [--profile DIR]

Phases, in order; any failure exits non-zero:

1. the card (``nvidia-smi`` name and power limit) and the build of every
   CUDA kernel from ``src/repro_torch/csrc`` (nvcc, one per source);
2. every kernel against its plain PyTorch version on the card, bit for
   bit, at ragged shapes and at the paper configuration's page shapes;
3. the main path: the paper's configuration written by ``ParallelWriter``
   on the card (``--producers`` threads, ``--entries`` each, fill batches
   of 100,000), read back with ``RNTJReader.iter_clusters_device``, every
   column checked against the generated data and the reader's host
   decode; the launch counts of all four kernels must be > 0; then one
   producer's data written once with the kernels and once with the numpy
   backend: the files must be byte-identical;
4. each kernel timed at the shape the main path gave it most often: on
   the card (CUDA events between 30 launches queued back to back) and
   per call with its host overhead, beside its bound, its plain version
   and, where one exists, the one PyTorch call computing the same
   function; the host entries of K1 and K2 with their PCIe copies; one
   JSON ``kernels`` line;
5. the last line: ``{"ok": true, "device": {...}}``.

``--profile DIR`` also traces one read-back and one single-producer
write with torch.profiler (the card's busy share; chrome traces in DIR).
Needs a CUDA card and the repository's ``src/`` beside this file.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM memory rate and peak integer/float32 rate outside the tensor
#: cores (NVIDIA data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

BATCH = 100_000

KERNEL_INFO = {
    "offsets_scan": ("src/repro_torch/csrc/scans.cu",
                     "src/repro/kernels/offsets_scan.py:42"),
    "byteshuffle_pages": ("src/repro_torch/csrc/byteplanes.cu",
                          "src/repro/kernels/byteshuffle.py:51"),
    "unsplit_pages": ("src/repro_torch/csrc/byteplanes.cu",
                      "src/repro/kernels/decode_pages.py:46"),
    "decode_offset_pages": ("src/repro_torch/csrc/scans.cu",
                            "src/repro/kernels/decode_pages.py:97"),
}


def fail(msg: str) -> "NoReturn":
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# inputs of each kernel, made on the card from a seed


def kernel_input(torch, name: str, shape, gen):
    """A realistic input of ``shape`` for kernel ``name`` on the card."""
    dev = "cuda"
    if name == "offsets_scan":
        (n,) = shape
        return torch.poisson(torch.full((n,), 5.0, device=dev),
                             generator=gen).to(torch.int64)
    if name == "decode_offset_pages":
        n_pages, _, per = shape
        # end offsets uniform below 2**31 (the writer's first delta of a
        # page is such an absolute offset): the signed per-page deltas
        # fill all four low bytes at every position; zigzag, then the
        # uint64 byte planes of each page (planes 4..7 stay zero)
        ends = torch.randint(0, 2**31, (n_pages, per), dtype=torch.int64,
                             device=dev, generator=gen)
        d = ends.diff(dim=1, prepend=torch.zeros_like(ends[:, :1]))
        zz = (d << 1) ^ (d >> 63)
        b = zz.view(torch.uint8).reshape(n_pages, per, 8)
        return b.transpose(1, 2).contiguous()
    return torch.randint(0, 256, tuple(shape), dtype=torch.uint8, device=dev,
                         generator=gen)


def kernel_fns(kernels):
    """name -> (kernel wrapper, plain version, library call or None).

    The plain versions of K1-K3 are each one PyTorch call, named here:
    their time is the library call's time.  K4 has no such call."""
    from repro_torch.kernels import ref

    return {
        "offsets_scan": (kernels.offsets_scan.offsets_scan,
                         ref.offsets_scan_ref, "torch.cumsum"),
        "byteshuffle_pages": (kernels.byteshuffle.byteshuffle_pages,
                              ref.byteshuffle_pages_ref,
                              "transpose(1, 2).contiguous()"),
        "unsplit_pages": (kernels.decode_pages.unsplit_pages,
                          ref.unsplit_pages_ref,
                          "transpose(1, 2).contiguous()"),
        "decode_offset_pages": (kernels.decode_pages.decode_offset_pages,
                                ref.decode_offset_pages_ref, None),
    }


def bound(name: str, shape):
    """(bound_ms, bound_by, bytes) of one launch: each input byte read
    once, each output byte written once, over the memory rate; the
    operations over the scalar rate; the larger of the two."""
    if name == "offsets_scan":
        (n,) = shape
        nbytes, ops = 16 * n, n
    elif name == "decode_offset_pages":
        p, _, per = shape
        # the low four planes are all the function needs; int32 out
        nbytes, ops = 4 * p * per + 4 * p * per, 8 * p * per
    else:
        p, a, b = shape
        nbytes, ops = 2 * p * a * b, 0
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes)


def max_abs_err(torch, a, b) -> float:
    if a.shape != b.shape or a.dtype != b.dtype:
        return float("inf")
    return float((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) \
        if a.numel() else 0.0


def call_ms(torch, fn, x, reps: int = 30, warmup: int = 5) -> float:
    """Median over ``reps`` calls of the host clock around one call and a
    synchronize: what one call costs its caller, host overhead included."""
    for _ in range(warmup):
        fn(x)
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(x)
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def device_ms(torch, fn, x, host_ms: float, reps: int = 30) -> float:
    """Median over ``reps`` launches of the card's time for one call.

    The launches queue behind a sleep kernel that outlasts their enqueue,
    so the card runs them back to back and the CUDA events between them
    time the kernels, not the host's rate of launching them."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda.synchronize()
    # >= 2e6 cycles per ms at the H100's clocks: sleep for 3x the enqueue
    torch.cuda._sleep(int(2e6 * (3 * host_ms * reps + 2)))
    t0 = time.perf_counter()
    for i in range(reps):
        events[i].record()
        fn(x)
    events[reps].record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    if enqueue_ms > 2 * host_ms * reps + 1:
        fail(f"enqueue ({enqueue_ms:.3f} ms) outlasted the sleep: the "
             "device timing would measure the host")
    return statistics.median(events[i].elapsed_time(events[i + 1])
                             for i in range(reps))


# ---------------------------------------------------------------------------
# phase 2: every kernel against its plain version


def check_kernels(torch, kernels, shapes) -> None:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    fns = kernel_fns(kernels)
    for name, shape_list in shapes.items():
        kern, plain, _ = fns[name]
        for shape in shape_list:
            x = kernel_input(torch, name, shape, gen)
            got = kern(x)
            torch.cuda.synchronize()
            want = plain(x)
            err = max_abs_err(torch, got, want)
            if err != 0.0:
                fail(f"{name} at {tuple(shape)} differs from its plain "
                     f"version (max abs err {err})")
        log(f"kernel {name}: bit-identical to its plain version at "
            f"{len(shape_list)} shapes")


def ragged_shapes():
    return {
        # 1 tile, a ragged tile, several tiles, > 256 tiles (pass 2 loops)
        "offsets_scan": [(1,), (4095,), (4097,), (100_000,), (1_100_003,)],
        # the paper config's page shapes, plus ragged and odd `per`
        "byteshuffle_pages": [(36, 8192, 8), (91, 16384, 4), (3, 1000, 8),
                              (2, 777, 4), (5, 4099, 2), (2, 33, 1),
                              (1, 16384, 4)],
        "unsplit_pages": [(91, 4, 16384), (3, 8, 1000), (2, 4, 777),
                          (5, 2, 4099), (2, 1, 33), (36, 8, 8192)],
        "decode_offset_pages": [(36, 8, 8192), (1, 8, 8192), (3, 8, 1000),
                                (2, 8, 1027), (4, 8, 2)],
    }


# ---------------------------------------------------------------------------
# phase 3: the main path


def make_data(np, seed: int, producers: int, entries: int):
    """Per producer: ids, collection sizes and float32 values (bulk)."""
    data = []
    for p in range(producers):
        rng = np.random.default_rng([seed, p])
        sizes = rng.poisson(5, entries).astype(np.int64)
        vals = rng.standard_normal(int(sizes.sum()), dtype=np.float32)
        ids = np.arange(p * entries, (p + 1) * entries, dtype=np.int64)
        data.append((ids, sizes, vals, np.cumsum(sizes)))
    return data


def batches(core, schema, item):
    ids, sizes, vals, ends = item
    for s in range(0, len(ids), BATCH):
        e = min(s + BATCH, len(ids))
        a = 0 if s == 0 else int(ends[s - 1])
        yield core.ColumnBatch.from_arrays(schema, e - s, {
            "id": ids[s:e], "vals": sizes[s:e], "vals._0": vals[a:int(ends[e - 1])],
        })


def write_parallel(core, schema, opts, path, data):
    """-> (seconds, writer stats) of the multi-producer write."""
    errors = []
    with core.ParallelWriter(schema, path, opts, device="cuda") as w:
        def producer(item):
            try:
                ctx = w.create_fill_context()
                for b in batches(core, schema, item):
                    ctx.fill_batch(b)
                ctx.close()
            except BaseException as e:  # re-raised on the main thread
                errors.append(e)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=producer, args=(item,))
                   for item in data]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    dt = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return dt, w.stats


def check_read_back(np, torch, core, path, data, entries: int):
    """Read back through the device decode chain; every column must equal
    the generated data."""
    schema = None
    n_seen = 0
    t0 = time.perf_counter()
    with core.RNTJReader(path, device="cuda", options=core.ReadOptions(
            prefetch_clusters=2)) as r:
        schema = r.schema
        i_id = schema.column_of_path["id"]
        i_off = schema.column_of_path["vals"]
        i_val = schema.column_of_path["vals._0"]
        for i, cols in r.iter_clusters_device():
            if not isinstance(cols[i_id], np.ndarray):
                fail("the 8-byte id column did not take the host fallback")
            for ci in (i_off, i_val):
                if not (torch.is_tensor(cols[ci]) and cols[ci].is_cuda):
                    fail(f"column {ci} did not decode on the card")
            ids = cols[i_id]
            p, s = divmod(int(ids[0]), entries)
            n = len(ids)
            g_ids, g_sizes, g_vals, g_ends = data[p]
            if not np.array_equal(ids, g_ids[s:s + n]):
                fail(f"cluster {i}: ids differ")
            base = 0 if s == 0 else int(g_ends[s - 1])
            want_off = g_ends[s:s + n] - base
            got_off = cols[i_off].cpu().numpy()
            if got_off.dtype != np.int32 or not np.array_equal(
                    got_off.astype(np.int64), want_off):
                fail(f"cluster {i}: offsets differ")
            got_val = cols[i_val].cpu().numpy()
            if not np.array_equal(got_val, g_vals[base:int(g_ends[s + n - 1])]):
                fail(f"cluster {i}: values differ")
            n_seen += n
        dt = time.perf_counter() - t0
        stats = r.stats
        n_clusters = r.n_clusters
    if n_seen != len(data) * entries:
        fail(f"read back {n_seen} entries of {len(data) * entries}")
    return dt, stats, n_clusters


def check_host_decode(np, torch, core, path) -> None:
    """The reader's own host decode agrees with its device decode on the
    first and the last cluster."""
    with core.RNTJReader(path, device="cuda") as r:
        for i in (0, r.n_clusters - 1):
            host = r.read_cluster(i)
            dev = r.read_cluster_device(i)
            for ci, arr in dev.items():
                a = arr.cpu().numpy() if torch.is_tensor(arr) else arr
                if not np.array_equal(a.astype(host[ci].dtype), host[ci]):
                    fail(f"cluster {i} column {ci}: device != host decode")


def write_single(core, schema, opts, path, item, backend: str) -> float:
    old = os.environ.get("REPRO_TORCH_KERNEL_BACKEND")
    os.environ["REPRO_TORCH_KERNEL_BACKEND"] = backend
    try:
        t0 = time.perf_counter()
        with core.SequentialWriter(schema, path, opts, device="cuda") as w:
            for b in batches(core, schema, item):
                w.fill_batch(b)
        return time.perf_counter() - t0
    finally:
        if old is None:
            os.environ.pop("REPRO_TORCH_KERNEL_BACKEND", None)
        else:
            os.environ["REPRO_TORCH_KERNEL_BACKEND"] = old


def profile(torch, core, schema, opts, path, item, out_dir) -> None:
    """Trace one device read-back and one single-producer write: the
    card's busy time (the union of its kernels' and copies' intervals)
    against the wall clock, and the device work that took it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    os.makedirs(out_dir, exist_ok=True)

    def read():
        with core.RNTJReader(path, device="cuda", options=core.ReadOptions(
                prefetch_clusters=2)) as r:
            for _i, _cols in r.iter_clusters_device():
                pass

    def write():
        with core.SequentialWriter(schema, path + ".prof", opts,
                                   device="cuda") as w:
            for b in batches(core, schema, item):
                w.fill_batch(b)

    for name, fn in (("read", read), ("write", write)):
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        busy_us, end = 0.0, float("-inf")
        for a, b in spans:  # union of the device intervals
            if b > end:
                busy_us += b - max(a, end)
                end = b
        busy_ms = busy_us / 1e3
        log(f"profile {name}: wall {wall_ms:.3f} ms, card busy "
            f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.3f} %), idle "
            f"{100 - 100 * busy_ms / wall_ms:.3f} %")
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                t, c = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
        for key, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
            log(f"  {key[:60]}: {t / 1e3:.3f} ms over {c} calls")
        prof.export_chrome_trace(os.path.join(out_dir, f"trace_{name}.json"))
    os.remove(path + ".prof")


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--entries", type=int, default=1_000_000,
                    help="entries per producer")
    ap.add_argument("--producers", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also trace one read-back and one single-producer "
                         "write with torch.profiler; chrome traces go to DIR")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device: this script measures the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        import repro_torch.kernels as kernels
        from repro_torch import core
        from repro_torch.configs.rntj_writer import (
            PAPER_WRITE_OPTIONS, SYNTH_EVENT_SCHEMA,
        )
        from repro_torch.kernels import _build, ops
    except ImportError as e:
        print(f"FAIL: the repository's src/repro_torch is missing: {e}",
              file=sys.stderr)
        return 2

    # -- phase 1: the card and the build ------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device 0: {kind}")
    t0 = time.perf_counter()
    for lib in _build.SIGNATURES:  # the first one builds them all
        _build.library(lib)
    log(f"build and load: {time.perf_counter() - t0:.3f} s into "
        f"{_build.build_dir()}")

    # -- phase 2: kernels against their plain versions ----------------------
    check_kernels(torch, kernels, ragged_shapes())

    # -- phase 3: the main path ---------------------------------------------
    data = make_data(np, args.seed, args.producers, args.entries)
    raw_bytes = sum(len(ids) * 16 + len(vals) * 4
                    for ids, _s, vals, _e in data)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    path = os.path.join(tmp, "paper.rntj")
    ops.reset_launch_counts()
    w_s, wstats = write_parallel(core, SYNTH_EVENT_SCHEMA,
                                 PAPER_WRITE_OPTIONS, path, data)
    r_s, rstats, n_clusters = check_read_back(np, torch, core, path, data,
                                              args.entries)
    # the main path's own launches: taken before any check launches more
    counts = ops.launch_counts()
    shapes = ops.launch_shapes()
    check_host_decode(np, torch, core, path)
    # a second read-back, unchecked: the device path once its CUDA
    # modules are loaded (the first pass pays their lazy loading)
    t0 = time.perf_counter()
    with core.RNTJReader(path, device="cuda", options=core.ReadOptions(
            prefetch_clusters=2)) as r:
        for _i, _cols in r.iter_clusters_device():
            pass
        r2 = r.stats
    r2_s = time.perf_counter() - t0
    file_mb = os.path.getsize(path) / 1e6
    log(f"main path: {args.producers} producers x {args.entries} entries, "
        f"{raw_bytes / 1e6:.3f} MB uncompressed, {file_mb:.3f} MB file, "
        f"{n_clusters} clusters; read back equal to the generated data "
        "and, on the first and last cluster, to the host decode")
    log(f"write: {w_s:.4f} s = {raw_bytes / 1e6 / w_s:.3f} MB/s; "
        f"read (device read-back + checks): {r_s:.4f} s = "
        f"{raw_bytes / 1e6 / r_s:.3f} MB/s")
    log("write phases (summed over threads, ms): " + json.dumps(
        {k: round(wstats.as_dict()[k], 3) for k in (
            "fill_ms", "seal_ms", "compress_ms", "commit_ms", "io_ms")}))
    log(f"read stats: h2d {rstats.h2d_ns / 1e6:.3f} ms over "
        f"{rstats.device_clusters} clusters, device decode "
        f"{rstats.decode_ns / 1e6:.3f} ms")
    log(f"second read-back: {r2_s:.4f} s = {raw_bytes / 1e6 / r2_s:.3f} MB/s; "
        f"h2d {r2.h2d_ns / 1e6:.3f} ms, device decode "
        f"{r2.decode_ns / 1e6:.3f} ms over {r2.device_clusters} clusters")
    log("second read-back phases (ms): " + json.dumps(
        {k: round(r2.as_dict()[k], 3) for k in (
            "io_ms", "decompress_ms", "h2d_ms", "decode_ms", "wait_ms")}))
    log(f"launches on the main path: {json.dumps(counts)}")
    for name in ops.KERNELS:
        log(f"  {name} shapes: "
            + ", ".join(f"{tuple(s)} x{c}" for s, c in shapes[name].most_common()))
    missing = [k for k in ops.KERNELS if counts[k] <= 0]
    if missing:
        fail(f"kernels not launched on the main path: {missing}")

    p_card = os.path.join(tmp, "single_card.rntj")
    p_numpy = os.path.join(tmp, "single_numpy.rntj")
    s_card = write_single(core, SYNTH_EVENT_SCHEMA, PAPER_WRITE_OPTIONS,
                          p_card, data[0], "auto")
    s_numpy = write_single(core, SYNTH_EVENT_SCHEMA, PAPER_WRITE_OPTIONS,
                           p_numpy, data[0], "numpy")
    with open(p_card, "rb") as f1, open(p_numpy, "rb") as f2:
        if f1.read() != f2.read():
            fail("single-producer files differ between the kernels and numpy")
    one_mb = (len(data[0][0]) * 16 + len(data[0][2]) * 4) / 1e6
    log(f"single producer: kernels {s_card:.4f} s ({one_mb / s_card:.3f} MB/s), "
        f"numpy {s_numpy:.4f} s ({one_mb / s_numpy:.3f} MB/s); files "
        "byte-identical")
    if args.profile:
        profile(torch, core, SYNTH_EVENT_SCHEMA, PAPER_WRITE_OPTIONS, path,
                data[0], args.profile)
    for f in (path, p_card, p_numpy):
        os.remove(f)
    os.rmdir(tmp)

    # -- phase 4: time every kernel at the main path's shapes ---------------
    gen = torch.Generator(device="cuda")
    gen.manual_seed(99)
    fns = kernel_fns(kernels)
    # every distinct shape the main path gave a kernel is checked too
    check_kernels(torch, kernels,
                  {k: list(shapes[k]) for k in ops.KERNELS})
    rows = []
    for name in ops.KERNELS:
        shape = shapes[name].most_common(1)[0][0]
        kern, plain, lib = fns[name]
        x = kernel_input(torch, name, shape, gen)
        got, want = kern(x), plain(x)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        if err != 0.0:
            fail(f"{name} at {shape} differs from its plain version")
        before = ops.launch_counts()[name]
        timed = {}
        for key, fn in (("", kern), ("plain_", plain)):
            c_ms = call_ms(torch, fn, x)
            timed[key + "call_ms"] = c_ms
            timed[key + "ms"] = device_ms(torch, fn, x, c_ms)
        ms, plain_ms = timed["ms"], timed["plain_ms"]
        lib_ms = plain_ms if lib else None  # the plain version IS that call
        b_ms, b_by, nbytes = bound(name, shape)
        assert ops.launch_counts()[name] > before  # the timing ran the kernel
        source, replaces = KERNEL_INFO[name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "library": lib, "shape": list(shape), "bytes": nbytes,
            "call_ms": timed["call_ms"], "plain_call_ms": timed["plain_call_ms"],
        })
        log(f"{name} at {shape}: card {ms:.5f} ms (bound {b_ms:.5f} ms by "
            f"{b_by}, plain {plain_ms:.5f} ms, library "
            f"{f'{lib_ms:.5f} ms ({lib})' if lib else 'none'}); per call "
            f"with host overhead {timed['call_ms']:.5f} ms (plain "
            f"{timed['plain_call_ms']:.5f} ms)")
    # the host entries of the seal path: numpy in, numpy out, PCIe both ways
    for name, entry, shape in (
            ("offsets_scan", kernels.offsets_scan.offsets_scan_host,
             shapes["offsets_scan"].most_common(1)[0][0]),
            ("byteshuffle_pages", kernels.byteshuffle.byteshuffle_pages_host,
             shapes["byteshuffle_pages"].most_common(1)[0][0])):
        x = kernel_input(torch, name, shape, gen).cpu().numpy()
        for _ in range(3):
            entry(x, torch.device("cuda"))
        ts = []
        for _ in range(20):
            t0 = time.perf_counter()
            entry(x, torch.device("cuda"))
            ts.append((time.perf_counter() - t0) * 1e3)
        med = statistics.median(ts)
        for r in rows:
            if r["name"] == name:
                r["host_entry_ms"] = med
        log(f"{name} host entry (H2D + kernel + D2H) at {shape}: "
            f"{med:.5f} ms median of 20")

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
