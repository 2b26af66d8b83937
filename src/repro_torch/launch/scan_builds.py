"""Time K1 (offsets scan), K7 (RWKV-6 wkv, bf16 inputs), K8 (Mamba-2
SSD, bf16 x), the codec kernels K2, K3, K4 and K9 and K5's backward (bf16)
as built from several source trees against each other on one card, in one
process.

    PYTHONPATH=src python -m repro_torch.launch.scan_builds \\
        [NAME=CSRC_DIR ...] [--rounds 3] [--only GROUP ...] [--out DIR]

Each ``NAME=CSRC_DIR`` is a copy of ``src/repro_torch/csrc`` (a parent
commit's, from ``git archive``, or an edited variant); the checkout's own
sources are always built as ``tree``.  Every tree's ``byteplanes.cu``,
``scans.cu``, ``ssm.cu`` and ``attention_bwd.cu`` compile together (nvcc,
one process each); the lines give the registers and spills of
``scan_lookback``, of ``ssd_chunked`` at N = 64, of ``wkv_chunked`` at Dk
= 64, of the codec kernels (K2's ``shuffle_reg`` or ``shuffle_vec``, K3's
``unsplit_reg`` or ``unsplit_vec``, K4's ``decode_offsets``) and of K5's
backward launches at D = 64 and 256, and ``ptxas``'s warnings that ``wgmma`` runs serialized.  The C
entry points are called directly, so a
tree's wrapper need not match this one's (K4's entry takes its cluster
geometry; a tree whose source declares the entry without it, the first
design's, is called without it); K1's workspace is zeroed and sized for slots of up to 32 bytes
a tile.  A variant of a kernel (one bf16 piece per operand instead of
two, a part taken out) is timed as an edited copy of the checkout's
``csrc``, one more tree.  ``--only`` picks groups: ``ssm`` (K7, K8 and
their backwards),
``k1``, ``codec``, ``bwd`` (K5's backward); all by default.

K7 runs at rwkv6-7b's prefill shape (16, 64, 1000, 64, 64) with bf16
inputs (a parent tree's K7 is its bf16 route, whatever its design) and K8
at zamba2-2.7b's (16, 80, 1000, 64, 64): each tree's output and final
state are held against the plain version and printed as the largest
share of ``SCAN_TOL`` they use (bf16 outputs 1e-2, final states 1e-4, as
``|got - want| / (tol (1 + |want|))``; above 1 misses it).  Their
backwards run with bf16 inputs and a final-state cotangent at the
training shapes ``BWD_SCAN_SHAPES`` (rwkv6-7b's and zamba2-2.7b's), each
tree with the workspace its own size query gives (printed), each
gradient as its share of 1e-2 against the plain version in fp32.  K1 runs at
100,000, 1,100,003 and 2^24 values beside ``torch.cumsum`` and must equal
it bit for bit.  The codec kernels run at the write -> read path's shapes
(K2 at its four seal shapes, K4 at its two read shapes, K3 at (91, 4,
16384)) and K9 at (250000, 8) and (2^24, 8), each tree's output bit for
bit against the plain version; beside K2 and K4 each tree's launch floor
(the same entry at (1, 16, 8) and (1, 8, 16)), and K2 and K4 once more
with the L2 cache flushed before every launch (a 128 MB buffer written
outside the timed events), as the write path's freshly uploaded pages
find it.  K5's backward runs causal at smollm-360m's and gemma-2b's
training shapes ``BWD_SHAPES`` on the output and rows' LSE of the checkout's K5 forward: a
tree whose entry takes the LSE as an input (``const void* lse`` after
``dout``) gets the forward's, an older one (the LSE a workspace after
``dv``) recomputes it; each tree's gradients are printed as the largest
share of the card's bf16 tolerance 1e-2 they use against
``ref.flash_attention_bwd_ref`` in fp32.  Times are card times (CUDA events between launches queued
behind a sleep kernel, median), the trees interleaved in ``--rounds``
rounds whose order alternates.  The last line is one JSON object of every
number.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import _build, ref

K7_SHAPE = (16, 64, 1000, 64, 64)  # (B, H, T, Dk, Dv)
K8_SHAPE = (16, 80, 1000, 64, 64)  # (B, H, T, P, N)
#: K7's and K8's backward: rwkv6-7b's and zamba2-2.7b's training shapes
BWD_SCAN_SHAPES = {"wkv": (8, 64, 1024, 64, 64),   # (B, H, T, Dk, Dv)
                   "ssd": (8, 80, 1024, 64, 64)}   # (B, H, T, P, N)
K1_SIZES = (100_000, 1_100_003, 1 << 24)
#: K5's backward: smollm-360m's and gemma-2b's training shapes (B, H, G,
#: S, D), causal
BWD_SHAPES = ((8, 15, 5, 1024, 64), (8, 8, 1, 1024, 256))
PTXAS_KERNELS = ("scan_lookback", "ssd_chunkedILi64", "wkv_chunkedILi64",
                 "ssd_bwd_localILi64", "ssd_bwd_chunkILi64",
                 "wkv_bwd_statesILi64", "wkv_bwd_chunksILi64",
                 "shuffle_reg", "shuffle_vec", "unsplit_reg", "unsplit_vec",
                 "decode_offsets",
                 "bwd_dq_wgmmaILi64", "bwd_dkv_wgmmaILi64",
                 "bwd_dq_wgmmaILi256", "bwd_dkv_wgmma2")
#: which libraries each group of timings needs
GROUP_LIBS = {"ssm": ("ssm",), "k1": ("scans",), "codec": ("byteplanes", "scans"),
              "bwd": ("attention_bwd",)}

#: the codec kernels' timed shapes: K2's four on the write path (most
#: launches first), K4's two and K3's most frequent on the read path, K9's
#: two in chip_smoke's phase 6
CODEC_SHAPES = {
    "byteshuffle_pages": ((36, 8192, 8), (91, 16384, 4), (12, 8192, 8),
                          (30, 16384, 4)),
    "decode_offset_pages": ((36, 8, 8192), (12, 8, 8192)),
    "unsplit_pages": ((91, 4, 16384),),
    "byteshuffle": ((250_000, 8), (1 << 24, 8)),
}
#: the near-empty shape at which K2 and K4 give their launch floor
FLOOR_SHAPES = {"byteshuffle_pages": (1, 16, 8),
                "decode_offset_pages": (1, 8, 16)}
#: bytes written between launches to flush the 50 MB L2
L2_FLUSH_BYTES = 128 << 20
HBM_BYTES_PER_S = 3.35e12
#: K4's entry in its first design: (planes, out, n_pages, per, stream)
K4_ARGS_BEFORE_CLUSTERS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                           ctypes.c_int64, ctypes.c_void_p]


def card_ms(fn, reps: int = 20) -> float:
    """Median card time of one call: launches queued behind a sleep
    kernel so that CUDA events between them time the card."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e6 * 50))  # 50 ms at <= 2 GHz: outlasts the enqueue
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    for i in range(reps):
        ev[i].record()
        fn()
    ev[reps].record()
    torch.cuda.synchronize()
    return statistics.median(ev[i].elapsed_time(ev[i + 1]) for i in range(reps))


def c_params(csrc, lib: str, fn: str) -> list:
    """The parameters of ``fn``'s ``extern "C"`` definition in the tree's
    ``lib.cu``."""
    src = (Path(csrc) / f"{lib}.cu").read_text()
    m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", src)
    return [a.strip() for a in m.group(1).split(",")]


def build(trees: dict, out_dir: Path, lib_names) -> dict:
    """{(tree, lib): ctypes library}, printing the ptxas lines."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tree, csrc in trees.items():
        for lib in lib_names:
            target = out_dir / f"lib{lib}_{tree}.so"
            cmd = [_build.nvcc(), *_build.NVCC_FLAGS, *_build.EXTRA_FLAGS[lib],
                   "-I", str(csrc), "-o", str(target),
                   str(Path(csrc) / f"{lib}.cu")]
            procs[(tree, lib)] = (target, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for (tree, lib), (target, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc {tree} {lib}.cu failed:\n{log.decode()[-4000:]}")
        current = None
        for line in log.decode().splitlines():
            if "Compiling entry" in line:
                current = next((k for k in PTXAS_KERNELS if k in line), None)
            elif "Performance Loss" in line:  # name the kernel, not its hash
                fn = re.search(r"[A-Za-z_]+ILi\d+", line)
                print(f"{tree} {fn.group(0) if fn else lib}: "
                      f"{line.split(':', 1)[-1].split(' for the function')[0].strip()}")
            elif current and ("Used" in line or "spill" in line):
                print(f"{tree} {current}: {line.split(':')[-1].strip()}")
        cdll = ctypes.CDLL(str(target))
        for fn, argtypes in _build.SIGNATURES[lib].items():
            getattr(cdll, fn).argtypes = argtypes
            getattr(cdll, fn).restype = _build.RESTYPES.get(fn, ctypes.c_int)
        if lib == "scans" and len(c_params(trees[tree], lib,
                                           "repro_decode_offset_pages")) == 5:
            cdll.repro_decode_offset_pages.argtypes = K4_ARGS_BEFORE_CLUSTERS
        if lib == "attention_bwd":
            f = cdll.repro_flash_attention_bwd
            args = list(f.argtypes)
            if not has_dv(trees[tree]):
                del args[17]  # v's head dim, after D
            if not has_part(trees[tree]):
                del args[10]
            f.argtypes = args
        libs[(tree, lib)] = cdll
    return libs


def has_part(csrc) -> bool:
    """Whether the tree's K5 backward entry takes the D = 256 partial-sum
    workspace ``part`` after ``delta`` (PR 21 on)."""
    return "void* part" in c_params(csrc, "attention_bwd",
                                    "repro_flash_attention_bwd")


def has_dv(csrc) -> bool:
    """Whether the tree's K5 backward entry takes v's head dim after D
    (the trees that build MLA's 96 / 64 backward)."""
    return "int DV" in c_params(csrc, "attention_bwd",
                                "repro_flash_attention_bwd")


def tol_share(got, want, tol: float) -> float:
    return ((got.float() - want).abs() / (tol * (1 + want.abs()))).max().item()


def k8_calls(libs, trees, stream) -> tuple:
    """({tree: call}, {tree: {"y": share, "state": share}})."""
    b, h, t, p, n = K8_SHAPE
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    x = torch.randn((b, h, t, p), generator=g, device="cuda").bfloat16()
    la = -torch.exp(-3 + 3.5 * torch.rand((b, h, t), generator=g, device="cuda"))
    Bm = torch.randn((b, t, n), generator=g, device="cuda")
    Cm = torch.randn((b, t, n), generator=g, device="cuda")
    want_y, want_s = ref.mamba2_ref(x.float(), la, Bm, Cm)
    calls, shares = {}, {}
    for tree in trees:
        f = libs[(tree, "ssm")].repro_mamba2_ssd
        y = torch.empty_like(x)
        st = torch.empty((b, h, n, p), device="cuda")

        def call(f=f, y=y, st=st):
            return f(x.data_ptr(), la.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                     y.data_ptr(), st.data_ptr(), b, h, t, n, p, 1, stream)

        if call() != 0:
            sys.exit(f"{tree}: repro_mamba2_ssd failed")
        torch.cuda.synchronize()
        shares[tree] = {"y": tol_share(y, want_y, 1e-2),
                        "state": tol_share(st, want_s, 1e-4)}
        calls[tree] = call
    return calls, shares


def k7_calls(libs, trees, stream) -> tuple:
    """({tree: call}, {tree: {"y": share, "state": share}}) of K7 with
    bf16 inputs, the reference's decays w = exp(-exp(uniform(-4, 1)))."""
    b, h, t, dk, dv = K7_SHAPE
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    r, k = (torch.randn((b, h, t, dk), generator=g, device="cuda").bfloat16()
            for _ in range(2))
    v = torch.randn((b, h, t, dv), generator=g, device="cuda").bfloat16()
    u = torch.randn((h, dk), generator=g, device="cuda").bfloat16()
    w = torch.exp(-torch.exp(-4 + 5 * torch.rand(
        (b, h, t, dk), generator=g, device="cuda"))).bfloat16()
    ins = (r, k, v, w, u)
    want_o, want_s = ref.rwkv6_ref(*(a.float() for a in ins))
    calls, shares = {}, {}
    for tree in trees:
        f = libs[(tree, "ssm")].repro_rwkv6_scan
        o = torch.empty_like(v)
        st = torch.empty((b, h, dk, dv), device="cuda")

        def call(f=f, o=o, st=st):
            return f(*(a.data_ptr() for a in ins), o.data_ptr(), st.data_ptr(),
                     b, h, t, dk, dv, 1, stream)

        if call() != 0:
            sys.exit(f"{tree}: repro_rwkv6_scan failed")
        torch.cuda.synchronize()
        shares[tree] = {"y": tol_share(o, want_o, 1e-2),
                        "state": tol_share(st, want_s, 1e-4)}
        calls[tree] = call
    return calls, shares


def scan_bwd_calls(libs, trees, stream, kind: str) -> tuple:
    """({tree: call}, {tree: {gradient: share of 1e-2, "workspace_bytes":
    n}}) of K7's ("wkv") or K8's ("ssd") backward with bf16 inputs and a
    final-state cotangent at its training shape, each tree with the
    workspace its own size query gives; the gradients against the plain
    version in fp32."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2468)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    if kind == "wkv":
        b, h, t, dk, dv = BWD_SCAN_SHAPES[kind]
        w = torch.exp(-torch.exp(-4 + 5 * torch.rand(
            (b, h, t, dk), generator=gen, device="cuda")))
        ins = [a.bfloat16() for a in (rnd(b, h, t, dk), rnd(b, h, t, dk),
                                      rnd(b, h, t, dv), w, rnd(h, dk))]
        dout, ds = rnd(b, h, t, dv).bfloat16(), rnd(b, h, dk, dv)
        want = ref.rwkv6_bwd_ref(*(a.float() for a in ins), dout.float(), ds)
        names, dims = ("dr", "dk", "dv", "dw", "du"), (b, h, t, dk, dv)
        entry = "repro_rwkv6_scan_bwd"
    else:
        b, h, t, p, n = BWD_SCAN_SHAPES[kind]
        la = -torch.exp(-3 + 3.5 * torch.rand((b, h, t), generator=gen,
                                              device="cuda"))
        ins = [rnd(b, h, t, p).bfloat16(), la, rnd(b, t, n), rnd(b, t, n)]
        dout, ds = rnd(b, h, t, p).bfloat16(), rnd(b, h, n, p)
        want = ref.mamba2_bwd_ref(ins[0].float(), *ins[1:], dout.float(), ds)
        names, dims = ("dx", "dlog_a", "dB", "dC"), (b, h, t, n, p)
        entry = "repro_mamba2_ssd_bwd"
    calls, shares = {}, {}
    for tree in trees:
        lib = libs[(tree, "ssm")]
        floats = getattr(lib, entry + "_ws")(*dims, 1)
        ws = torch.empty(floats, dtype=torch.float32, device="cuda")
        grads = [torch.empty_like(a) for a in ins]

        def call(f=getattr(lib, entry), ws=ws, grads=grads, floats=floats):
            return f(*(a.data_ptr() for a in ins), dout.data_ptr(),
                     ds.data_ptr(), *(g.data_ptr() for g in grads),
                     ws.data_ptr(), floats, *dims, 1, stream)

        if call() != 0:
            sys.exit(f"{tree}: {entry} failed")
        torch.cuda.synchronize()
        shares[tree] = {nm: tol_share(g, w_, 1e-2)
                        for nm, g, w_ in zip(names, grads, want)}
        shares[tree]["workspace_bytes"] = 4 * floats
        calls[tree] = call
    del want
    return calls, shares


def k1_calls(libs, trees, n, stream) -> dict:
    """{tree: call} of K1 at ``n`` values, each checked against cumsum,
    and ``torch.cumsum`` itself."""
    g = torch.Generator(device="cuda")
    g.manual_seed(n)
    s = torch.poisson(torch.full((n,), 5.0, device="cuda"), generator=g).long()
    want = torch.cumsum(s, 0)
    calls = {"torch.cumsum": lambda: torch.cumsum(s, 0)}
    for tree in trees:
        lib = libs[(tree, "scans")]
        tiles = -(-n // lib.repro_offsets_scan_tile())
        ws = torch.zeros(2 + 4 * tiles, dtype=torch.int64, device="cuda")
        out = torch.empty_like(s)
        state = {"epoch": 0, "base": 0}

        def call(lib=lib, ws=ws, out=out, state=state, tiles=tiles):
            state["epoch"] += 1
            rc = lib.repro_offsets_scan_i64(s.data_ptr(), out.data_ptr(),
                                            ws.data_ptr(), tiles, n,
                                            state["epoch"], state["base"], stream)
            state["base"] += tiles
            return rc

        if call() != 0:
            sys.exit(f"{tree}: repro_offsets_scan_i64 failed")
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            sys.exit(f"{tree}: K1 at ({n},) differs from torch.cumsum")
        calls[tree] = call
    return calls


def bwd_calls(libs, trees, stream, shape) -> tuple:
    """({tree: call}, {tree: share of the bf16 tolerance}) of K5's backward
    at ``shape`` on the checkout's K5 forward output and LSE."""
    from repro_torch.kernels.flash_attention import flash_attention_lse

    b, h, g, s, d = shape
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1357)
    q, do = (torch.randn((b, h, s, d), generator=gen, device="cuda").bfloat16()
             for _ in range(2))
    k, v = (torch.randn((b, g, s, d), generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    out, lse = flash_attention_lse(q, k, v)
    want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                       out.float(), lse, do.float())
    delta, work = torch.empty_like(lse), torch.empty_like(lse)
    part = torch.empty(4 * k.numel(), dtype=torch.float32, device="cuda")
    calls, shares = {}, {}
    for tree in trees:
        f = libs[(tree, "attention_bwd")].repro_flash_attention_bwd
        grads = [torch.empty_like(t) for t in (q, k, v)]
        dq, dk, dv = (t.data_ptr() for t in grads)
        if "const void* lse" in c_params(trees[tree], "attention_bwd",
                                         "repro_flash_attention_bwd"):
            # the forward's LSE, after dout
            mid = (lse.data_ptr(), dq, dk, dv, delta.data_ptr())
        else:  # an LSE workspace after dv
            mid = (dq, dk, dv, work.data_ptr(), delta.data_ptr())
        if has_part(trees[tree]):
            mid += (part.data_ptr(),)
        dims = (d, d) if has_dv(trees[tree]) else (d,)

        def call(f=f, mid=mid, dims=dims):
            return f(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     do.data_ptr(), *mid, b, h, g, s, s, *dims, 1, 1, 0,
                     d ** -0.5, stream)

        if call() != 0:  # a tree built without this head dim
            print(f"{tree}: repro_flash_attention_bwd refuses {shape}")
            continue
        torch.cuda.synchronize()
        shares[tree] = max(tol_share(a, w, 1e-2) for a, w in zip(grads, want))
        calls[tree] = call
    return calls, shares


def cold_ms(fn, reps: int = 20) -> float:
    """Median card time of one call with the L2 cache flushed before it:
    each launch follows a write of ``L2_FLUSH_BYTES`` outside the events
    that time it, all queued behind a sleep kernel."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e6 * 50))
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for i, (a, b) in enumerate(ev):
        flush.fill_(i & 0xFF)
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


def rounds(calls: dict, n_rounds: int, what: str, timer=card_ms) -> dict:
    """{name: [card ms of each round]}, the order alternating by round."""
    names = list(calls)
    times = {k: [] for k in names}
    for r in range(n_rounds):
        for k in (names if r % 2 == 0 else names[::-1]):
            times[k].append(timer(calls[k]))
            print(f"{what} round {r} {k}: {times[k][-1]:.5f} ms", flush=True)
    return times


def codec_input(kernel: str, shape, seed: int):
    """The input of ``kernel`` at ``shape`` on the card: random bytes, or
    for K4 the planes of end offsets uniform below 2^31 (the signed
    deltas fill all four low planes)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    if kernel != "decode_offset_pages":
        return torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda",
                             generator=g)
    n_pages, _, per = shape
    ends = torch.randint(0, 2**31, (n_pages, per), dtype=torch.int64,
                         device="cuda", generator=g)
    d = ends.diff(dim=1, prepend=torch.zeros_like(ends[:, :1]))
    zz = (d << 1) ^ (d >> 63)
    return zz.view(torch.uint8).reshape(n_pages, per, 8).transpose(1, 2).contiguous()


def codec_plain(kernel: str, x):
    return {"byteshuffle_pages": ref.byteshuffle_pages_ref,
            "unsplit_pages": ref.unsplit_pages_ref,
            "decode_offset_pages": ref.decode_offset_pages_ref,
            "byteshuffle": ref.byteshuffle_ref}[kernel](x)


def codec_call(lib, kernel: str, x, stream):
    """-> (call, output) of ``lib``'s C entry of ``kernel`` on ``x``."""
    from repro_torch.kernels.decode_pages import launch_shape

    want = codec_plain(kernel, x)
    out = torch.empty_like(want)
    a, b = x.data_ptr(), out.data_ptr()
    if kernel == "byteshuffle_pages":
        p, per, nb = x.shape
        return (lambda: lib.repro_byteshuffle_pages(a, b, p, per, nb, stream)), out
    if kernel == "unsplit_pages":
        p, nb, per = x.shape
        return (lambda: lib.repro_unsplit_pages(a, b, p, per, nb, stream)), out
    if kernel == "byteshuffle":
        n, nb = x.shape
        return (lambda: lib.repro_byteshuffle(a, b, n, nb, stream)), out
    p, _, per = x.shape
    f = lib.repro_decode_offset_pages
    if len(f.argtypes) == len(K4_ARGS_BEFORE_CLUSTERS):
        return (lambda: f(a, b, p, per, stream)), out
    c, tile = launch_shape(per)
    return (lambda: f(a, b, p, per, c, tile, stream)), out


def time_codec(libs, trees, n_rounds: int, stream) -> dict:
    """Every codec kernel at ``CODEC_SHAPES`` on every tree, each output
    checked bit for bit; K2 and K4 also L2-cold and beside each tree's
    launch floor.  -> {kernel: {shape: {"ms", "cold_ms", "bound_ms"}},
    "floor": {kernel: {tree: [ms]}}}."""
    lib_of = {"decode_offset_pages": "scans"}
    out = {"floor": {}}
    for kernel, shapes in CODEC_SHAPES.items():
        lib = lib_of.get(kernel, "byteplanes")
        out[kernel] = {}
        for i, shape in enumerate(shapes):
            x = codec_input(kernel, shape, seed=100 + i)
            want = codec_plain(kernel, x)
            calls = {}
            for tree in trees:
                call, got = codec_call(libs[(tree, lib)], kernel, x, stream)
                if call() != 0:
                    sys.exit(f"{tree}: {kernel} at {shape} failed to launch")
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    sys.exit(f"{tree}: {kernel} at {shape} differs from its "
                             "plain version")
                calls[tree] = call
            nbytes = (8 * shape[0] * shape[2] if kernel == "decode_offset_pages"
                      else 2 * x.numel())
            row = {"bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                   "ms": rounds(calls, n_rounds, f"{kernel} {shape}")}
            if kernel in FLOOR_SHAPES:
                row["cold_ms"] = rounds(calls, n_rounds,
                                        f"{kernel} {shape} L2-cold", cold_ms)
            print(f"{kernel} {shape}: bound {row['bound_ms']:.5f} ms (bytes)",
                  flush=True)
            out[kernel][str(shape)] = row
            del x, want, calls
        if kernel in FLOOR_SHAPES:
            shape = FLOOR_SHAPES[kernel]
            x = codec_input(kernel, shape, seed=7)
            calls = {}
            for tree in trees:
                call, got = codec_call(libs[(tree, lib)], kernel, x, stream)
                if call() != 0:
                    sys.exit(f"{tree}: {kernel} at {shape} failed to launch")
                calls[tree] = call
            out["floor"][kernel] = rounds(calls, n_rounds,
                                          f"{kernel} floor {shape}")
    return out


def time_ssm(libs, trees, n_rounds: int, stream, result: dict) -> None:
    """K7 and K8 at their serve shapes and their backwards at the training
    shapes on every tree, with each tree's share of the tolerances."""
    k7, shares = k7_calls(libs, trees, stream)
    for tree, sh in shares.items():
        print(f"K7 {tree}: share of SCAN_TOL used, y {sh['y']:.4f}, "
              f"state {sh['state']:.4f}")
    result["rwkv6_scan"] = {"shape": list(K7_SHAPE), "tol_share": shares,
                            "ms": rounds(k7, n_rounds, "K7")}
    del k7
    k8, shares = k8_calls(libs, trees, stream)
    for tree, sh in shares.items():
        print(f"K8 {tree}: share of SCAN_TOL used, y {sh['y']:.4f}, "
              f"state {sh['state']:.4f}")
    result["mamba2_ssd"] = {"shape": list(K8_SHAPE), "tol_share": shares,
                            "ms": rounds(k8, n_rounds, "K8")}
    del k8
    for kind, name in (("wkv", "rwkv6_scan_bwd"), ("ssd", "mamba2_ssd_bwd")):
        calls, shares = scan_bwd_calls(libs, trees, stream, kind)
        for tree, sh in shares.items():
            print(f"{name} {tree}: share of 1e-2 used, " + ", ".join(
                f"{k} {v:.4f}" for k, v in sh.items() if k != "workspace_bytes")
                + f"; workspace {sh['workspace_bytes'] / 2**30:.4f} GiB")
        result[name] = {"shape": list(BWD_SCAN_SHAPES[kind]),
                        "tol_share": shares,
                        "ms": rounds(calls, n_rounds, name)}
        del calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", metavar="NAME=CSRC_DIR")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--only", nargs="+", choices=sorted(GROUP_LIBS),
                    default=sorted(GROUP_LIBS), help="groups of timings")
    ap.add_argument("--out", default="build/scan_builds",
                    help="directory of the built libraries")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("scan_builds needs a CUDA card")
    trees = {"tree": _build.CSRC}
    for item in args.trees:
        name, _, path = item.partition("=")
        trees[name] = Path(path)
    lib_names = sorted({lib for g in args.only for lib in GROUP_LIBS[g]})
    libs = build(trees, Path(args.out), lib_names)
    stream = torch.cuda.current_stream().cuda_stream
    result = {"device": torch.cuda.get_device_name(0)}
    if "codec" in args.only:
        result["codec"] = time_codec(libs, trees, args.rounds, stream)
    if "ssm" in args.only:
        time_ssm(libs, trees, args.rounds, stream, result)
    if "bwd" in args.only:
        result["flash_attention_bwd"] = []
        for shape in BWD_SHAPES:
            calls, shares = bwd_calls(libs, trees, stream, shape)
            for tree, share in shares.items():
                print(f"K5 bwd {shape} {tree}: share of the bf16 tolerance "
                      f"used {share:.4f}")
            result["flash_attention_bwd"].append({
                "shape": list(shape), "tol_share": shares,
                "ms": rounds(calls, args.rounds, f"K5 bwd {shape}")})
            del calls
    if "k1" in args.only:
        result["offsets_scan"] = {}
        for n in K1_SIZES:
            result["offsets_scan"][n] = rounds(k1_calls(libs, trees, n, stream),
                                               args.rounds, f"K1 ({n},)")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
