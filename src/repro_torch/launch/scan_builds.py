"""Time K1 (offsets scan), K7 (RWKV-6 wkv, bf16 inputs) and K8 (Mamba-2
SSD, bf16 x) as built from several source trees against each other on one
card, in one process.

    PYTHONPATH=src python -m repro_torch.launch.scan_builds \\
        [NAME=CSRC_DIR ...] [--rounds 3] [--out FILE]

Each ``NAME=CSRC_DIR`` is a copy of ``src/repro_torch/csrc`` (a parent
commit's, from ``git archive``, or an edited variant); the checkout's own
sources are always built as ``tree``.  Every tree's ``scans.cu`` and
``ssm.cu`` compile together (nvcc, one process each); the lines give the
registers and spills of ``scan_lookback``, of ``ssd_chunked`` at N = 64
and of ``wkv_chunked`` at Dk = 64.  The C entry points are called
directly, so a tree's wrapper need not match this one's; K1's workspace
is zeroed and sized for slots of up to 32 bytes a tile.  A variant of a
kernel (one bf16 piece per operand instead of two, a part taken out) is
timed as an edited copy of the checkout's ``csrc``, one more tree.

K7 runs at rwkv6-7b's prefill shape (16, 64, 1000, 64, 64) with bf16
inputs (a parent tree's K7 is its bf16 route, whatever its design) and K8
at zamba2-2.7b's (16, 80, 1000, 64, 64): each tree's output and final
state are held against the plain version and printed as the largest
share of ``SCAN_TOL`` they use (bf16 outputs 1e-2, final states 1e-4, as
``|got - want| / (tol (1 + |want|))``; above 1 misses it).  K1 runs at
100,000, 1,100,003 and 2^24 values beside ``torch.cumsum`` and must equal
it bit for bit.  Times are card times (CUDA events between launches
queued behind a sleep kernel, median), the trees interleaved in
``--rounds`` rounds whose order alternates.  The last line is one JSON
object of every number.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import _build, ref

K7_SHAPE = (16, 64, 1000, 64, 64)  # (B, H, T, Dk, Dv)
K8_SHAPE = (16, 80, 1000, 64, 64)  # (B, H, T, P, N)
K1_SIZES = (100_000, 1_100_003, 1 << 24)
PTXAS_KERNELS = ("scan_lookback", "ssd_chunkedILi64", "wkv_chunkedILi64")


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


def build(trees: dict, out_dir: Path) -> dict:
    """{(tree, lib): ctypes library}, printing the ptxas lines."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tree, csrc in trees.items():
        for lib in ("scans", "ssm"):
            target = out_dir / f"lib{lib}_{tree}.so"
            cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
                   str(csrc), "-o", str(target), str(Path(csrc) / f"{lib}.cu")]
            procs[(tree, lib)] = (target, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for (tree, lib), (target, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc {tree} {lib}.cu failed:\n{log.decode()[-4000:]}")
        current = False
        for line in log.decode().splitlines():
            if "Compiling entry" in line:
                current = any(k in line for k in PTXAS_KERNELS)
            elif current and ("Used" in line or "spill" in line):
                print(f"{tree} {lib}: {line.strip()}")
        cdll = ctypes.CDLL(str(target))
        for fn, argtypes in _build.SIGNATURES[lib].items():
            getattr(cdll, fn).argtypes = argtypes
            getattr(cdll, fn).restype = ctypes.c_int
        libs[(tree, lib)] = cdll
    return libs


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


def rounds(calls: dict, n_rounds: int, what: str) -> dict:
    """{name: [card ms of each round]}, the order alternating by round."""
    names = list(calls)
    times = {k: [] for k in names}
    for r in range(n_rounds):
        for k in (names if r % 2 == 0 else names[::-1]):
            times[k].append(card_ms(calls[k]))
            print(f"{what} round {r} {k}: {times[k][-1]:.5f} ms", flush=True)
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", metavar="NAME=CSRC_DIR")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default="build/scan_builds",
                    help="directory of the built libraries")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("scan_builds needs a CUDA card")
    trees = {"tree": _build.CSRC}
    for item in args.trees:
        name, _, path = item.partition("=")
        trees[name] = Path(path)
    libs = build(trees, Path(args.out))
    stream = torch.cuda.current_stream().cuda_stream
    result = {"device": torch.cuda.get_device_name(0)}
    k7, shares = k7_calls(libs, trees, stream)
    for tree, sh in shares.items():
        print(f"K7 {tree}: share of SCAN_TOL used, y {sh['y']:.4f}, "
              f"state {sh['state']:.4f}")
    result["rwkv6_scan"] = {"shape": list(K7_SHAPE), "tol_share": shares,
                            "ms": rounds(k7, args.rounds, "K7")}
    del k7
    k8, shares = k8_calls(libs, trees, stream)
    for tree, sh in shares.items():
        print(f"K8 {tree}: share of SCAN_TOL used, y {sh['y']:.4f}, "
              f"state {sh['state']:.4f}")
    result["mamba2_ssd"] = {"shape": list(K8_SHAPE), "tol_share": shares,
                            "ms": rounds(k8, args.rounds, "K8")}
    result["offsets_scan"] = {}
    for n in K1_SIZES:
        result["offsets_scan"][n] = rounds(k1_calls(libs, trees, n, stream),
                                           args.rounds, f"K1 ({n},)")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
