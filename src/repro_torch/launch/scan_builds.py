"""Time K1 (offsets scan), K7 (RWKV-6 wkv, bf16 inputs), K8 (Mamba-2
SSD, bf16 x), the codec kernels K2, K3, K4 and K9, K5's forward and
backward (bf16) and K6 (bf16) as built from several source trees against
each other on one card, in one process.

    PYTHONPATH=src python -m repro_torch.launch.scan_builds \\
        [NAME=CSRC_DIR[+EDIT...] ...] [--rounds 3] [--only GROUP ...] [--out DIR]

Each ``NAME=CSRC_DIR`` is a copy of ``src/repro_torch/csrc`` (a parent
commit's, from ``git archive``, or an edited variant); the checkout's own
sources are always built as ``tree``, and ``tree`` as a CSRC_DIR names
them.  ``+EDIT`` builds a copy of CSRC_DIR with ``EDITS[EDIT]`` applied to
its ``attention.cu`` (several apply in order): ``no-math``, K5's forward
with its products and softmax taken out, its stages still streamed,
waited for and released; ``no-q-load``, without a block's Q loads past
its first work tile; ``no-o-store`` / ``no-o-tma``, without the
epilogue's O stores (the one-block route's / the split route's); K6's
knockouts: ``ring-no-math`` / ``mma-no-math`` (the cp.async ring's /
the tensor-core route's stages streamed with no products),
``ring-combine-only`` / ``mma-combine-only`` (no chunk reads its rows, the
last block combines), ``no-combine`` (either route's last block skips the
combine), ``ring-8-warps`` (the ring's cap of 4 warps at 8 heads lifted),
and the launch-only ``ring-all-sms`` (``DECODE_KNOBS``).  A text an edit
looks for that the source lacks stops the run.  Every tree's
``byteplanes.cu``, ``scans.cu``, ``ssm.cu``, ``attention.cu`` and
``attention_bwd.cu`` compile together (nvcc,
one process each); the lines give the registers and spills of
``scan_lookback``, of ``ssd_chunked`` at N = 64, of ``wkv_chunked`` at Dk
= 64, of the codec kernels (K2's ``shuffle_reg`` or ``shuffle_vec``, K3's
``unsplit_reg`` or ``unsplit_vec``, K4's ``decode_offsets``), of K5's
forward (``flash_fwd_wgmma`` at each head dim, ``flash_fwd_wgmma_split``
at 128 and 256) and of its backward
launches at D = 64, 256, 128 and 80 and at q/k 96 with v 64 (the pair
route's kernels and D = 256's, or a parent's one-warpgroup ones), of
K6's ring (``decode_partial``, bf16 at 8 heads, D = 128 and 256) and
tensor-core route (``decode_mma``), and ``ptxas``'s warnings that ``wgmma`` runs serialized.  The C
entry points are called directly, so a
tree's wrapper need not match this one's (K4's entry takes its cluster
geometry; a tree whose source declares the entry without it, the first
design's, is called without it); K1's workspace is zeroed and sized for slots of up to 32 bytes
a tile.  A variant of a kernel (one bf16 piece per operand instead of
two, a part taken out) is timed as an edited copy of the checkout's
``csrc``, one more tree.  ``--only`` picks groups: ``ssm`` (K7, K8 and
their backwards),
``k1``, ``codec``, ``fwd`` (K5's forward), ``bwd`` (K5's backward),
``decode`` (K6); all by default.

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
find it.  K5's backward runs causal at the training shapes ``BWD_SHAPES``
(smollm-360m's, gemma-2b's, chameleon-34b's, zamba2-2.7b's and
minicpm3-4b's) on the output and rows' LSE of the checkout's K5 forward: a
tree whose entry takes the LSE as an input (``const void* lse`` after
``dout``) gets the forward's, an older one (the LSE a workspace after
``dv``) recomputes it; each tree's gradients are printed as the largest
share of the card's bf16 tolerance 1e-2 they use against
``ref.flash_attention_bwd_ref`` in fp32, each tree's launches split by a
torch.profiler trace (card ms a launch), and SDPA's backward
(``torch.autograd.grad`` through ``scaled_dot_product_attention``, the
backend it ran printed) timed in the same rounds as one more call.  K5's
forward runs causal at
``FWD_SHAPES``: the serve shapes (16 x 1,000 tokens) of smollm-360m (64),
zamba2-2.7b (80) and minicpm3-4b (q/k 96, v 64), and with the rows' LSE
the training shapes (8 x 1,024) of smollm-360m, zamba2-2.7b,
minicpm3-4b, chameleon-34b, deepseek-moe-16b and mixtral-8x22b (128)
and gemma-2b (256); each tree's output and LSE are printed as the
largest share of chip_smoke's tolerances (1.6e-2 and 2e-5, ``(1 +
|want|)``) they use against ``ref.flash_attention_ref`` /
``ref.flash_attention_lse_ref`` in fp32, and SDPA's forward
(``scaled_dot_product_attention(is_causal=True, enable_gqa=True)`` on
the same inputs, the backend it ran printed) is timed in the same rounds
as one more call.  K6 runs at ``DECODE_SHAPES`` (gemma-2b's,
chameleon-34b's and mixtral-8x22b's decodes at length 1,032) through each
tree's C entry with that tree's launch (the checkout's
``decode_attention`` rules: the tensor-core route where the tree has
``decode_mma`` and ``decode_route`` picks it, else the ring's), its share
of the bf16 tolerance 1.6e-2 printed (a knockout's shows how wrong it
is), beside SDPA on the cache's first 1,032 rows (its backend printed)
and the byte bound.  Times are card times (CUDA events between launches queued
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
#: K5's backward: the training shapes (B, H, G, S, D, DV), causal, of
#: smollm-360m, gemma-2b, chameleon-34b and zamba2-2.7b (the pair route at
#: D = 128 and 80) and minicpm3-4b (MLA's q/k 96, v 64)
BWD_SHAPES = ((8, 15, 5, 1024, 64, 64), (8, 8, 1, 1024, 256, 256),
              (8, 64, 8, 1024, 128, 128), (8, 32, 32, 1024, 80, 80),
              (8, 40, 40, 1024, 96, 64))
#: K5's forward: (B, H, G, S, D, DV, with the LSE), causal: the serve
#: shapes of smollm-360m, zamba2-2.7b and minicpm3-4b, then the training
#: shapes of smollm-360m, zamba2-2.7b, minicpm3-4b, chameleon-34b,
#: deepseek-moe-16b, gemma-2b and mixtral-8x22b (its window of 4,096 is
#: longer than the sequence)
FWD_SHAPES = ((16, 15, 5, 1000, 64, 64, False), (16, 32, 32, 1000, 80, 80, False),
              (16, 40, 40, 1000, 96, 64, False),
              (8, 15, 5, 1024, 64, 64, True), (8, 32, 32, 1024, 80, 80, True),
              (8, 40, 40, 1024, 96, 64, True), (8, 64, 8, 1024, 128, 128, True),
              (8, 16, 16, 1024, 128, 128, True), (8, 8, 1, 1024, 256, 256, True),
              (8, 48, 8, 1024, 128, 128, True))
#: chip_smoke's tolerances of K5's bf16 output and of its LSE
FWD_TOL, LSE_TOL = 1.6e-2, 2e-5
PTXAS_KERNELS = ("scan_lookback", "ssd_chunkedILi64", "wkv_chunkedILi64",
                 "ssd_bwd_localILi64", "ssd_bwd_chunkILi64",
                 "wkv_bwd_statesILi64", "wkv_bwd_chunksILi64",
                 "shuffle_reg", "shuffle_vec", "unsplit_reg", "unsplit_vec",
                 "decode_offsets",
                 "bwd_dq_wgmmaILi64", "bwd_dkv_wgmmaILi64",
                 "bwd_dq_wgmma256", "bwd_dkv_wgmma256",
                 "bwd_dq_wgmmaILi256", "bwd_dkv_wgmma2",
                 "bwd_dq_wgmma_pairILi128", "bwd_dkv_wgmma_pairILi128",
                 "bwd_dq_wgmma_pairILi80", "bwd_dkv_wgmma_pairILi80",
                 "bwd_dq_wgmma_pairILi96", "bwd_dkv_wgmma_pairILi96",
                 "bwd_dq_wgmmaILi96", "bwd_dkv_wgmmaILi96",
                 "flash_fwd_wgmmaILi64", "flash_fwd_wgmmaILi80",
                 "flash_fwd_wgmmaILi96", "flash_fwd_wgmmaILi128",
                 "flash_fwd_wgmmaILi256", "flash_fwd_wgmma_splitILi128",
                 "flash_fwd_wgmma_splitILi256",
                 "bwd_dq_wgmmaILi128", "bwd_dkv_wgmmaILi128",
                 "bwd_dq_wgmmaILi80", "bwd_dkv_wgmmaILi80",
                 "decode_partialI13__nv_bfloat16Li256ELi8E",
                 "decode_partialI13__nv_bfloat16Li128ELi8E",
                 "decode_mmaILi256E", "decode_mmaILi128E")
#: K6's timed shapes (B, H, G, S, D) at ``DECODE_LENGTH``: the decode
#: shapes of gemma-2b (8 query heads over one kv head of 256),
#: chameleon-34b (64 over 8 of 128) and mixtral-8x22b (48 over 8 of 128;
#: its window of 4,096 is longer than the cache)
DECODE_SHAPES = ((16, 8, 1, 1064, 256), (16, 64, 8, 1064, 128),
                 (16, 48, 8, 1064, 128))
#: cache rows each sequence sees: the middle of chip_smoke's decode (1,000
#: prompt tokens and half of 64 new ones)
DECODE_LENGTH = 1032
#: edits of a tree's ``attention.cu`` (``NAME=CSRC_DIR+EDIT``): each
#: (text, replacement) must be found at least once
EDITS = {
    # K5's forward as a skeleton of its streaming: no S = Q K^T, no P V, no
    # softmax (its waits, releases and epilogue stay)
    "no-math": (("ss_tile<D, BK>(sc, q_smem(t), WG_BQ, wg * 64, kt);", ""),
                ("rs_tile<DV, BK>(oacc, p[kk], vt, kk);", ";"),
                ("softmax(p_new, i);", ""), ("softmax(pa, 0);", "")),
    # the split route without its O stores (TMA boxes)
    "no-o-tma": (("tma_store_3d(&to,", "if (sq < 0) tma_store_3d(&to,"),),
    # no Q load past a block's first work tile (its Q buffer still waits
    # to be free): the cost of the exposed Q load
    "no-q-load": (("mbar_expect_tx(q_full(t), L::Q_BYTES);",
                   "if (t >= QB) mbar_arrive(q_full(t)); "
                   "else mbar_expect_tx(q_full(t), L::Q_BYTES);"),
                  ("for (int c = 0; c < C::NB; ++c)\n          tma_load_3d(q_smem(t)",
                   "for (int c = 0; c < (t >= QB ? 0 : C::NB); ++c)\n"
                   "          tma_load_3d(q_smem(t)")),
    # no O stores from the epilogue (the LSE's stay)
    "no-o-store": (("if (row0 < sq)\n          *reinterpret_cast",
                    "if (row0 < 0)\n          *reinterpret_cast"),
                   ("if (row1 < sq)\n          *reinterpret_cast",
                    "if (row1 < 0)\n          *reinterpret_cast")),
    # K6's cp.async ring (decode_partial) with no scores and no P V: its
    # stages still streamed, waited for and released
    "ring-no-math": (
        ("for (int e = 0; e < E; ++e) part = fmaf(qv[i][e], kf[e], part);",
         "for (int e = 0; e < 0; ++e) {}"),
        ("const float x = row_sum<NS>(sp[i][p], lane, sl);",
         "const float x = sp[i][p];"),
        ("for (int e = 0; e < E; ++e) acc[i][e] = fmaf(pr, vf[e], acc[i][e]);",
         "for (int e = 0; e < 0; ++e) {}")),
    # the ring's cap of 4 warps at 8 heads a block lifted to 8 (the launch
    # asks for 8: DECODE_KNOBS)
    "ring-8-warps": (("return HGP <= 4 ? 512 : 128;",
                      "return HGP <= 4 ? 512 : 256;"),),
    # the ring's split aimed at every SM, not half (a launch argument only)
    "ring-all-sms": (),
    # the ring's combine alone: no chunk reads its rows (each writes the
    # weight of a chunk that saw some), the last block combines them all
    "ring-combine-only": (
        ("if (start >= c1) {  // no visible position", "if (true) {  //"),
        ("pm[idx] = NEG;\n      pl[idx] = 0.f;",
         "pm[idx] = 0.f;\n      pl[idx] = 1.f;")),
    # K6 without its combine (either route's): the last block only resets
    # the counter
    "no-combine": (("if (ticket != nch - 1) return;",
                    "if (ticket != nch - 1) return;\n"
                    "  if (threadIdx.x == 0) *counter = 0;\n"
                    "  if (nch > 0) return;"),),
    # the tensor-core route with no products: its slices still loaded,
    # waited for and released, the softmax kept
    "mma-no-math": (("mma_bf16(sc[kk & 1], a, qf[kk][0], qf[kk][1]);", ";"),
                    ("mma_bf16(acc[dm], a, b0, b1);", ";")),
    # the tensor-core route's combine alone, as ring-combine-only
    "mma-combine-only": (
        ("if (nsl == 0) {  // no visible position", "if (true) {  //"),
        ("pm[idx] = NEG;\n      pl[idx] = 0.f;",
         "pm[idx] = 0.f;\n      pl[idx] = 1.f;")),
}
#: the ring's launch arguments an edit sets: warps a block, the split's
#: target as a share of the SMs (its rule: 0.5)
DECODE_KNOBS = {"ring-8-warps": {"warps": 8}, "ring-all-sms": {"target": 1.0}}
#: which libraries each group of timings needs
GROUP_LIBS = {"ssm": ("ssm",), "k1": ("scans",), "codec": ("byteplanes", "scans"),
              "fwd": ("attention",), "bwd": ("attention_bwd",),
              "decode": ("attention",)}

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
BF16_OPS_PER_S = 989e12
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
                fn = re.search(r"[A-Za-z_]+ILi\d+|bwd_d\w*?wgmma(?:256|2)", line)
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


def edited(csrc: Path, edits, out_dir: Path) -> Path:
    """A copy of the tree ``csrc`` at ``out_dir`` with ``EDITS[e]`` of each
    ``e`` in ``edits`` applied to its ``attention.cu``, in order."""
    import shutil

    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.copytree(csrc, out_dir)
    path = out_dir / "attention.cu"
    src = path.read_text()
    for edit in edits:
        if edit not in EDITS:
            sys.exit(f"unknown edit {edit!r}: one of {sorted(EDITS)}")
        for old, new in EDITS[edit]:
            if old not in src:
                sys.exit(f"{csrc}/attention.cu has no {old!r} for the edit "
                         f"{edit}")
            src = src.replace(old, new)
    path.write_text(src)
    return out_dir


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

    b, h, g, s, d, dv = shape
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1357)
    rnd = lambda *dims: torch.randn(dims, generator=gen,
                                    device="cuda").bfloat16()
    q, k = rnd(b, h, s, d), rnd(b, g, s, d)
    v, do = rnd(b, g, s, dv), rnd(b, h, s, dv)
    out, lse = flash_attention_lse(q, k, v)
    want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                       out.float(), lse, do.float())
    delta, work = torch.empty_like(lse), torch.empty_like(lse)
    part = torch.empty(4 * k.numel(), dtype=torch.float32, device="cuda")
    calls, shares = {}, {}
    for tree in trees:
        f = libs[(tree, "attention_bwd")].repro_flash_attention_bwd
        grads = [torch.empty_like(t) for t in (q, k, v)]
        ptrs = tuple(t.data_ptr() for t in grads)  # dq, dk, dv
        if "const void* lse" in c_params(trees[tree], "attention_bwd",
                                         "repro_flash_attention_bwd"):
            # the forward's LSE, after dout
            mid = (lse.data_ptr(), *ptrs, delta.data_ptr())
        else:  # an LSE workspace after dv
            mid = (*ptrs, work.data_ptr(), delta.data_ptr())
        if has_part(trees[tree]):
            mid += (part.data_ptr(),)
        if not has_dv(trees[tree]) and dv != d:
            print(f"{tree}: repro_flash_attention_bwd takes no v head dim")
            continue
        dims = (d, dv) if has_dv(trees[tree]) else (d,)

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


def sdpa_bwd_call(shape):
    """One call of SDPA's backward (``torch.autograd.grad`` through
    ``scaled_dot_product_attention(is_causal=True, enable_gqa=True)`` on a
    kept graph: cuDNN or FlashAttention, whichever PyTorch picks) at
    K5's backward ``shape`` -> (call, the backend it ran)."""
    import torch.nn.functional as F

    b, h, g, s, d, dv = shape
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1357)
    rnd = lambda *dims: torch.randn(dims, generator=gen, device="cuda",
                                    dtype=torch.bfloat16, requires_grad=True)
    leaves = [rnd(b, h, s, d), rnd(b, g, s, d), rnd(b, g, s, dv)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                         enable_gqa=True)
    do = torch.randn_like(out)
    return (lambda: torch.autograd.grad(out, leaves, do, retain_graph=True),
            type(out.grad_fn).__name__)


def launch_split(call, reps: int = 10) -> dict:
    """{kernel: card ms a launch} of ``reps`` calls, from a torch.profiler
    trace (the calls queued behind a sleep kernel, so that the tracing is
    on before the first of them runs)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(int(2e6 * 20))
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.name:
            name = e.name.replace("(anonymous namespace)::", "")[:60]
            t, c = by_name.get(name, (0.0, 0))
            by_name[name] = (t + e.time_range.elapsed_us(), c + 1)
    return {k: t / c / 1e3 for k, (t, c) in by_name.items()}


def fwd_calls(libs, trees, stream, shape) -> tuple:
    """({tree: call}, {tree: {"out": share, "lse": share}}) of K5's
    forward (bf16, causal) at ``shape``, with the rows' LSE where the
    shape asks for it."""
    b, h, g, s, d, dv, with_lse = shape
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2024)
    rnd = lambda *dims: torch.randn(dims, generator=gen,
                                    device="cuda").bfloat16()
    q, k, v = rnd(b, h, s, d), rnd(b, g, s, d), rnd(b, g, s, dv)
    want = ref.flash_attention_ref(q.float(), k.float(), v.float())
    want_lse = (ref.flash_attention_lse_ref(q.float(), k.float())
                if with_lse else None)
    calls, shares = {}, {}
    for tree in trees:
        f = libs[(tree, "attention")].repro_flash_attention
        out = torch.empty((b, h, s, dv), dtype=torch.bfloat16, device="cuda")
        lse = torch.empty((b, h, s), device="cuda") if with_lse else None

        def call(f=f, out=out, lse=lse):
            return f(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     None if lse is None else lse.data_ptr(), b, h, g, s, s,
                     d, dv, 1, 1, 0, d ** -0.5, stream)

        if call() != 0:
            sys.exit(f"{tree}: repro_flash_attention failed at {shape}")
        torch.cuda.synchronize()
        shares[tree] = {"out": tol_share(out, want, FWD_TOL)}
        if with_lse:
            shares[tree]["lse"] = tol_share(lse, want_lse, LSE_TOL)
        calls[tree] = call
    del want, want_lse
    return calls, shares


def sdpa_fwd_call(shape):
    """One call of SDPA's forward (``scaled_dot_product_attention(
    is_causal=True, enable_gqa=True)``) on :func:`fwd_calls`' inputs at
    K5's forward ``shape`` -> (call, the backend it ran, read off the graph
    of one call on inputs that require grad)."""
    import torch.nn.functional as F

    b, h, g, s, d, dv, _lse = shape
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2024)
    rnd = lambda *dims: torch.randn(dims, generator=gen,
                                    device="cuda").bfloat16()
    q, k, v = rnd(b, h, s, d), rnd(b, g, s, d), rnd(b, g, s, dv)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    backend = type(F.scaled_dot_product_attention(
        *leaves, is_causal=True, enable_gqa=True).grad_fn).__name__
    del leaves
    return (lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                   enable_gqa=True), backend)


def decode_launch(src: str, knobs: dict, shape, sms: int) -> tuple:
    """(route, chunk, n_chunks, warps) of K6 at ``shape`` for a tree whose
    ``attention.cu`` reads ``src``: the checkout's rule for its route
    (``decode_attention.decode_route``) where the tree has the tensor-core
    kernel (its warps ``MMA_WARPS``, fixed in the kernel), else the
    cp.async ring's, with ``knobs``' warps a block and share of the
    SMs its split aims for."""
    from repro_torch.kernels import decode_attention as da

    b, h, g, s, d = shape
    hg = h // g
    if "decode_mma" in src and da.decode_route(torch.bfloat16, d, hg) == "mma":
        chunk, nch = da.mma_launch_shape(b, g, s, d, sms)
        return "mma", chunk, nch, da.MMA_WARPS
    blocks = b * g * -(-hg // da.heads_per_block(hg))
    chunk, nch = da.chunking(b, blocks // b, s, d,
                             int(sms * knobs.get("target", 0.5)))
    warps = knobs.get("warps", da.launch_shape(b, g, hg, s, d, sms)[2])
    return "ring", chunk, nch, warps


def decode_calls(libs, trees, edits, stream, shape) -> tuple:
    """({tree: call}, {tree: {"share": share of the bf16 tolerance,
    "route", "chunk", "n_chunks", "warps"}}) of K6 (bf16) at ``shape``
    and ``DECODE_LENGTH`` through each tree's C entry, each with its own
    partials and counters; a knockout's share says how wrong it is."""
    b, h, g, s, d = shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3579)
    rnd = lambda *dims: torch.randn(dims, generator=gen,
                                    device="cuda").bfloat16()
    q, k, v = rnd(b, h, d), rnd(b, g, s, d), rnd(b, g, s, d)
    lens = torch.full((b,), DECODE_LENGTH, dtype=torch.int32, device="cuda")
    want = ref.decode_attention_ref(q.float(), k.float(), v.float(),
                                    length=lens)
    calls, info = {}, {}
    for tree, csrc in trees.items():
        knobs = {}
        for e in edits.get(tree, ()):
            knobs.update(DECODE_KNOBS.get(e, {}))
        route, chunk, nch, warps = decode_launch(
            (Path(csrc) / "attention.cu").read_text(), knobs, shape, sms)
        f = libs[(tree, "attention")].repro_decode_attention
        out = torch.empty_like(q)
        pm = torch.empty((b, h, nch), device="cuda")
        pl = torch.empty_like(pm)
        pacc = torch.empty((b, h, nch, d), device="cuda")
        cnt = torch.zeros(b * h, dtype=torch.int32, device="cuda")

        def call(f=f, out=out, pm=pm, pl=pl, pacc=pacc, cnt=cnt, chunk=chunk,
                 nch=nch, warps=warps):
            return f(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
                     out.data_ptr(), pm.data_ptr(), pl.data_ptr(),
                     pacc.data_ptr(), cnt.data_ptr(), b, h, g, s, d, 1, chunk,
                     nch, warps, 0, d ** -0.5, stream)

        if call() != 0:
            sys.exit(f"{tree}: repro_decode_attention failed at {shape}")
        torch.cuda.synchronize()
        info[tree] = {"share": tol_share(out, want, FWD_TOL), "route": route,
                      "chunk": chunk, "n_chunks": nch, "warps": warps}
        calls[tree] = call
    return calls, info


def sdpa_decode_call(shape):
    """One call of SDPA on :func:`decode_calls`' inputs (the query as one
    row over the cache's first ``DECODE_LENGTH`` rows, ``enable_gqa``)
    -> (call, the backend it ran, read off the graph of one call on
    inputs that require grad)."""
    import torch.nn.functional as F

    b, h, g, s, d = shape
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3579)
    rnd = lambda *dims: torch.randn(dims, generator=gen,
                                    device="cuda").bfloat16()
    q, k, v = rnd(b, h, d), rnd(b, g, s, d), rnd(b, g, s, d)
    q = q[:, :, None]
    k, v = (t[:, :, :DECODE_LENGTH].contiguous() for t in (k, v))
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    backend = type(F.scaled_dot_product_attention(
        *leaves, enable_gqa=True).grad_fn).__name__
    del leaves
    return (lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True),
            backend)


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
    trees, tree_edits = {"tree": _build.CSRC}, {}
    for item in args.trees:
        name, _, path = item.partition("=")
        path, *edits = path.split("+")
        path = _build.CSRC if path == "tree" else Path(path)
        trees[name] = (edited(path, edits, Path(args.out) / f"csrc_{name}")
                       if edits else path)
        tree_edits[name] = edits
    lib_names = sorted({lib for g in args.only for lib in GROUP_LIBS[g]})
    libs = build(trees, Path(args.out), lib_names)
    stream = torch.cuda.current_stream().cuda_stream
    result = {"device": torch.cuda.get_device_name(0)}
    if "codec" in args.only:
        result["codec"] = time_codec(libs, trees, args.rounds, stream)
    if "ssm" in args.only:
        time_ssm(libs, trees, args.rounds, stream, result)
    if "fwd" in args.only:
        result["flash_attention"] = []
        for shape in FWD_SHAPES:
            calls, shares = fwd_calls(libs, trees, stream, shape)
            for tree, sh in shares.items():
                print(f"K5 {shape} {tree}: share of the tolerances used, "
                      + ", ".join(f"{k} {v:.4f}" for k, v in sh.items()))
            calls["sdpa"], backend = sdpa_fwd_call(shape)
            print(f"K5 {shape}: SDPA's forward runs {backend}", flush=True)
            result["flash_attention"].append({
                "shape": list(shape), "tol_share": shares,
                "sdpa_backend": backend,
                "ms": rounds(calls, args.rounds, f"K5 {shape}")})
            del calls
    if "bwd" in args.only:
        result["flash_attention_bwd"] = []
        for shape in BWD_SHAPES:
            calls, shares = bwd_calls(libs, trees, stream, shape)
            for tree, share in shares.items():
                print(f"K5 bwd {shape} {tree}: share of the bf16 tolerance "
                      f"used {share:.4f}")
            split = {}
            for tree, call in calls.items():
                split[tree] = launch_split(call)
                print(f"K5 bwd {shape} {tree}: trace, ms a launch: " + ", ".join(
                    f"{k} {v:.5f}" for k, v in split[tree].items()), flush=True)
            sdpa, backend = sdpa_bwd_call(shape)
            calls["sdpa"] = sdpa
            ms = rounds(calls, args.rounds, f"K5 bwd {shape}")
            print(f"K5 bwd {shape}: SDPA's backward ran {backend}", flush=True)
            result["flash_attention_bwd"].append({
                "shape": list(shape), "tol_share": shares, "split": split,
                "sdpa_backend": backend, "ms": ms})
            del calls, sdpa
    if "decode" in args.only:
        result["decode_attention"] = []
        for shape in DECODE_SHAPES:
            calls, info = decode_calls(libs, trees, tree_edits, stream, shape)
            for tree, x in info.items():
                print(f"K6 {shape} {tree}: {x['route']}, chunk {x['chunk']} x "
                      f"{x['n_chunks']}, {x['warps']} warps; share of the bf16 "
                      f"tolerance used {x['share']:.4f}")
            calls["sdpa"], backend = sdpa_decode_call(shape)
            b, h, g, s, d = shape
            nbytes = 2 * (2 * b * g * DECODE_LENGTH * d + 2 * b * h * d)
            bound = max(nbytes / HBM_BYTES_PER_S,
                        4 * b * h * DECODE_LENGTH * d / BF16_OPS_PER_S) * 1e3
            print(f"K6 {shape}: SDPA runs {backend}; bound {bound:.5f} ms",
                  flush=True)
            result["decode_attention"].append({
                "shape": list(shape), "length": DECODE_LENGTH, "launch": info,
                "sdpa_backend": backend, "bound_ms": bound,
                "ms": rounds(calls, args.rounds, f"K6 {shape}")})
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
