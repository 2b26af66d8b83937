#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's write -> read, serve and train paths, the
main path as one program, the skim, the meshed step, the dry-run and its
kernel API on one NVIDIA card.

    python3 chip_smoke.py [--entries 1000000] [--producers 4] [--seed 0]
                          [--requests 16] [--prompt-len 1000] [--max-new 64]
                          [--profile DIR]

Phases, in order; any failure exits non-zero:

1. the card (``nvidia-smi`` name and power limit) and the build of every
   CUDA kernel from ``src/repro_torch/csrc`` (nvcc, one per source), with
   ``ptxas``'s registers and spills of the tensor-core K5, of K6 (its
   ring and its tensor-core route ``decode_mma``), of K1,
   of K2's and K3's register forms, of K4's cluster kernel, of the chunked
   routes of K7 and K8, of K5's backward (head dims 32 to 256, and q/k 96
   with v 64) and of K7's and K8's backward, and a line each for head dim
   256's backward kernels and the forward's split route (registers,
   stack, serialized ``wgmma``);
2. every kernel against its plain PyTorch version on the card: K1-K4 bit
   for bit at ragged shapes and at the paper configuration's page shapes
   (K1 up to 2^24 values; K2 at the write path's four page shapes in
   every element width 1, 2, 4 and 8 and at a per that is no multiple of
   16; K4 at the read path's shapes, at a per that is no multiple of its
   cluster's round and at one page of 2^20; both also on unaligned
   views), K1 also over 200 calls in a row, with wrapping
   sums, and under 4 concurrent callers on one stream, on a stream each
   and through its host entry;
   K9 (single-buffer byteshuffle, K2's code) bit for bit at element
   widths 1, 2, 3, 4, 8 and 16 x N of 1 to 1,000,003 and at its phase-5
   and phase-6 shapes, K10 (delta + zigzag) in int32 and
   int64 at N of 1 to 1,000,003 over the whole range with the extremes,
   both also on unaligned views;
   K5 (flash attention: bf16 on the tensor cores, fp32 on the CUDA cores)
   and K6 (decode attention) at ragged shapes, GQA, MQA and MHA, head
   dims 32 to 256 (80: zamba2's shared attention), K5 also at q/k 96 with
   v 64 (minicpm3-4b's MLA prefill), bf16's split route at 128 and 256
   (ragged, windowed, Sq < Sk, non-causal, fewer work tiles than SMs, a
   partial last round), Sk under one kv tile,
   Sq of 1 and 129 against 1,000, windows, lengths from 1 to the cache,
   H/G of 1, 3 and 8, in fp32 (within 2e-5) and in
   bf16 (against the plain version computed in fp32 from the same bf16
   inputs, within 1.6e-2); K7 (RWKV-6 scan) and K8 (Mamba-2 SSD scan) at
   T of 1, 31, 32, 33 and 100 (16-step sub-chunks whole and ragged) and
   64, 65 and 129 (64-step chunks), state widths 16 to 128 with 48, Dv
   and P of 40 to 1,024 and at the serve shapes, K7 with strong decay
   and with decays of exactly 0 (at Dk 16, 48, 64 and 128), K8 with log_a
   of -inf and down to -1e4 (finite), output and final state, fp32
   within 1e-4 and bf16 outputs within 1e-2; each as ``|got - want| <=
   tol * (1 + |want|)``;
3. the write -> read path: the paper's configuration written by
   ``ParallelWriter`` on the card (``--producers`` threads, ``--entries``
   each, fill batches of 100,000), read back with
   ``RNTJReader.iter_clusters_device``, every column checked against the
   generated data and the reader's host decode; the launch counts of
   K1-K4 must be > 0; then one producer's data written once with the
   kernels and once with the numpy backend: the files must be
   byte-identical;
4. the serve path: ``repro_torch.launch.serve`` with smollm-360m,
   gemma-2b (head dim 256 over one kv head), rwkv6-7b, zamba2-2.7b,
   minicpm3-4b (MLA), deepseek-moe-16b (MoE),
   musicgen-large (4 codebooks), chameleon-34b and mixtral-8x22b (MoE,
   a window), one after another, each at its full width and its full
   depth but for ``SERVE_DEPTH`` (chameleon-34b and mixtral-8x22b: their
   parameters do not fit one card) (``--requests`` prompts of
   ``--prompt-len`` tokens, ``--max-new`` greedy tokens, bf16 compute, random weights from
   ``--seed``), each model freed before the next; the launch counts of
   each run alone must be K5 once per attention block in prefill and K6
   once per GQA attention block and decode step (every layer of an
   attention model, none for MLA's latent decode; zamba2: its 9 shared
   blocks), K7 once per rwkv6 layer and K8 once per Mamba-2 layer in
   prefill, and 0 for every other serve kernel; the generations file
   must read back equal to the returned tokens (musicgen: the first
   codebook); the decode-step logits are held against teacher-forced
   ``forward`` logits at the same positions, computed over a few
   requests at a time: the served bf16 batch against the fp32 forward
   on its tokens (no farther from it than 1.5 times the bf16 forward, plus
   1e-2 of max |logit|), and a fresh fp32 generation of two requests
   against its own forward (within 1e-3).  A MoE model routes each
   call's sequences as its capacity groups, so its one-token decode
   drops other tokens than ``forward`` over prompt + generated tokens:
   there the served prefill's last-token logits are held against
   ``forward`` over the prompts at the published config (within 1e-2 of
   max |logit|, and as above against the fp32 forward), and the
   decode-vs-forward checks (bf16 and fp32, two requests) run under a
   capacity factor at which no bucket fills;
5. the kernels package's entry points: each of the nine op entries of
   ``repro_torch.kernels.ops`` called on CUDA tensors at the shapes of
   the reference's own sweep (``tests/test_kernels.py``), each result
   held against the plain version on the card (exact for the codec ops,
   ``ATTN_TOL``/``SCAN_TOL`` for attention and the scans); the launch
   counts of these calls alone must show K1 and K3-K10;
6. each kernel timed at the shape its path gave it most often: on the
   card (CUDA events between 30 launches queued back to back) and per
   call with its host overhead, beside its bound, its plain version and,
   where one exists, the one PyTorch call computing the same function
   (``scaled_dot_product_attention`` for K5 and K6, at smollm-360m's, at
   gemma-2b's and at zamba2-2.7b's head shapes, K6 also at chameleon-34b's
   and mixtral-8x22b's decode shapes (the tensor-core route at gemma-2b's
   and theirs), and K5 at minicpm3-4b's q/k 96, v 64, each with the SDPA
   backend it ran; none for K7 and K8); K9 and K10 at one
   cluster's column of phase 3 (250,000 entries) and at a 2^24-element
   buffer (``t().contiguous()`` the library call of K9, none for K10);
   K1 also at 1,100,003 and 2^24 values beside ``torch.cumsum``; K2 also
   at (91, 16384, 4) and K4 at (12, 8, 8192), the other shape each path
   gives it, and both at a near-empty shape, their launch floor;
   the host entries of K1, K2 and K9 with their PCIe copies;
7. the train path: ``synth_corpus(8000, mean_len=512, vocab=49152)``
   (about 4.9 M tokens) ingested by 4 workers on the card; one epoch and
   a wrap of ``PackedLoader(8, 1024)``'s device engine held token for
   token against its host engine, and again after a mid-cluster
   ``load_state``; K5's forward with its rows' LSE (the output within
   its K5 tolerance, the LSE within 2e-5) and its backward on that output
   and LSE against their plain versions in fp32
   (within 2e-5) and bf16 (within 1e-2, against the plain version in
   fp32 from the same bf16 inputs), each as ``|got - want| <= tol (1 +
   |want|)``, at the training shapes (8, 15, 5, 1024, 1024, 64) and (8,
   8, 1, 1024, 1024, 256), phase 10 (b)'s (deepseek-moe-16b (8, 16,
   16, 1024, 1024, 128), mixtral-8x22b (8, 48, 8, 1024, 1024, 128, window
   4096), chameleon-34b (8, 64, 8, 1024, 1024, 128), musicgen-large (8,
   32, 32, 1024, 1024, 64), minicpm3-4b (8, 40, 40, 1024, 1024, q/k 96,
   v 64), zamba2-2.7b (8, 32, 32, 1024, 1024, 80)), with a window, at a
   ragged Sq, at head dims 32, 80, 128 and 256 (ragged and windowed) and
   at 96 / 64 ragged and windowed; K7's and K8's backward
   (``rwkv6_scan_bwd``, ``mamba2_ssd_bwd``) against their plain versions
   with the same tolerances (the fp32 route against the plain version in
   fp64, the bf16 route against it in fp32, from the same input values)
   at every case of phase 2's scans (T of 1 and
   ragged, every state width, decays of exactly 0, log_a of -inf) and at
   the training shapes (8, 64, 1024, 64, 64) and (8, 80, 1024, 64, 64),
   every other case with a cotangent of the final state; every parameter of
   smollm-360m at its full size gets a finite, non-zero gradient on a
   first batch (its steps run through the loop in phase 9 (a)); then
   gemma-2b at its full width and depth (18 layers, 8 query
   heads over 1 kv head of 256, vocab 256,000) on the same loader at the
   largest batch of 8, 4, 2, 1 that fits: one untimed and 5 timed AdamW
   steps, K5 exactly 36 and its backward 18 times a step at gemma's
   shape, losses finite and falling, step ms, tokens/s, peak memory and a
   profiled step's busy share; K5's backward timed at both training
   shapes in bf16 beside its bound, its plain version and SDPA's backward
   (the backend it ran), each of its two launches and SDPA's from a
   trace, and K5's forward there with and without its LSE beside SDPA's
   forward; one JSON ``kernels`` line of the
   ten kernels and the backwards of K5, K7 and K8 (K1's, K5's, K6's and
   K8's rows name the ``design`` they timed, as do K2's, K4's and K9's);
8. multi-process writing and the checkpoint: (a) a
   ``MultiWriterCoordinator`` and ``--producers`` participant processes
   (started with ``spawn``), each joining the file on the card with
   ``--entries`` of phase 3's data in fill batches of 100,000 and reporting
   its own K1 and K2 launch counts (both must be > 0 in every child): a
   clean seal (nothing fenced, the side-car log unlinked), every child's
   exit code 0, the device read-back equal to the generated data as a
   multiset with K3 and K4 > 0, and the write's MB/s beside phase 3's
   threads; (b) two participants of 300,000 entries, one of which calls
   ``os._exit`` after its first batch and ``flush_cluster``: one writer fenced, the live
   writer's entries complete, the dead one's a prefix of its commit
   order; then a copy of a file whose coordinator was dropped before its
   seal, opened by a tolerant reader and rebuilt by ``recover_container``
   with the same entries; (c) ``merge_files`` of two one-producer files on
   the card, verbatim and with ``recompress=True`` (K1 and K2 > 0), each
   byte-identical to the same merge on the numpy backend; (d) one producer
   to ``mem-s3://``: the object equal to the same write to a file, read
   back equal (K1-K4 > 0); (e) inside phase 9 (a), on its loop after the
   restart check: the loop's train state (``params``, ``opt {step, m,
   v}``, ``err``, ``loader {entry_cursor, leftover}``, about 4.9 GB)
   saved by ``CheckpointManager`` with 2 spawned processes (the loop's
   own save is 4 writer threads), restored by a fresh ``TrainLoop`` and
   loader on the same mesh equal to the live state bit for bit (dtype,
   shape, device), its loader where the live one stands, and one step of
   each loop equal bit for bit (loss, parameters and moments); save and
   restore seconds, MB/s and file size with the card's name and power
   limit; (f) the chaos driver ``repro_torch.launch.chaos`` on the card
   (its 800 entries from ``--seed``) with ``REPRO_TORCH_OFFSETS_MIN`` and
   ``REPRO_TORCH_SHUFFLE_MIN`` at 0 (restored after), every scenario in
   this process and held to its invariants by the driver (the ``mpkill``
   matrix whole: 18 cells of 2 and 4 writer processes, forked by the
   driver's fork server, and the straggler): K1 and K2 > 0 in each
   scenario's writes (the children's own counts for ``mpkill`` and
   ``mprecover``), K3 and K4 > 0 in each that reads a salvaged or
   recovered file back on the card, ``kill``'s salvage list equal to the
   same scenario on the numpy backend, then
   ``python -m repro_torch.launch.chaos --scenario mprecover`` as a
   subprocess; each scenario's seconds;
9. the main path as one program and the skim: (a) ``repro_torch.launch.
   train.main`` trains smollm-360m at full width and depth (fp32
   parameters, bf16 compute, remat) on its one-rank NCCL mesh on phase
   7's corpus, (8, 1024) batches, 15 steps with the loop's async
   checkpoint (4 writer threads) at step 10: launches K5 = 2 x 32 x 15,
   its backward 32 x 15, K3 and K4 > 0 and nothing else; losses finite
   and falling; the train step's ms (the mean of steps 1-10, no save in
   flight), tokens/s, peak memory; a fresh loader and loop restore step
   10 and their 5 steps equal the first loop's steps 11-15 bit for bit
   (losses, parameters, moments), reading no cluster where the restored
   leftover holds their batches; step ms with the save in flight, the
   hand-off ms, the end's wait, the restore seconds, straggler events;
   then 8 (e), and one more step under torch.profiler (card busy share,
   time by kernel); (b) ``repro_torch.launch.quickstart`` at
   its own sizes (gemma-2b's smoke config): exact launches, K5's backward
   at head dim 32, the restart at step 30, the generations file equal to
   the tokens; (c) ``make_agc_dataset`` builds 9 partitions x 4 files x
   250,000 events on the card (K1 3 a file, K2 > 0) and
   ``skim_partitions`` runs all five strategies with pushdown and ``imt``
   and ``parallel`` without, 8 threads each: equal ``kept_events``, each
   partition's sorted events equal across runs, ``imt``'s files (K2 > 0)
   byte-identical to the numpy backend's; seconds, input and output MB;
10. the mesh and the families that train since ``distributed``: (a)
   smollm-360m at full size, 5 steps from ``--seed`` on phase 7's corpus
   through the loop without a mesh and through ``launch.train`` on
   ``make_local_mesh(device="cuda")`` (a one-rank NCCL group, mesh
   (data=1, model=1)): losses, parameters, moments and the optimizer's
   step equal bit for bit, the same K5 and K5-backward launches, the
   losses phase 9 (a)'s first five; (b) deepseek-moe-16b, mixtral-8x22b,
   chameleon-34b, musicgen-large, minicpm3-4b (MLA), rwkv6-7b and
   zamba2-2.7b at full width, each at the deepest
   depth whose dry-run peak of a step at (8, 1024) stays under 72 GiB
   (``family_depth``), 3 AdamW steps (fp32 parameters, bf16 compute,
   remat, ``launch.train``'s warm-up) on phase 7's loader (ids modulo
   the vocabulary; musicgen's 4 codebooks as shifted copies): the
   dry-run's state bytes
   within 2 % of ``memory_allocated`` after ``init_train_state``, K5, K7
   or K8 twice and its backward once a layer and step (zamba2-2.7b's
   shared attention blocks K5 once) and nothing else, losses
   finite and falling, the MoE balance loss finite and the first step's
   equal to a fresh forward's (1e-5 relative; 0 without MoE), peak memory
   beside the dry-run's; (c) ``python -m repro_torch.launch.dryrun --all
   [--multi-pod]``, one child process a mesh on the host (started before
   (a), kept off the card): 80 records, none ``error``, the counts and the
   seconds; the new paths' K5, K7 and K8 launches and their backwards'
   join the ``kernels`` line; K5's backward is timed at the training
   shapes of chameleon-34b (head dim 128), minicpm3-4b (q/k 96, v 64) and
   zamba2-2.7b (head dim 80) in bf16 beside its bound, its plain version
   and SDPA's backward (the backend that ran; ``at_<arch>`` of its row),
   and K7's and K8's backward (rows of their own) at rwkv6-7b's and
   zamba2-2.7b's (30 launches queued, the plain version, the bound; no
   library call computes them; the launch's workspace as the C library
   sizes it equal to the dry-run's count, which its peaks include).
   NCCL refuses two ranks on one card: multi-rank meshes are held on the
   CPU over gloo (``tests/test_torch_distributed.py``);
11. the last line: ``{"ok": true, "device": {...}}``.

``--profile DIR`` also traces one read-back, one single-producer write,
and each served batch's prefill and 8 of its decode steps with
torch.profiler (the card's busy share; chrome traces in DIR).  Needs a
CUDA card and the repository's ``src/`` beside this file.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM memory rate, peak integer/float32 rate outside the tensor
#: cores and dense bf16 tensor-core rate (NVIDIA data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12

BATCH = 100_000

#: the card's name and power limit as ``nvidia-smi`` gives them (set in
#: phase 1), written beside the checkpoint's timings
CARD = "not read"

KERNEL_INFO = {
    # no pallas_call: the reference differentiates the op entry (on the
    # CPU the jnp oracle at src/repro/kernels/ref.py:77)
    "flash_attention_bwd": ("src/repro_torch/csrc/attention_bwd.cu",
                            "src/repro/kernels/flash_attention.py:82"),
    "offsets_scan": ("src/repro_torch/csrc/scans.cu",
                     "src/repro/kernels/offsets_scan.py:42"),
    "byteshuffle_pages": ("src/repro_torch/csrc/byteplanes.cu",
                          "src/repro/kernels/byteshuffle.py:51"),
    "unsplit_pages": ("src/repro_torch/csrc/byteplanes.cu",
                      "src/repro/kernels/decode_pages.py:46"),
    "decode_offset_pages": ("src/repro_torch/csrc/scans.cu",
                            "src/repro/kernels/decode_pages.py:97"),
    "flash_attention": ("src/repro_torch/csrc/attention.cu",
                        "src/repro/kernels/flash_attention.py:82"),
    "decode_attention": ("src/repro_torch/csrc/attention.cu",
                         "src/repro/kernels/decode_attention.py:71"),
    "rwkv6_scan": ("src/repro_torch/csrc/ssm.cu",
                   "src/repro/kernels/rwkv6_scan.py:82"),
    "mamba2_ssd": ("src/repro_torch/csrc/ssm.cu",
                   "src/repro/kernels/mamba2_ssd.py:70"),
    "byteshuffle": ("src/repro_torch/csrc/byteplanes.cu",
                    "src/repro/kernels/byteshuffle.py:27"),
    "delta_zigzag": ("src/repro_torch/csrc/scans.cu",
                     "src/repro/kernels/delta_zigzag.py:38"),
    # no pallas_call: the reference differentiates the op entries (on the
    # CPU the jnp oracles at src/repro/kernels/ref.py:202 and :253)
    "rwkv6_scan_bwd": ("src/repro_torch/csrc/ssm.cu",
                       "src/repro/kernels/rwkv6_scan.py:82"),
    "mamba2_ssd_bwd": ("src/repro_torch/csrc/ssm.cu",
                       "src/repro/kernels/mamba2_ssd.py:70"),
}

#: which kernel design each phase-6 row times (K5, its backward, K7 and
#: K8 pick by dtype: their timed rows are bf16)
KERNEL_DESIGN = {
    "offsets_scan": {"int64": "single-pass look-back"},
    "byteshuffle_pages": {"uint8": "16 elements a thread, warp-staged loads, "
                                   "prmt transpose, 16-byte plane stores"},
    "decode_offset_pages": {"uint8": "one thread-block cluster per page"},
    "byteshuffle": {"uint8": "K2's register form, one page"},
    "flash_attention": {"bfloat16": "wgmma+tma; persistent blocks over "
                                    "128-row work tiles, head by head in "
                                    "a snake order where K and V outgrow "
                                    "the L2 (or under four rounds), else "
                                    "the longest causal tiles of every "
                                    "head first; at D = 128 and 256 the "
                                    "split route: a stage's K and V on "
                                    "barriers of their own (each K freed "
                                    "with the tile before's V, so the "
                                    "next tile's K and V load a step "
                                    "ahead), O stored by TMA from the "
                                    "work tile's Q buffer",
                        "float32": "simt fp32"},
    # K5's narrow-v form (MLA), timed in its own nested row
    "flash_attention q/k 96, v 64": {
        "bfloat16": "wgmma+tma; q/k in a 64-wide 128-byte-swizzled and a "
                    "32-wide 64-byte-swizzled block, v one 64-wide block, "
                    "P V 64 wide; work tiles head by head in a snake "
                    "order (K and V, 105-205 MB, read once a head)",
        "float32": "simt fp32"},
    "flash_attention_bwd": {"bfloat16": "two launches (dQ; dK and dV), "
                                        "wgmma + TMA, a consumer warpgroup "
                                        "and a producer warp a block, P from "
                                        "the forward's LSE, P and dS in two "
                                        "bf16 pieces; at D = 80, 128 and "
                                        "q/k 96 with v 64 the "
                                        "pair route: each launch one "
                                        "persistent block an SM over "
                                        "128-row items in snake order, two "
                                        "consumer warpgroups of 64 rows and "
                                        "a producer warpgroup (setmaxnreg "
                                        "24 / 240), resident tiles in two "
                                        "slots, 80- and 96-wide tiles as "
                                        "16- and 32-wide blocks (each "
                                        "product one wgmma of N = D); at "
                                        "D = 256 each launch one "
                                        "persistent block an SM whose two "
                                        "consumer warpgroups split a "
                                        "64-row tile by role (one forms S "
                                        "and P and hands P over in fp32 "
                                        "through shared memory, the other "
                                        "dP and dS; dK/dV: dV += P^T dO in "
                                        "one, dK += dS^T Q in the other, "
                                        "each one N = 256 wgmma a piece; "
                                        "dQ: 128 columns each, dS's pieces "
                                        "in shared memory), items longest "
                                        "first in snake order, an even "
                                        "group's heads over two blocks a "
                                        "kv tile of which the second to "
                                        "finish adds the first one's fp32 "
                                        "sums (a ticket counter)",
                            "float32": "two launches, simt fp32, P from the "
                                       "forward's LSE"},
    "decode_attention": {"bfloat16": "D = 128 and 256 with 4-8 query heads "
                                     "a kv group: mma.sync + TMA (16-row "
                                     "slices, a TMA ring a warp, the heads "
                                     "as N = 8, P^T by movmatrix, one "
                                     "wave of one block an SM "
                                     "(mma_launch_shape)); else cp.async "
                                     "ring",
                         "float32": "cp.async ring"},
    "rwkv6_scan": {"bfloat16": "chunked split-bf16 mma, state every 16 steps",
                   "float32": "simt steps"},
    "mamba2_ssd": {"bfloat16": "chunked split-bf16 mma",
                   "float32": "simt steps"},
    "rwkv6_scan_bwd": {
        "bfloat16": "chunked reverse scan on mma: the state stored every 16 "
                    "steps by a first launch; a block per (b, h) and 64 state "
                    "columns walks the 16-step sub-chunks last to first with "
                    "dS in mma accumulators (dv, dS, X, Y, D as split-bf16 "
                    "mma on the forward's rP, K', A), dr, dk and dw per "
                    "channel in Horner form (dw direct, nothing divided); a "
                    "last launch sums du",
        "float32": "simt reverse scan: a block per (b, h) and 32 state "
                   "columns, a thread a state row, the state stored every 16 "
                   "steps and each step's recomputed from its chunk's; a "
                   "second launch adds the blocks' partial sums in a fixed "
                   "order"},
    "mamba2_ssd_bwd": {
        "bfloat16": "chunked on mma: a first launch walks the 64-step "
                    "chunks forward for H and backward for dH in mma "
                    "accumulators, storing both at every chunk boundary; a "
                    "block per (chunk, 8 heads) then takes dX, dB, dC and "
                    "dlog_a (direct form, box sums in fp32) as split-bf16 "
                    "mma, C B^T shared by the heads, the next head's inputs "
                    "landing by cp.async; a last launch sums dB and dC over "
                    "the head groups in a fixed order",
        "float32": "simt reverse scan: a block per (b, h) and 32 state "
                   "columns, a thread a state row, the state stored every 16 "
                   "steps and each step's recomputed from its chunk's; a "
                   "second launch sums dB and dC over the heads in a fixed "
                   "order"},
}

#: the served models, in the order they run: each at its full width and
#: depth (but for ``SERVE_DEPTH``), the dense family (K5, K6; gemma-2b at
#: head dim 256 over one kv head), rwkv6 (K7), the zamba2 hybrid (K8, and
#: K5/K6 at head dim 80 in its shared attention blocks), MLA (K5 at q/k
#: 96, v 64; a latent decode without K6), MoE, 4 codebooks, qk-norm, MoE
#: with a window
SERVE_ARCHS = ("smollm-360m", "gemma-2b", "rwkv6-7b", "zamba2-2.7b",
               "minicpm3-4b", "deepseek-moe-16b", "musicgen-large",
               "chameleon-34b", "mixtral-8x22b")
#: depth cuts of the served models whose fp32 parameters do not fit one
#: card whole: chameleon-34b (48 layers, 127.8 GiB) and mixtral-8x22b (56
#: layers, 523.9 GiB) at full width and this many layers
SERVE_DEPTH = {"chameleon-34b": 8, "mixtral-8x22b": 2}

#: K5/K6 tolerances against the plain version (see the docstring)
ATTN_TOL = {"float32": 2e-5, "bfloat16": 1.6e-2}
#: K7/K8 tolerances against the plain version, as |got - want| <= tol (1 +
#: |want|): fp32 results (the outputs of fp32 inputs, and every final
#: state) within 1e-4, the same step-by-step recurrence with fused
#: multiply-adds and the sums over the state rows in another order,
#: compounding over up to 1,000 steps; bf16 outputs against the plain
#: version computed in fp32 from the same bf16 inputs within 1e-2 (the
#: output rounds to bf16: 2^-9 relative)
SCAN_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
#: the serve path's decode-step logits against teacher-forced ``forward``
#: logits at the same positions, as a share of the largest |logit|.  In
#: fp32 only the order of the sums differs: within 1e-3.  In bf16 the two
#: paths round to 8 mantissa bits at different places (GEMMs of 16 rows
#: against 16,000, K6 against K5, the one-token recurrences against K7 and
#: K8), and random weights amplify a perturbation through the layers (in
#: fp32, sum-order noise of ~1e-7 reaches 6e-6 of max |logit| after
#: rwkv6-7b's 32 layers): a fixed bound would measure that amplification.
#: So bf16 decode logits are held against the fp32 forward on the same
#: tokens: no farther from it than 1.5 times the bf16 forward's own
#: distance from it, plus 1e-2.
CONSISTENCY_TOL = {"float32": 1e-3}
BF16_SPREAD, BF16_SLACK = 1.5, 1e-2
#: the teacher-forced forwards of the consistency checks run over this
#: many requests' logits at a time at most (deepseek-moe-16b's 16 x 1,064
#: x 102,400 fp32 logits are 7 GB beside 62.9 GiB of parameters)
LOGIT_CHUNK_BYTES = 1 << 31


def fail(msg: str) -> "NoReturn":
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# inputs of each kernel, made on the card from a seed


def kernel_input(torch, name: str, shape, gen, dtype=None):
    """A realistic input of ``shape`` for kernel ``name`` on the card
    (``dtype``: K10's int32 or int64)."""
    dev = "cuda"
    if name == "delta_zigzag":
        # values over the whole range of the type, with its extremes and
        # their neighbours at every 97th position
        (n,) = shape
        info = torch.iinfo(dtype)
        hi, lo = torch.randint(0, 2**32, (2, n), dtype=torch.int64,
                               device=dev, generator=gen)
        x = ((hi << 32) | lo if dtype == torch.int64 else lo - 2**31).to(dtype)
        edges = torch.tensor([info.min, info.min + 1, info.max - 1, info.max,
                              -1, 0, 1], dtype=dtype, device=dev)
        x[::97] = edges.repeat(-(-n // (97 * len(edges))))[:len(x[::97])]
        return x
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

    The plain versions of K1-K3 and K9 are each one PyTorch call, named
    here: their time is the library call's time.  K4 and K10 have no such
    call."""
    from repro_torch.kernels import ref

    return {
        "byteshuffle": (kernels.byteshuffle.byteshuffle,
                        ref.byteshuffle_ref, "t().contiguous()"),
        "delta_zigzag": (kernels.delta_zigzag.delta_zigzag,
                         ref.delta_zigzag_ref, None),
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


def bound(name: str, shape, itemsize: int = 1):
    """(bound_ms, bound_by, bytes) of one launch: each input byte read
    once, each output byte written once, over the memory rate; the
    operations over the scalar rate; the larger of the two.  ``itemsize``:
    K10's element width."""
    if name == "offsets_scan":
        (n,) = shape
        nbytes, ops = 16 * n, n
    elif name == "byteshuffle":
        n, nb = shape
        nbytes, ops = 2 * n * nb, 0
    elif name == "delta_zigzag":
        # a subtraction, two shifts and a xor per element
        (n,) = shape
        nbytes, ops = 2 * n * itemsize, 4 * n
    elif name == "decode_offset_pages":
        p, _, per = shape
        # the low four planes are all the function needs; int32 out
        nbytes, ops = 4 * p * per + 4 * p * per, 8 * p * per
    else:
        p, a, b = shape
        nbytes, ops = 2 * p * a * b, 0
    return _larger(nbytes, ops, SCALAR_OPS_PER_S)


def _larger(nbytes: float, ops: float, ops_per_s: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes)


def attention_bound(name: str, shape, itemsize: int, length=None):
    """(bound_ms, bound_by, bytes) of one K5 or K6 launch on this run's
    inputs: q, k, v read once and o written once over the memory rate;
    ``2 (D + Dv)`` operations per visible (query, key) pair (QK^T over D,
    PV over Dv) over the bf16 tensor-core rate.  K5 counts the causal
    pairs (``q_offset = Sk - Sq``), K6 the ``length`` cache rows it
    reads."""
    if name == "flash_attention":
        b, h, g, sq, sk, d, dv = shape
        off = sk - sq
        pairs = sum(max(0, min(sk, i + off + 1)) for i in range(sq))
        ops = 2 * b * h * (d + dv) * pairs
        nbytes = itemsize * (b * h * sq * (d + dv) + b * g * sk * (d + dv))
    else:
        b, h, g, _s, d = shape
        ops = 4 * b * h * length * d
        nbytes = itemsize * (2 * b * g * length * d + 2 * b * h * d)
    return _larger(nbytes, ops, BF16_TENSOR_OPS_PER_S)


#: the signed view of each unsigned result, for comparisons on the card
SIGNED_VIEW = {"uint32": "int32", "uint64": "int64"}


def max_abs_err(torch, a, b) -> float:
    """Largest |a - b| of two integer tensors of one dtype and shape (inf
    when those differ).  uint32/uint64 results (K10) are compared by the
    equality of their signed views; only where they differ is the gap
    taken, in Python integers, so no difference overflows."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return float("inf")
    if not a.numel():
        return 0.0
    signed = SIGNED_VIEW.get(str(a.dtype).replace("torch.", ""))
    if signed is None:
        return float((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())
    av, bv = a.view(getattr(torch, signed)), b.view(getattr(torch, signed))
    if torch.equal(av, bv):
        return 0.0
    bits = 8 * a.element_size()
    diff = av != bv
    return float(max(abs((x % 2**bits) - (y % 2**bits)) for x, y in
                     zip(av[diff].tolist(), bv[diff].tolist())))


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
    time the kernels, not the host's rate of launching them.  The sleep
    only delays the first event, so a long one costs nothing but wall
    time; an enqueue that still outlasts it (a stall of the shared host)
    is measured again, up to three times."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    # the enqueue's expected length, 10x over, plus 20 ms for host stalls
    sleep_ms = 10 * host_ms * reps + 20
    for _attempt in range(3):
        torch.cuda.synchronize()
        # >= 2e6 cycles per ms at the H100's clocks (at most 1.98 GHz)
        torch.cuda._sleep(int(2e6 * sleep_ms))
        t0 = time.perf_counter()
        for i in range(reps):
            events[i].record()
            fn(x)
        events[reps].record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if enqueue_ms < sleep_ms:
            return statistics.median(events[i].elapsed_time(events[i + 1])
                                     for i in range(reps))
        log(f"enqueue ({enqueue_ms:.3f} ms) outlasted the sleep "
            f"({sleep_ms:.3f} ms): timing again")
    fail("the enqueue outlasted the sleep three times: the device timing "
         "would measure the host")


#: sizes past the write path's batches at which phase 6 also times K1
#: against ``torch.cumsum`` (phase 2 checks K1 there)
OFFSETS_TIMED = (1_100_003, 1 << 24)


def time_offsets_sizes(torch, kern, plain, gen) -> list:
    """K1 and its plain version, ``torch.cumsum``, on the card at each of
    ``OFFSETS_TIMED``, beside the bytes bound."""
    out = []
    for n in OFFSETS_TIMED:
        x = kernel_input(torch, "offsets_scan", (n,), gen)
        if not torch.equal(kern(x), plain(x)):
            fail(f"offsets_scan at ({n},) differs from torch.cumsum")
        ms = device_ms(torch, kern, x, call_ms(torch, kern, x))
        lib_ms = device_ms(torch, plain, x, call_ms(torch, plain, x))
        b_ms, b_by, _ = bound("offsets_scan", (n,))
        out.append({"n": n, "ms": ms, "library_ms": lib_ms,
                    "bound_ms": b_ms, "bound_by": b_by})
        log(f"offsets_scan at ({n},): card {ms:.5f} ms, torch.cumsum "
            f"{lib_ms:.5f} ms, bound {b_ms:.5f} ms by {b_by}")
    return out


#: the kernels whose registers and spills phase 1 prints (name fragments
#: of their mangled names)
PTXAS_KERNELS = ("wgmma", "decode_partial", "decode_mma", "scan_lookback",
                 "ssd_chunked",
                 "wkv_chunked", "shuffle_reg", "unsplit_reg",
                 "decode_offsets_cluster", "bwd_dq", "bwd_dkv", "wkv_bwd",
                 "ssd_bwd")


def ptxas_report(path) -> list:
    """``ptxas -v``'s registers and spills of the tensor-core and
    cp.async kernels (K5 and its backward, MLA's 96 / 64 instantiations
    among them, K6, the chunked routes of K7 and K8), of K7's and K8's
    backward, of K1, of K2's register form and of K4's cluster kernel, one
    line each, and every warning that ``wgmma`` runs serialized."""
    out, name = [], None
    for line in open(path, errors="replace").read().splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            name = fn if any(k in fn for k in PTXAS_KERNELS) else None
        elif "Performance Loss" in line:
            out.append(f"ptxas {line.split(':', 1)[-1].strip()}")
        elif name and ("spill" in line or "Used" in line):
            # the kernel's name and template arguments, past the mangled
            # anonymous namespace
            short = name.split("_cu_", 1)[-1][:80]
            out.append(f"ptxas {short}: {line.split(':')[-1].strip()}")
    return out


#: kernels whose ptxas figures phase 1 sums up, by what they are: head dim
#: 256's backward (attention_bwd) and the forward's split route
#: (attention, at D = 128 and 256, each work order); each role sets its
#: registers with setmaxnreg: the producer's 24, the consumers' 240
BWD256_KERNELS = ("bwd_dq_wgmma256", "bwd_dkv_wgmma256")
FWD_SPLIT_KERNELS = ("flash_fwd_wgmma_splitILi128ELb1",
                     "flash_fwd_wgmma_splitILi128ELb0",
                     "flash_fwd_wgmma_splitILi256ELb1",
                     "flash_fwd_wgmma_splitILi256ELb0")


def ptxas_summary(path, kernels=BWD256_KERNELS,
                  what="D = 256 backward") -> list:
    """One line per kernel of ``kernels`` from ``ptxas -v``'s log: its
    registers at launch (setmaxnreg gives its roles 24 and 240 after),
    its stack frame and spills, and whether ``ptxas`` warns that its
    ``wgmma`` runs serialized (C7512 and its kin)."""
    lines = open(path, errors="replace").read().splitlines()
    out = []
    for k in kernels:
        regs, frame, serial, inside = "?", "?", False, False
        for line in lines:
            if "Compiling entry function" in line:
                inside = k in line
            elif "Performance Loss" in line and k in line:
                serial = True
            elif inside and "stack frame" in line:
                frame = line.strip()
            elif inside and "Used" in line:
                regs = line.split("Used", 1)[1].split(",")[0].strip()
        out.append(f"ptxas {what} {k}: {regs} at launch, setmaxnreg 24 / "
                   f"240; {frame}; wgmma "
                   f"{'SERIALIZED' if serial else 'not serialized'}")
    return out


# ---------------------------------------------------------------------------
# phase 2: every kernel against its plain version


#: the kernels that phase 2 also holds on unaligned views (their scalar
#: routes)
UNALIGNED_CHECKED = ("byteshuffle_pages", "decode_offset_pages")


def check_kernels(torch, kernels, shapes, odd_views: bool = False) -> None:
    """Each kernel at each shape against its plain version, bit for bit;
    with ``odd_views`` also ``UNALIGNED_CHECKED``'s on an unaligned view
    of the same input."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    fns = kernel_fns(kernels)
    for name, shape_list in shapes.items():
        kern, plain, _ = fns[name]
        odd = odd_views and name in UNALIGNED_CHECKED
        for shape in shape_list:
            x = kernel_input(torch, name, shape, gen)
            got = kern(x)
            torch.cuda.synchronize()
            want = plain(x)
            err = max_abs_err(torch, got, want)
            if odd:
                err = max(err, max_abs_err(torch, kern(unaligned(torch, x)),
                                           want))
            if err != 0.0:
                fail(f"{name} at {tuple(shape)} differs from its plain "
                     f"version (max abs err {err})")
        log(f"kernel {name}: bit-identical to its plain version at "
            f"{len(shape_list)} shapes"
            + (" and on an unaligned view of each" if odd else ""))


def check_offsets_calls(np, torch, kernels) -> None:
    """K1 across calls: 200 calls in a row at lengths of 1 to 300,000
    (epochs and tickets carry over on one workspace), values over the
    whole int64 range (sums wrap as ``torch.cumsum``'s), and 4 threads x
    50 calls at once on the default stream, on a stream per thread and
    through the write path's host entry; all bit for bit."""
    scan = kernels.offsets_scan.offsets_scan
    host = kernels.offsets_scan.offsets_scan_host
    rng = np.random.default_rng(4321)

    def sizes(r, n, wrapping=False):
        if wrapping:
            return r.integers(-2**63, 2**63 - 1, n, dtype=np.int64,
                              endpoint=True)
        return r.poisson(5, n).astype(np.int64)

    for i in range(200):
        n = int(rng.integers(1, 300_000 if i % 3 else 5000))
        a = sizes(rng, n, i % 5 == 0)
        got = scan(torch.from_numpy(a).cuda()).cpu().numpy()
        if not np.array_equal(got, np.cumsum(a, dtype=np.int64)):
            fail(f"offsets_scan call {i} (n {n}) differs from np.cumsum")
    errors = []

    def worker(mode, seed):
        r = np.random.default_rng(seed)
        try:
            stream = (torch.cuda.Stream() if mode == "stream per thread"
                      else torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                for _ in range(50):
                    a = sizes(r, int(r.integers(1, 200_000)))
                    if mode == "host entry":
                        got = host(a, torch.device("cuda"))
                    else:
                        got = scan(torch.from_numpy(a).cuda()).cpu().numpy()
                    if not np.array_equal(got, np.cumsum(a, dtype=np.int64)):
                        errors.append(f"{mode} thread {seed}")
        except Exception as e:  # reported below
            errors.append(f"{mode} thread {seed}: {e!r}")

    for mode in ("default stream", "stream per thread", "host entry"):
        threads = [threading.Thread(target=worker, args=(mode, k))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            if t.is_alive():
                fail(f"offsets_scan: a caller ({mode}) did not finish")
    if errors:
        fail(f"offsets_scan under concurrent callers: {errors[:4]}")
    log("kernel offsets_scan: bit-identical to np.cumsum over 200 calls in "
        "a row (wrapping sums included) and 4 threads x 50 calls on the "
        "default stream, on a stream each and through the host entry")


def ragged_shapes():
    return {
        # 1 tile, ragged tiles, several tiles, look-backs past 32 tiles
        "offsets_scan": [(1,), (2047,), (4095,), (4097,), (100_000,),
                         (1_100_003,), (2**20 + 3,), (2**24,)],
        # the write path's four page shapes in every element width, plus
        # ragged and odd `per` (no multiple of 16: the scalar kernel)
        "byteshuffle_pages": [(p, per, nb) for p, per in WRITE_PAGES
                              for nb in (1, 2, 4, 8)]
                             + [(3, 1000, 8), (2, 777, 4), (5, 4099, 2),
                                (2, 33, 1), (1, 16384, 4), (3, 16 * 64 + 9, 8)],
        "unsplit_pages": [(91, 4, 16384), (3, 8, 1000), (2, 4, 777),
                          (5, 2, 4099), (2, 1, 33), (36, 8, 8192)],
        # the read path's shapes, one block (1,000 and 5), a per that is
        # no multiple of the cluster's round (9,000: a ragged second
        # round), one page of 2^20 (128 rounds of the carry loop)
        "decode_offset_pages": [(36, 8, 8192), (12, 8, 8192), (1, 8, 8192),
                                (3, 8, 1000), (1, 8, 5), (2, 8, 1027),
                                (4, 8, 2), (2, 8, 9000), (1, 8, 1 << 20)],
    }


#: the write path's K2 page counts and widths (64 KiB pages of the 8-byte
#: and 4-byte columns of phase 3)
WRITE_PAGES = [(36, 8192), (91, 16384), (12, 8192), (30, 16384)]


#: K9's element widths, and K9's and K10's lengths, in phase 2
CODEC_WIDTHS = (1, 2, 3, 4, 8, 16)
CODEC_LENGTHS = (1, 2, 7, 4097, 1_000_003)


def unaligned(torch, x):
    """``x``'s values in a view that starts one element into its storage:
    its pointer is not 16-byte aligned, so the kernels take their scalar
    paths."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = flat[1:].view(x.shape)
    y.copy_(x)
    assert y.data_ptr() % 16
    return y


def check_codec(torch, kernels) -> None:
    """K9 and K10 bit for bit against their plain versions: K9 at every
    width of ``CODEC_WIDTHS`` x ``CODEC_LENGTHS`` (1, 2, 4 and 8 take the
    vector path where N allows, 3 and 16 the scalar one), K10 in int32
    and int64 at ``CODEC_LENGTHS`` over the whole range of the type with
    its extremes; then unaligned views of both."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1357)
    fns = kernel_fns(kernels)
    i32, i64 = torch.int32, torch.int64
    cases = [("byteshuffle", (n, nb), None, False) for nb in CODEC_WIDTHS
             for n in CODEC_LENGTHS]
    cases += [("delta_zigzag", (n,), dt, False) for dt in (i32, i64)
              for n in CODEC_LENGTHS]
    # the op entries' (phase 5) and phase 6's shapes
    cases += [("byteshuffle", shape, None, False)
              for shape in OPS_CASES["byteshuffle"]
              + [s for s, _ in CODEC_TIMED["byteshuffle"]]]
    cases += [("byteshuffle", (4096, 8), None, True),
              ("byteshuffle", (250_000, 4), None, True),
              ("delta_zigzag", (4097,), i32, True),
              ("delta_zigzag", (250_000,), i64, True)]
    for name, shape, dtype, odd in cases:
        kern, plain, _ = fns[name]
        x = kernel_input(torch, name, shape, gen, dtype)
        if odd:
            x = unaligned(torch, x)
        got = kern(x)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, plain(x))
        if err != 0.0:
            fail(f"{name} at {shape} {dtype or ''}{' unaligned' if odd else ''} "
                 f"differs from its plain version (max abs err {err})")
    log(f"kernel byteshuffle: bit-identical to its plain version at nb "
        f"{CODEC_WIDTHS} x N {CODEC_LENGTHS}, at the op entries' and the "
        "timed shapes and on 2 unaligned views")
    log(f"kernel delta_zigzag: bit-identical to its plain version in int32 "
        f"and int64 at N {CODEC_LENGTHS}, values over the whole range with "
        "the extremes, and on 2 unaligned views")


def attention_cases():
    """K5 cases (b, h, g, sq, sk, d, dv, causal, window) and K6 cases
    (b, h, g, s, d, window[, lengths]): no tile multiples, Sq < Sk, GQA 3:1, MQA and
    MHA, windows, non-causal calls with a padded kv tile, smollm-360m's
    (D=64, 15 over 5 heads), gemma-2b's (D=256, 8 over 1), zamba2-2.7b's
    shared attention's (D=80, 32 over 32: two swizzled column blocks in
    K5, ten lanes a row in K6) and minicpm3-4b's MLA (q/k 96 in two
    swizzled blocks, v 64; 40 over 40) head shapes; Sk under one kv tile,
    Sq of 1 and 129 against 1,000 (q_offset no tile multiple), K6 at H/G
    of 1, 3 and 8 with lengths from 1 to S, and bf16's tensor-core route
    (H/G of 4-8 at D = 128 and 256: chameleon-34b's and mixtral-8x22b's
    decodes, lengths of 1, one slice, a ragged last slice and the whole
    cache, windows, a cache under one slice, one chunk a cache, 125
    chunks); bf16's split route (D = 128
    and 256) with a ragged last query tile, windows of 4,096 and shorter,
    Sq < Sk, non-causal, fewer work tiles than SMs and a partial last
    round in either order (its Sq > Sk cases are in ``bwd_cases``)."""
    flash = [
        (1, 15, 5, 1000, 1000, 64, 64, True, None),     # smollm-360m prefill
        (2, 8, 1, 1000, 1000, 256, 256, True, None),    # gemma-2b prefill
        (2, 15, 15, 77, 77, 64, 64, True, None),        # MHA
        (2, 15, 1, 130, 300, 64, 64, True, None),       # MQA, Sq < Sk
        (2, 8, 8, 65, 129, 256, 256, True, 48),         # window at D=256
        (1, 6, 2, 100, 100, 64, 64, True, 33),          # window
        (1, 6, 2, 50, 200, 64, 64, False, None),        # non-causal, padded kv
        (1, 8, 1, 33, 97, 256, 256, False, 40),         # non-causal window
        (2, 4, 4, 1, 90, 32, 32, True, None),           # one query row
        (1, 4, 2, 300, 300, 128, 128, True, None),
        (1, 32, 32, 1000, 1000, 80, 80, True, None),    # zamba2-2.7b shared attn
        (2, 6, 6, 77, 130, 80, 80, False, 20),          # D=80, non-causal window
        (1, 4, 2, 17, 17, 64, 64, True, None),          # Sk under one kv tile
        (1, 6, 2, 1, 1000, 64, 64, True, None),         # Sq = 1 against 1,000
        (2, 6, 2, 129, 1000, 64, 64, True, None),       # q_offset no tile multiple
        (1, 8, 8, 300, 300, 80, 80, True, 100),         # D=80 with a window
        (1, 4, 1, 1000, 1000, 256, 256, True, None),    # D=256 at the prefill length
        (2, 8, 1, 200, 300, 128, 128, True, None),      # MQA at D=128
        (2, 40, 40, 1000, 1000, 96, 64, True, None),    # minicpm3-4b MLA prefill
        (5, 40, 40, 1100, 1100, 96, 64, True, None),    # head order, partial round
        (1, 4, 4, 129, 129, 96, 64, True, None),        # q/k 96, v 64, ragged
        (1, 6, 2, 77, 300, 96, 64, True, 50),           # GQA, Sq < Sk, window
        (1, 4, 4, 50, 200, 96, 64, False, None),        # non-causal, padded kv
        # bf16's split route (D = 128, 256)
        (1, 16, 2, 333, 333, 128, 128, True, None),     # ragged last tile
        (2, 16, 1, 333, 333, 256, 256, True, None),
        (1, 12, 2, 700, 700, 128, 128, True, 4096),     # mixtral's window
        (2, 8, 2, 500, 500, 128, 128, True, 100),       # a short window
        (1, 8, 1, 400, 400, 256, 256, True, 70),
        (2, 8, 2, 200, 700, 128, 128, True, None),      # Sq < Sk
        (1, 4, 1, 130, 517, 256, 256, True, None),
        (1, 8, 2, 300, 200, 128, 128, False, None),     # non-causal
        (1, 4, 1, 100, 300, 256, 256, False, 50),
        (1, 2, 1, 129, 129, 256, 256, True, None),      # 4 tiles: fewer than SMs
        (3, 8, 2, 1000, 1000, 128, 128, True, None),    # head order, partial round
        (9, 16, 2, 1000, 1000, 128, 128, True, None),   # stride order, partial round
    ]
    decode = [
        (16, 15, 5, 1064, 64, None),               # smollm-360m decode
        (16, 8, 1, 1064, 256, None),               # gemma-2b decode
        (3, 15, 15, 500, 64, None),                # MHA
        (4, 15, 1, 777, 64, 100),                  # MQA, window
        (3, 8, 8, 300, 256, 64),
        (5, 6, 2, 2049, 128, None),
        (1, 4, 2, 1, 32, None),                    # a one-row cache
        (16, 32, 32, 1064, 80, None),              # zamba2-2.7b shared attn
        (3, 4, 4, 300, 80, 64),
        (2, 3, 1, 517, 64, None),                  # H/G = 3, lengths 1 and S
        (2, 8, 1, 517, 80, 7),                     # H/G = 8 at D=80
        (2, 2, 2, 517, 80, None),                  # H/G = 1 at D=80
        # bf16's tensor-core route (H/G of 4-8 at D = 128 and 256): lengths
        # of 1, one 16-row slice, a ragged last slice and the whole cache
        (16, 64, 8, 1064, 128, None),              # chameleon-34b decode
        (16, 48, 8, 1064, 128, None),              # mixtral-8x22b decode
        (4, 8, 1, 300, 256, None, (1, 16, 37, 300)),
        (4, 16, 4, 300, 128, None, (1, 16, 37, 300)),   # H/G = 4
        (4, 12, 2, 517, 128, None, (1, 16, 250, 517)),  # H/G = 6
        (4, 4, 1, 777, 256, None, (1, 16, 401, 777)),   # H/G = 4 at 256
        (3, 12, 2, 777, 256, 37, None),            # H/G = 6 at 256, window
        (4, 16, 2, 700, 128, 100, (1, 99, 350, 700)),   # a window
        (3, 8, 1, 7, 256, None, None),             # a cache under one slice
        (40, 32, 8, 300, 128, None, None),         # one chunk a cache
        (2, 10, 2, 333, 256, 64, None),            # H/G = 5: padded heads
        (2, 14, 2, 2049, 128, None, (2049, 1000)),  # H/G = 7
        (1, 8, 1, 100000, 256, None, None),        # a chunk an SM
    ]
    return flash, decode


def _attention_inputs(torch, gen, dtype, *shapes):
    return [torch.randn(s, generator=gen, device="cuda").to(dtype)
            for s in shapes]


def _attention_err(torch, got, want, tol: float, what: str) -> float:
    """Max abs error; fails unless |got - want| <= tol (1 + |want|) where
    ``want`` is finite and ``got`` is -inf exactly where ``want`` is (an
    LSE's row that sees no key)."""
    got, empty = got.float(), torch.isneginf(want)
    if not torch.equal(torch.isneginf(got), empty):
        fail(f"{what}: -inf where its plain version is finite, or the reverse")
    diff = (got - want).masked_fill(empty, 0.0).abs()
    if not bool((diff <= tol * (1 + want.abs())).all()):
        fail(f"{what} differs from its plain version (max abs err "
             f"{float(diff.max()):.3e}, tol {tol})")
    return float(diff.max())


def check_attention(torch, flash_cases, decode_cases) -> dict:
    """K5 and K6 against their plain versions in fp32 and bf16; returns
    the worst error per (kernel, dtype)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    worst = {}
    for dname, tol in ATTN_TOL.items():
        dtype = getattr(torch, dname)
        for b, h, g, sq, sk, d, dv, causal, window in flash_cases:
            q, k, v = _attention_inputs(torch, gen, dtype, (b, h, sq, d),
                                        (b, g, sk, d), (b, g, sk, dv))
            got = flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                           causal=causal, window=window)
            err = _attention_err(torch, got, want, tol, (
                f"flash_attention {dname} at {(b, h, g, sq, sk, d, dv)} "
                f"causal={causal} window={window}"))
            key = ("flash_attention", dname)
            worst[key] = max(worst.get(key, 0.0), err)
            del q, k, v, got, want
        for b, h, g, s, d, window, *lengths in decode_cases:
            q, k, v = _attention_inputs(torch, gen, dtype, (b, h, d),
                                        (b, g, s, d), (b, g, s, d))
            # the case's lengths, or lengths from 1 to s across the batch
            length = (torch.tensor(lengths[0], dtype=torch.int32,
                                   device="cuda")
                      if lengths and lengths[0] else
                      torch.linspace(1, s, b, device="cuda").round().to(
                          torch.int32))
            got = decode_attention(q, k, v, length=length, window=window)
            torch.cuda.synchronize()
            want = ref.decode_attention_ref(q.float(), k.float(), v.float(),
                                            length=length, window=window)
            err = _attention_err(torch, got, want, tol, (
                f"decode_attention {dname} at {(b, h, g, s, d)} "
                f"window={window}"))
            key = ("decode_attention", dname)
            worst[key] = max(worst.get(key, 0.0), err)
    for (name, dname), err in sorted(worst.items()):
        log(f"kernel {name} {dname}: within {ATTN_TOL[dname]} of its plain "
            f"version at {len(flash_cases if name == 'flash_attention' else decode_cases)} "
            f"shapes (max abs err {err:.3e})")
    return worst


#: K7's decay w = exp(-exp(x)), x uniform in these ranges: the reference's
#: test range, strong decay, and underflow to exact zeros ("zero" also
#: sets every 7th step to 0)
DECAYS = {"reference": (-4.0, 1.0), "strong": (2.0, 4.0), "zero": (2.0, 6.0)}


def scan_cases():
    """K7 cases (b, h, t, dk, dv, decay) and K8 cases (b, h, t, p, n[,
    decay]): T of 1, 31, 32, 33 and 100 (one step; whole and ragged
    16-step sub-chunks), 64, 65 and 129 (64-step chunks), every built
    state width (48: the reference sweep's rwkv6 row), Dv and P of 40 and
    96 (no multiple of 32) and of 1,024, K7 with decays of exactly 0 at
    Dk 16, 48, 64 and 128, K8 with log_a of -inf at every 7th step and
    down to -1e4, and the serve shapes of rwkv6-7b and zamba2-2.7b."""
    rwkv6 = [
        (2, 3, 1, 16, 16, "reference"),
        (2, 3, 31, 32, 32, "strong"),
        (1, 4, 32, 64, 64, "zero"),
        (2, 4, 100, 64, 64, "reference"),
        (1, 2, 100, 128, 96, "strong"),
        (1, 2, 33, 16, 40, "zero"),
        (1, 4, 96, 48, 64, "reference"),            # the reference's Dk = 48
        (1, 4, 64, 64, 64, "strong"),
        (2, 3, 65, 48, 40, "zero"),
        (1, 2, 129, 128, 1024, "zero"),
        (1, 3, 129, 32, 1024, "reference"),
        (16, 64, 1000, 64, 64, "reference"),        # rwkv6-7b prefill
        (16, 64, 1000, 64, 64, "zero"),
    ]
    mamba2 = [
        (2, 3, 1, 16, 16), (2, 3, 31, 32, 32), (1, 4, 32, 64, 64),
        (2, 4, 100, 64, 64), (1, 2, 100, 96, 128), (1, 2, 33, 40, 16),
        (1, 4, 96, 64, 48), (2, 3, 64, 40, 48), (2, 3, 65, 64, 64),
        (1, 3, 129, 1024, 32), (1, 2, 65, 1024, 128),
        (2, 3, 130, 64, 64, "-inf"), (1, 4, 100, 40, 48, "-1e4"),
        (16, 80, 1000, 64, 64),                     # zamba2-2.7b prefill
    ]
    return rwkv6, mamba2


def rwkv6_inputs(torch, gen, shape, decay: str, dtype):
    """r, k, v, w, u on the card; w from ``DECAYS[decay]``."""
    b, h, t, dk, dv = shape
    r, k = (torch.randn((b, h, t, dk), generator=gen, device="cuda")
            for _ in range(2))
    v = torch.randn((b, h, t, dv), generator=gen, device="cuda")
    u = torch.randn((h, dk), generator=gen, device="cuda")
    lo, hi = DECAYS[decay]
    w = torch.exp(-torch.exp(lo + (hi - lo) * torch.rand(
        (b, h, t, dk), generator=gen, device="cuda")))
    if decay == "zero":
        w[..., ::7, :] = 0.0
    return [a.to(dtype) for a in (r, k, v, w, u)]


#: K8's log-decay -exp(uniform(-3, hi)): the reference's range, and one
#: down to -1e4; "-inf" also sets every 7th step to -inf (decay 0)
LOG_DECAY_HI = {"reference": 0.5, "-inf": 0.5, "-1e4": 9.2}


def mamba2_inputs(torch, gen, shape, dtype, decay="reference"):
    """x (in ``dtype``), log_a = -exp(uniform(-3, ``LOG_DECAY_HI[decay]``)),
    B, C on the card."""
    b, h, t, p, n = shape
    x = torch.randn((b, h, t, p), generator=gen, device="cuda").to(dtype)
    hi = LOG_DECAY_HI[decay]
    log_a = -torch.exp(-3 + (hi + 3) * torch.rand((b, h, t), generator=gen,
                                                  device="cuda"))
    if decay == "-inf":
        log_a[..., ::7] = -float("inf")
    Bm, Cm = (torch.randn((b, t, n), generator=gen, device="cuda")
              for _ in range(2))
    return [x, log_a, Bm, Cm]


def _scan_err(torch, got, want, what: str, shares=None, key=None) -> float:
    """Max abs error; fails unless finite and |got - want| <= tol (1 +
    |want|), tol by ``got``'s dtype (``SCAN_TOL``).  ``shares[key]`` keeps
    the largest |got - want| / (tol (1 + |want|)): the share of the
    tolerance used."""
    tol = SCAN_TOL["bfloat16" if got.dtype == torch.bfloat16 else "float32"]
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        fail(f"{what} is not finite")
    diff = (got - want).abs()
    share = float((diff / (tol * (1 + want.abs()))).max())
    if share > 1.0:
        fail(f"{what} differs from its plain version (max abs err "
             f"{float(diff.max()):.3e}, tol {tol})")
    if shares is not None:
        shares[key] = max(shares.get(key, 0.0), share)
    return float(diff.max())


def check_scans(torch, rwkv6_cases, mamba2_cases) -> dict:
    """K7 and K8 against their plain versions with fp32 and bf16 inputs
    (output and final state); returns the worst error per (kernel,
    dtype)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.mamba2_ssd import mamba2_ssd
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2468)
    worst, shares = {}, {}
    for dname in SCAN_TOL:
        dtype = getattr(torch, dname)
        for case in rwkv6_cases:
            shape, decay = case[:5], case[5]
            ins = rwkv6_inputs(torch, gen, shape, decay, dtype)
            out, state = rwkv6_scan(*ins)
            torch.cuda.synchronize()
            want, want_s = ref.rwkv6_ref(*(a.float() for a in ins))
            what = f"rwkv6_scan {dname} at {tuple(shape)} decay {decay}"
            key = ("rwkv6_scan", dname)
            err = max(_scan_err(torch, out, want, what, shares, key + ("out",)),
                      _scan_err(torch, state, want_s, what + " (state)",
                                shares, key + ("state",)))
            worst[key] = max(worst.get(key, 0.0), err)
            del ins, out, state, want, want_s
        for case in mamba2_cases:
            shape, decay = case[:5], (case[5] if len(case) > 5 else "reference")
            ins = mamba2_inputs(torch, gen, shape, dtype, decay)
            y, state = mamba2_ssd(*ins)
            torch.cuda.synchronize()
            want, want_s = ref.mamba2_ref(ins[0].float(), *ins[1:])
            what = f"mamba2_ssd {dname} at {tuple(shape)} decay {decay}"
            key = ("mamba2_ssd", dname)
            err = max(_scan_err(torch, y, want, what, shares, key + ("out",)),
                      _scan_err(torch, state, want_s, what + " (state)",
                                shares, key + ("state",)))
            worst[key] = max(worst.get(key, 0.0), err)
            del ins, y, state, want, want_s
    for (name, dname), err in sorted(worst.items()):
        n = len(rwkv6_cases if name == "rwkv6_scan" else mamba2_cases)
        log(f"kernel {name} {dname} inputs: finite and within "
            f"{SCAN_TOL[dname]} (outputs; states within "
            f"{SCAN_TOL['float32']}) of its plain version at {n} shapes "
            f"(max abs err {err:.3e}; largest share of the tolerance: "
            f"outputs {shares[(name, dname, 'out')]:.4f}, states "
            f"{shares[(name, dname, 'state')]:.4f})")
    return worst


# ---------------------------------------------------------------------------
# phase 3: the write -> read path


def make_item(np, seed: int, p: int, entries: int):
    """Producer ``p``'s ids, collection sizes, float32 values and size
    running sums (bulk, from the seed)."""
    rng = np.random.default_rng([seed, p])
    sizes = rng.poisson(5, entries).astype(np.int64)
    vals = rng.standard_normal(int(sizes.sum()), dtype=np.float32)
    ids = np.arange(p * entries, (p + 1) * entries, dtype=np.int64)
    return ids, sizes, vals, np.cumsum(sizes)


def make_data(np, seed: int, producers: int, entries: int):
    """Per producer: :func:`make_item`."""
    return [make_item(np, seed, p, entries) for p in range(producers)]


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


def check_read_back(np, torch, core, path, data, entries: int,
                    live=None, tolerant: bool = False):
    """Read back through the device decode chain; every column of every
    cluster must equal the generated data at its place, and the entries,
    as a multiset, must be the generated ones: the whole share of each
    producer in ``live`` (all by default) and a prefix of each other's.
    -> (seconds, reader stats, clusters, entries read per producer)."""
    schema = None
    spans = {p: [] for p in range(len(data))}
    t0 = time.perf_counter()
    with core.RNTJReader(path, device="cuda", options=core.ReadOptions(
            prefetch_clusters=2, tolerant=tolerant)) as r:
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
            spans[p].append((s, n))
        dt = time.perf_counter() - t0
        stats = r.stats
        n_clusters = r.n_clusters
    read = {}
    for p, got in spans.items():
        pos = 0
        for s, n in sorted(got):
            if s != pos:  # a gap or an entry read twice
                fail(f"producer {p}: entries {s}.. read after {pos}")
            pos += n
        read[p] = pos
        if (live is None or p in live) and pos != entries:
            fail(f"producer {p}: read back {pos} entries of {entries}")
    return dt, stats, n_clusters, read


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


@contextlib.contextmanager
def env_vars(values: dict):
    """The environment variables ``values`` set for the code inside (and
    the processes it starts), their old values restored after."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def kernel_backend(backend: str):
    """``REPRO_TORCH_KERNEL_BACKEND`` set to ``backend`` (``auto``: the
    kernels; ``numpy``) for the writers made inside."""
    return env_vars({"REPRO_TORCH_KERNEL_BACKEND": backend})


def write_single(core, schema, opts, path, item, backend: str) -> float:
    with kernel_backend(backend):
        t0 = time.perf_counter()
        with core.SequentialWriter(schema, path, opts, device="cuda") as w:
            for b in batches(core, schema, item):
                w.fill_batch(b)
        return time.perf_counter() - t0


def trace_card(torch, name: str, fn, out_dir, top: int = 10) -> tuple:
    """Trace ``fn`` with torch.profiler: the card's busy time (the union of
    its kernels' and copies' intervals) against the wall clock, and the
    ``top`` device works that took most of it; the trace goes to
    ``out_dir`` unless it is None; -> (the busy ms, {device work's name:
    (card us, launches)}).  The wall includes the profiler's own cost on
    every launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

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
    for key, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"  {key[:60]}: {t / 1e3:.3f} ms over {c} calls")
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, f"trace_{name}.json"))
    return busy_ms, by_name


def profile_write_read(torch, core, schema, opts, path, item, out_dir) -> None:
    """Trace one device read-back and one single-producer write."""

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

    trace_card(torch, "read", read, out_dir)
    trace_card(torch, "write", write, out_dir)
    os.remove(path + ".prof")


# ---------------------------------------------------------------------------
# phase 4: the serve path


def expected_launches(cfg, kernels, n_new: int) -> dict:
    """Launches of each serve kernel in one served batch (prefill, then
    ``n_new - 1`` decode steps): K5 once per attention block in prefill
    and K6 once per GQA attention block and step (every layer of an
    attention model, zamba2's shared blocks; MLA decodes in latent space
    without K6); K7 once per rwkv6 layer and K8 once per Mamba-2 layer in
    prefill (their decode steps are plain PyTorch)."""
    want = dict.fromkeys(kernels, 0)
    attn = cfg.n_layers
    if cfg.family == "ssm":
        want["rwkv6_scan"], attn = cfg.n_layers, 0
    elif cfg.family == "hybrid":
        want["mamba2_ssd"] = cfg.n_layers
        attn = cfg.n_layers // cfg.shared_attn_every
    want["flash_attention"] = attn
    if cfg.attention != "mla":
        want["decode_attention"] = attn * (n_new - 1)
    return want


def describe(cfg) -> str:
    """The served model's shape, for the log."""
    if cfg.mla:
        m = cfg.mla
        attn = (f"MLA q/k {m.d_nope + m.d_rope} (rope {m.d_rope}), v "
                f"{m.d_v}, q rank {m.q_rank}, kv rank {m.kv_rank}")
    else:
        attn = f"head dim {cfg.resolved_head_dim}"
        if cfg.window:
            attn += f", window {cfg.window}"
        if cfg.qk_norm:
            attn += ", qk-norm"
    if cfg.moe:
        m = cfg.moe
        attn += (f"; {m.n_experts} experts top-{m.top_k}"
                 f"{f' + {m.n_shared} shared' if m.n_shared else ''}, "
                 f"capacity factor {m.capacity_factor}")
    if cfg.ssm:  # rwkv6's state is head_dim x head_dim, mamba2's N x P
        n = cfg.ssm.d_state if cfg.ssm.kind == "mamba2" else cfg.ssm.head_dim
        attn += f"; {cfg.ssm.kind} state {n} x {cfg.ssm.head_dim}"
    if cfg.n_codebooks > 1:
        attn += f"; {cfg.n_codebooks} codebooks, {cfg.mlp} MLP"
    return attn


def serve_path(np, torch, core, serve, ops, args, tmp, arch: str):
    """Serve ``arch`` at full width, and at full depth or the depth of
    ``SERVE_DEPTH``, through the launcher (a cut config through its
    ``serve_model``: the command line takes the registry's names only);
    -> (result, launch counts, launch shapes) of that run alone."""
    from repro_torch.configs import get_arch

    out = os.path.join(tmp, "generations.rntj")
    argv = ["--arch", arch, "--seed", str(args.seed), "--out", out]

    def run(requests, prompt_len, max_new, keep_logits=False):
        if arch in SERVE_DEPTH:
            cfg = get_arch(arch).with_(n_layers=SERVE_DEPTH[arch])
            return serve.serve_model(cfg, requests, prompt_len, max_new,
                                     args.seed, "cuda", out,
                                     keep_logits=keep_logits)
        return serve.main(argv + [
            "--requests", str(requests), "--prompt-len", str(prompt_len),
            "--max-new", str(max_new)], keep_logits=keep_logits)

    # a warm-up at a tiny size: the CUDA context's lazy module loads and
    # cuBLAS's set-up stay out of the timed run
    run(1, 16, 2)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = run(args.requests, args.prompt_len, args.max_new, keep_logits=True)
    wall = time.perf_counter() - t0
    counts, shapes = ops.launch_counts(), ops.launch_shapes()
    cfg, b, s, n_new = res.cfg, args.requests, args.prompt_len, args.max_new
    full = get_arch(arch)
    depth = (f"{cfg.n_layers} of {full.n_layers} layers (depth cut: "
             f"{full.param_count():,} parameters at full depth)"
             if arch in SERVE_DEPTH else f"{cfg.n_layers} layers")
    log(f"serve {cfg.name}: {depth}, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads over {cfg.n_kv_heads}, {describe(cfg)}, vocab "
        f"{cfg.vocab_size}, {cfg.param_count():,} parameters, "
        f"{cfg.compute_dtype} compute; {b} requests x {s} prompt tokens, "
        f"{n_new} new tokens; wall {wall:.3f} s (parameter init included); "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"of {torch.cuda.get_device_properties(0).total_memory / 2**30:.2f}")
    want = expected_launches(cfg, ops.SERVE_KERNELS, n_new)
    log(f"launches on the {cfg.name} serve path: {json.dumps(counts)} "
        f"(expected {json.dumps(want)})")
    for name in ops.SERVE_KERNELS:
        if shapes[name]:
            log(f"  {name} shapes: " + ", ".join(
                f"{tuple(x)} x{c}" for x, c in shapes[name].most_common()))
        if counts[name] != want[name]:
            fail(f"{name} launched {counts[name]} times on the {cfg.name} "
                 f"serve path, expected {want[name]}")
    q = () if cfg.n_codebooks == 1 else (cfg.n_codebooks,)
    if res.tokens.shape != (b, n_new) + q:
        fail(f"generated {res.tokens.shape}, expected {(b, n_new) + q}")
    logged = res.tokens[..., 0] if q else res.tokens  # the first codebook
    with core.RNTJReader(out, device="cuda") as r:
        got = r.read_column("tokens._0").reshape(b, n_new)
        ids = r.read_column("request_id")
        plen = r.read_column("prompt_len")
    if not (np.array_equal(got, logged) and np.array_equal(ids, np.arange(b))
            and np.array_equal(plen, np.full(b, s))):
        fail("the generations file does not read back equal to the tokens")
    os.remove(out)
    tm = res.timings
    log(f"serve {cfg.name} timings: prefill {tm['prefill_s'] * 1e3:.3f} ms "
        f"({b * s / tm['prefill_s']:.1f} prompt tokens/s); decode "
        f"{tm['decode_s'] * 1e3:.3f} ms for {n_new - 1} steps = "
        f"{tm['decode_s'] * 1e3 / (n_new - 1):.3f} ms per token step "
        f"({b * (n_new - 1) / tm['decode_s']:.1f} tokens/s); end to end "
        f"{b * n_new / (tm['prefill_s'] + tm['decode_s']):.1f} generated "
        f"tokens/s; write {tm['write_s'] * 1e3:.3f} ms; generations file "
        f"read back equal{' (the first codebook)' if q else ''}")
    return res, counts, shapes


def profile_serve(torch, res, out_dir, steps: int = 8) -> None:
    """Trace the served batch's prefill, then ``steps`` decode steps on
    its cache (a few steps keep the trace small; each step is alike)."""
    bundle, params, prompts = res.bundle, res.params, res.prompts
    b, s = prompts.shape[:2]
    state = {}

    def prefill():
        state["logits"], state["cache"] = bundle.prefill(
            params, prompts, max_len=s + steps + 1)

    def decode():
        tok = torch.argmax(state["logits"], dim=-1).to(torch.int32)
        cache = state["cache"]
        for i in range(steps):
            pos = torch.full((b,), s + i, dtype=torch.int32, device="cuda")
            logits, cache = bundle.decode_step(params, tok, cache, pos)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)

    name = res.cfg.name
    trace_card(torch, f"serve_{name}_prefill", prefill, out_dir)
    trace_card(torch, f"serve_{name}_decode_{steps}_steps", decode, out_dir)


def _forward_chunks(bundle, params, tokens):
    """``bundle.forward`` logits over a few requests at a time (at most
    ``LOGIT_CHUNK_BYTES`` of fp32 logits each); yields (rows, logits)."""
    cfg = bundle.cfg
    per = tokens.shape[1] * cfg.n_codebooks * cfg.vocab_size * 4
    step = max(1, LOGIT_CHUNK_BYTES // per)
    for i in range(0, tokens.shape[0], step):
        yield slice(i, i + step), bundle.forward(params, tokens[i:i + step])[0]


def _teacher_forced(bundle, params, prompts, tokens):
    """``bundle.forward`` logits (fp32) at the positions that chose each
    generated token: prompt + all but the last token."""
    import torch

    n_prompt = prompts.shape[1]
    full = torch.cat([prompts, torch.from_numpy(tokens[:, :-1]).to(
        prompts.device)], dim=1)
    return torch.cat([lg[:, n_prompt - 1:].float()
                      for _rows, lg in _forward_chunks(bundle, params, full)])


def _agree(torch, logits, tokens) -> float:
    return float((logits.argmax(-1).cpu() == torch.from_numpy(tokens))
                 .float().mean())


def _bf16_against_fp32(torch, name, what, dec, fwd16, fwd32, tokens) -> None:
    """bf16 logits ``dec`` against the fp32 forward's ``fwd32`` at the same
    positions: no farther than ``BF16_SPREAD`` times the bf16 forward's
    ``fwd16`` is, plus ``BF16_SLACK`` of max |logit|."""
    scale = float(fwd32.abs().max())
    d_dec = float((dec - fwd32).abs().max()) / scale
    d_fwd = float((fwd16 - fwd32).abs().max()) / scale
    d_pair = float((dec - fwd16).abs().max()) / scale
    mean_rel = float((dec - fwd32).abs().mean() / fwd32.abs().mean())
    tol = BF16_SPREAD * d_fwd + BF16_SLACK
    log(f"consistency {name} bfloat16 ({what}): {d_dec:.4e} of max |logit| "
        f"{scale:.4f} from the fp32 forward's (tol {tol:.4e} = {BF16_SPREAD}"
        f" x the bf16 forward's {d_fwd:.4e} + {BF16_SLACK}); against the "
        f"bf16 forward {d_pair:.4e}; mean |diff from the fp32 forward| "
        f"{mean_rel:.4e} of mean |logit|; the fp32 forward's argmax equals "
        f"the generated token at {100 * _agree(torch, fwd32, tokens):.2f} % "
        f"of positions, the bf16 forward's at "
        f"{100 * _agree(torch, fwd16, tokens):.2f} %")
    if not d_dec <= tol:
        fail(f"{name}: bf16 {what} logits disagree with forward")


def _fp32_generation(torch, name, bundle32, params, prompts, n_new32,
                     what="") -> None:
    """A fresh fp32 generation against its own fp32 forward (within
    ``CONSISTENCY_TOL``)."""
    from repro_torch.launch.serve import generate

    tokens, dec = generate(bundle32, params, prompts, n_new32,
                           keep_logits=True)
    want = _teacher_forced(bundle32, params, prompts, tokens)
    diff = (dec.float() - want).abs()
    rel = float(diff.max() / want.abs().max())
    log(f"consistency {name} float32 ({prompts.shape[0]} x {prompts.shape[1]}"
        f" + {n_new32}{what}): decode vs teacher-forced logits max abs diff "
        f"{float(diff.max()):.4e} = {rel:.4e} of max |logit| "
        f"{float(want.abs().max()):.4f} (tol {CONSISTENCY_TOL['float32']}), "
        f"mean {float(diff.mean() / want.abs().mean()):.4e} of mean |logit|; "
        f"forward's argmax equals the generated token at "
        f"{100 * _agree(torch, want, tokens):.2f} % of positions")
    if not rel <= CONSISTENCY_TOL["float32"]:
        fail(f"{name}: fp32 decode-step logits disagree with forward")


def no_drop(cfg):
    """A MoE config whose capacity holds a whole routing group (capacity
    factor ``E / k``): no (token, k) place is dropped."""
    import dataclasses

    m = cfg.moe
    return cfg.with_(moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))


def check_consistency(torch, res, bundle32, n_req32: int,
                      n_new32: int) -> None:
    """Decode-step logits (K6 on the cache, MLA's latent decode, the
    one-token recurrences) against teacher-forced ``forward`` logits (K5,
    K7, K8 over prompt + generated tokens) at the same positions: the
    served bf16 batch against the fp32 forward on its tokens (see
    ``CONSISTENCY_TOL``), then a fresh fp32 generation of ``n_req32``
    requests x ``n_new32`` tokens against its own fp32 forward.  MoE (its
    one-token decode drops other places than ``forward``): the served
    prefill's last-token logits against ``forward`` over the prompts at
    the published config, then the two decode checks on ``n_req32``
    requests under ``no_drop``."""
    from repro_torch.launch.serve import generate
    from repro_torch.models import build

    name, prompts = res.cfg.name, res.prompts
    b, s = prompts.shape[:2]
    if res.cfg.moe is None:
        _bf16_against_fp32(
            torch, name, f"decode, {b} x {s} + {res.tokens.shape[1]}",
            res.logits.float(),
            _teacher_forced(res.bundle, res.params, prompts, res.tokens),
            _teacher_forced(bundle32, res.params, prompts, res.tokens),
            res.tokens)
        _fp32_generation(torch, name, bundle32, res.params,
                         prompts[:n_req32], n_new32)
        return

    # the prefill's routing groups are forward's over the same prompts
    pre = res.logits[:, :1].float()
    fwd16, fwd32 = (torch.cat([lg[:, -1:].float() for _r, lg in
                               _forward_chunks(bd, res.params, prompts)])
                    for bd in (res.bundle, bundle32))
    d_same = float((pre - fwd16).abs().max() / fwd16.abs().max())
    log(f"consistency {name} bfloat16 prefill vs forward over the {b} x {s} "
        f"prompts at capacity factor {res.cfg.moe.capacity_factor}: last-"
        f"token logits {d_same:.4e} of max |logit| apart (tol {BF16_SLACK})")
    if not d_same <= BF16_SLACK:
        fail(f"{name}: the prefill's last-token logits differ from forward's")
    _bf16_against_fp32(torch, name, "prefill's last token", pre, fwd16,
                       fwd32, res.tokens[:, :1])
    del pre, fwd16, fwd32

    cfg = no_drop(res.cfg)
    nd16, nd32 = build(cfg), build(cfg.with_(compute_dtype="float32"))
    few = prompts[:n_req32]
    tokens, dec = generate(nd16, res.params, few, n_new32, keep_logits=True)
    what = f" at capacity factor {cfg.moe.capacity_factor:.4g}, no drops"
    _bf16_against_fp32(
        torch, name, f"decode, {n_req32} x {s} + {n_new32}{what}",
        dec.float(), _teacher_forced(nd16, res.params, few, tokens),
        _teacher_forced(nd32, res.params, few, tokens), tokens)
    _fp32_generation(torch, name, nd32, res.params, few, n_new32, what)


# ---------------------------------------------------------------------------
# phase 5: the kernels package's entry points


#: the op entries' cases: the shapes of the reference's own sweep
#: (tests/test_kernels.py) where the kernels take them; K3/K4 have none
#: there and take the port's CPU test shapes
OPS_CASES = {
    "offsets_scan": [1, 7, 128, 1000, 5000],
    "delta_zigzag": [1, 64, 999, 4096],
    "byteshuffle": [(n, nb) for nb in (2, 4, 8) for n in (1, 100, 2048, 6000)],
    "unsplit_pages": [(3, 8, 1000), (2, 4, 777), (4, 2, 2048), (2, 1, 16)],
    "decode_offset_pages": [(4, 8, 2048), (3, 8, 1000), (1, 8, 5)],
    "flash_attention": [  # (b, h, g, sq, sk, d, window)
        (1, 4, 4, 128, 128, 64, None), (2, 8, 2, 256, 256, 64, None),
        (1, 8, 1, 128, 128, 128, None), (1, 4, 4, 64, 256, 64, None),
        (1, 4, 2, 200, 200, 80, None), (1, 4, 2, 256, 256, 64, 64),
        (1, 4, 2, 256, 256, 64, 128), (1, 4, 2, 256, 256, 64, 1024)],
    "decode_attention": [  # (b, h, g, s, d, lengths, window)
        (2, 4, 4, 512, 64, None, None), (2, 8, 2, 1024, 64, None, None),
        (1, 8, 1, 777, 128, None, None), (3, 4, 2, 640, 64, (100, 640, 333),
                                          None),
        (3, 4, 2, 640, 64, (100, 640, 333), 64)],
    "rwkv6": [(1, 2, 64, 32, 32), (2, 2, 128, 64, 64), (1, 4, 96, 48, 64)],
    "mamba2": [(1, 2, 128, 32, 16), (2, 4, 128, 64, 64), (1, 2, 256, 64, 32)],
}
#: the kernel each op entry launches (K2 has no op entry)
OPS_KERNELS = ("offsets_scan", "unsplit_pages", "decode_offset_pages",
               "flash_attention", "decode_attention", "rwkv6_scan",
               "mamba2_ssd", "byteshuffle", "delta_zigzag")


def ops_phase(torch, ops):
    """Call each of the nine op entries of ``repro_torch.kernels.ops`` on
    CUDA tensors at ``OPS_CASES``, each result held against the plain
    version on the card (exact for the codec ops; ``ATTN_TOL`` and
    ``SCAN_TOL`` with fp32 inputs, bf16 attention too); -> (launch
    counts, launch shapes) of these calls alone."""
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2024)
    dev = "cuda"
    n_calls = dict.fromkeys(OPS_CASES, 0)

    def exact(op, got, want, what):
        n_calls[op] += 1
        if got.dtype != want.dtype or max_abs_err(torch, got, want) != 0.0:
            fail(f"ops.{op} at {what} differs from its plain version")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    ops.reset_launch_counts()
    for n in OPS_CASES["offsets_scan"]:
        sizes = torch.poisson(torch.full((n,), 5.0, device=dev),
                              generator=gen).to(torch.int32)
        exact("offsets_scan", ops.offsets_scan(sizes, block=128),
              ref.offsets_scan_ref(sizes.long()).int(), (n,))
    for n in OPS_CASES["delta_zigzag"]:
        sizes = torch.poisson(torch.full((n,), 5.0, device=dev), generator=gen)
        offs = torch.cumsum(sizes, 0).to(torch.int32)
        exact("delta_zigzag", ops.delta_zigzag(offs, block=256),
              ref.delta_zigzag_ref(offs), (n,))
    for shape in OPS_CASES["byteshuffle"]:
        x = kernel_input(torch, "byteshuffle", shape, gen)
        exact("byteshuffle", ops.byteshuffle(x, block=512),
              ref.byteshuffle_ref(x), shape)
    for shape in OPS_CASES["unsplit_pages"]:
        x = kernel_input(torch, "unsplit_pages", shape, gen)
        exact("unsplit_pages", ops.unsplit_pages(x), ref.unsplit_pages_ref(x),
              shape)
    for shape in OPS_CASES["decode_offset_pages"]:
        x = kernel_input(torch, "decode_offset_pages", shape, gen)
        exact("decode_offset_pages", ops.decode_offset_pages(x),
              ref.decode_offset_pages_ref(x), shape)
    for dname, tol in ATTN_TOL.items():
        dtype = getattr(torch, dname)
        for b, h, g, sq, sk, d, window in OPS_CASES["flash_attention"]:
            q, k, v = (a.to(dtype) for a in (randn(b, h, sq, d),
                                             randn(b, g, sk, d),
                                             randn(b, g, sk, d)))
            want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                           window=window)
            for impl in ("ref", "chunked"):
                got = ops.flash_attention(q, k, v, causal=True, window=window,
                                          impl=impl, block_q=128,
                                          block_k=128)
                if got.dtype != dtype or got.shape != q.shape:
                    fail(f"ops.flash_attention returned {got.dtype} "
                         f"{tuple(got.shape)}")
                _attention_err(torch, got, want, tol, (
                    f"ops.flash_attention {dname} impl={impl} at "
                    f"{(b, h, g, sq, sk, d)} window={window}"))
                n_calls["flash_attention"] += 1
        for b, h, g, s, d, lengths, window in OPS_CASES["decode_attention"]:
            q, k, v = (a.to(dtype) for a in (randn(b, h, d), randn(b, g, s, d),
                                             randn(b, g, s, d)))
            length = (None if lengths is None else
                      torch.tensor(lengths, dtype=torch.int32, device=dev))
            got = ops.decode_attention(q, k, v, length=length, window=window,
                                       block_k=256)
            want = ref.decode_attention_ref(q.float(), k.float(), v.float(),
                                            length=length, window=window)
            if got.dtype != dtype or got.shape != q.shape:
                fail(f"ops.decode_attention returned {got.dtype} "
                     f"{tuple(got.shape)}")
            _attention_err(torch, got, want, tol, (
                f"ops.decode_attention {dname} at {(b, h, g, s, d)} "
                f"lengths={lengths} window={window}"))
            n_calls["decode_attention"] += 1
    for shape in OPS_CASES["rwkv6"]:
        ins = rwkv6_inputs(torch, gen, shape, "reference", torch.float32)
        out, state = ops.rwkv6(*ins, chunk=16)
        want, want_s = ref.rwkv6_ref(*ins)
        _scan_err(torch, out, want, f"ops.rwkv6 at {shape}")
        _scan_err(torch, state, want_s, f"ops.rwkv6 state at {shape}")
        n_calls["rwkv6"] += 1
    for shape in OPS_CASES["mamba2"]:
        ins = mamba2_inputs(torch, gen, shape, torch.float32)
        y, state = ops.mamba2(*ins, chunk=32)
        want, want_s = ref.mamba2_ref(*ins)
        _scan_err(torch, y, want, f"ops.mamba2 at {shape}")
        _scan_err(torch, state, want_s, f"ops.mamba2 state at {shape}")
        n_calls["mamba2"] += 1
    torch.cuda.synchronize()
    counts, shapes = ops.launch_counts(), ops.launch_shapes()
    log("the kernels package's entry points: " + ", ".join(
        f"ops.{op} {c} calls" for op, c in n_calls.items())
        + "; each result equal to (codec) or within tolerance of "
        "(attention, scans) its plain version on the card")
    log("launches of the op entries: " + json.dumps(
        {k: counts[k] for k in OPS_KERNELS}))
    missing = [k for k in OPS_KERNELS if counts[k] <= 0]
    if missing:
        fail(f"kernels not launched by the op entries: {missing}")
    return counts, shapes


# ---------------------------------------------------------------------------
# phase 6: timings of the kernels


#: the near-empty shapes at which phase 6 also times K2's and K4's
#: wrappers: the least one launch costs, measured as the kernels are
FLOOR_SHAPES = {"byteshuffle_pages": (1, 16, 8),
                "decode_offset_pages": (1, 8, 16)}


def time_wrapper(torch, fns, name: str, shape, gen, dname=None) -> dict:
    """One codec kernel's wrapper and its plain version at ``shape``
    (``dname``: K10's int32 or int64): the result bit for bit, card time,
    time per call with the host's part, bound; the library call's time is
    the plain version's where that is one PyTorch call."""
    kern, plain, lib = fns[name]
    x = kernel_input(torch, name, shape, gen,
                     getattr(torch, dname) if dname else None)
    got, want = kern(x), plain(x)
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    if err != 0.0:
        fail(f"{name} at {shape} differs from its plain version")
    del got, want
    timed = {}
    for key, fn in (("", kern), ("plain_", plain)):
        c_ms = call_ms(torch, fn, x)
        timed[key + "call_ms"] = c_ms
        timed[key + "ms"] = device_ms(torch, fn, x, c_ms)
    b_ms, b_by, nbytes = bound(name, shape, x.element_size())
    lib_ms = timed["plain_ms"] if lib else None  # the plain version IS that call
    dtype = str(x.dtype).replace("torch.", "")
    log(f"{name} at {tuple(shape)} {dtype}: card {timed['ms']:.5f} ms (bound "
        f"{b_ms:.5f} ms by {b_by}, plain {timed['plain_ms']:.5f} ms, library "
        f"{f'{lib_ms:.5f} ms ({lib})' if lib else 'none'}); per call with "
        f"host overhead {timed['call_ms']:.5f} ms (plain "
        f"{timed['plain_call_ms']:.5f} ms)")
    return {"shape": list(shape), "dtype": dtype, "max_abs_err": err,
            "ms": timed["ms"], "plain_ms": timed["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "bytes": nbytes, "call_ms": timed["call_ms"],
            "plain_call_ms": timed["plain_call_ms"]}


#: the design each route of K6 runs (``decode_attention.decode_route``)
K6_DESIGN = {"mma": "mma.sync + TMA: 16-row slices in a TMA ring a warp, "
                    "the group's heads as N = 8, P^T by movmatrix, one "
                    "wave of one block an SM (mma_launch_shape)",
             "ring": "cp.async ring"}


def time_attention(torch, ops, shapes, counts, worst,
                   names=("flash_attention", "decode_attention")) -> list:
    """K5 and K6 (``names``) at the serve path's most frequent shape in
    bf16: card time, plain version, SDPA and the backend it ran, bound;
    K6's row names the route it timed; -> their ``kernels`` rows."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_route,
    )
    from repro_torch.kernels.flash_attention import flash_attention

    gen = torch.Generator(device="cuda")
    gen.manual_seed(77)
    bf16 = torch.bfloat16
    rows = []
    for name in names:
        shape = shapes[name].most_common(1)[0][0]
        backend = None
        if name == "flash_attention":
            b, h, g, sq, sk, d, dv = shape
            q, k, v = _attention_inputs(torch, gen, bf16, (b, h, sq, d),
                                        (b, g, sk, d), (b, g, sk, dv))
            length = None
            kern = lambda _: flash_attention(q, k, v, causal=True)
            plain = lambda _: ref.flash_attention_ref(q, k, v, causal=True)
            lib = lambda _: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)
            want = ref.flash_attention_ref(q.float(), k.float(), v.float())
            # the backend SDPA picks at these widths (flash-attention takes
            # v as wide as q/k only), read off the graph of one call
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            backend = type(F.scaled_dot_product_attention(
                *leaves, is_causal=True, enable_gqa=True).grad_fn).__name__
            del leaves
        else:
            b, h, g, s, d = shape
            q, k, v = _attention_inputs(torch, gen, bf16, (b, h, d),
                                        (b, g, s, d), (b, g, s, d))
            # the middle of the decode: every sequence holds the prompt and
            # half of the new tokens
            length = (s + shapes["flash_attention"].most_common(1)[0][0][3]) // 2
            lens = torch.full((b,), length, dtype=torch.int32, device="cuda")
            k_l, v_l = k[:, :, :length].contiguous(), v[:, :, :length].contiguous()
            kern = lambda _: decode_attention(q, k, v, length=lens)
            plain = lambda _: ref.decode_attention_ref(q, k, v, length=lens)
            lib = lambda _: F.scaled_dot_product_attention(
                q[:, :, None], k_l, v_l, enable_gqa=True)[:, :, 0]
            want = ref.decode_attention_ref(q.float(), k.float(), v.float(),
                                            length=lens)
            leaves = [t.detach().requires_grad_(True)
                      for t in (q[:, :, None], k_l, v_l)]
            backend = type(F.scaled_dot_product_attention(
                *leaves, enable_gqa=True).grad_fn).__name__
            del leaves
        got = kern(None)
        torch.cuda.synchronize()
        err = _attention_err(torch, got, want, ATTN_TOL["bfloat16"],
                             f"{name} at the serve shape {shape}")
        lib_err = float((lib(None).float() - want).abs().max())
        before = ops.launch_counts()[name]
        timed = {}
        for key, fn in (("", kern), ("plain_", plain), ("library_", lib)):
            c_ms = call_ms(torch, fn, None)
            timed[key + "call_ms"] = c_ms
            timed[key + "ms"] = device_ms(torch, fn, None, c_ms)
        assert ops.launch_counts()[name] > before  # the timing ran the kernel
        b_ms, b_by, nbytes = attention_bound(name, shape, 2, length)
        source, replaces = KERNEL_INFO[name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": err, "ms": timed["ms"],
            "plain_ms": timed["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": timed["library_ms"],
            "library": "torch.nn.functional.scaled_dot_product_attention",
            "library_backend": backend,
            "design": (K6_DESIGN[decode_route(bf16, shape[4],
                                              shape[1] // shape[2])]
                       if name == "decode_attention"
                       else KERNEL_DESIGN[name]["bfloat16"]),
            "design_by_dtype": KERNEL_DESIGN[name],
            "shape": list(shape), "dtype": "bfloat16", "length": length,
            "bytes": nbytes, "call_ms": timed["call_ms"],
            "plain_call_ms": timed["plain_call_ms"],
            "library_call_ms": timed["library_call_ms"],
            "library_max_abs_err": lib_err,
            "max_abs_err_fp32_checks": worst[(name, "float32")],
            "max_abs_err_bf16_checks": worst[(name, "bfloat16")],
        })
        log(f"{name} at {shape} bf16{'' if length is None else f' length {length}'}: "
            f"card {timed['ms']:.5f} ms (bound {b_ms:.5f} ms by {b_by}, "
            f"plain {timed['plain_ms']:.5f} ms, SDPA {timed['library_ms']:.5f} "
            f"ms); per call with host overhead {timed['call_ms']:.5f} ms "
            f"(plain {timed['plain_call_ms']:.5f}, SDPA "
            f"{timed['library_call_ms']:.5f} ms); max abs err {err:.3e} "
            f"(SDPA {lib_err:.3e}) against the fp32 plain version"
            + (f"; SDPA ran {backend}" if backend else ""))
        del q, k, v, want
    return rows


def time_attention_training(torch, shape) -> dict:
    """K5's forward with its rows' LSE (what a training step's forward
    runs) at ``shape`` (b, h, g, sq, sk, d, dv) in bf16, causal: card
    time, the plain version (output and LSE), SDPA's forward, bound, max
    abs err of the output against the fp32 plain version; -> a nested
    row."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (
        flash_attention_lse, fwd_route,
    )

    gen = torch.Generator(device="cuda")
    gen.manual_seed(78)
    b, h, g, sq, sk, d, dv = shape
    q, k, v = _attention_inputs(torch, gen, torch.bfloat16, (b, h, sq, d),
                                (b, g, sk, d), (b, g, sk, dv))
    _out, _lse, err, lse_err = k5_out(torch, q, k, v)
    kern = lambda _: flash_attention_lse(q, k, v)
    plain = lambda _: (ref.flash_attention_ref(q, k, v),
                       ref.flash_attention_lse_ref(q, k))
    lib = lambda _: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                   enable_gqa=True)
    timed = {}
    for key, fn in (("", kern), ("plain_", plain), ("library_", lib)):
        c_ms = call_ms(torch, fn, None, reps=10, warmup=2)
        timed[key + "call_ms"] = c_ms
        timed[key + "ms"] = device_ms(torch, fn, None, c_ms, reps=10)
    b_ms, b_by, nbytes = attention_bound("flash_attention", shape, 2)
    log(f"flash_attention at {shape} bf16 with its LSE (the training "
        f"shape, {fwd_route(torch.bfloat16, d, dv)} route): card "
        f"{timed['ms']:.5f} ms (bound {b_ms:.5f} ms by {b_by}, "
        f"plain {timed['plain_ms']:.5f} ms, SDPA {timed['library_ms']:.5f} "
        f"ms); max abs err {err:.3e}, LSE {lse_err:.3e}")
    return {"shape": list(shape), "lse": True,
            "route": fwd_route(torch.bfloat16, d, dv), "ms": timed["ms"],
            "plain_ms": timed["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": timed["library_ms"], "max_abs_err": err,
            "lse_max_abs_err": lse_err, "bytes": nbytes,
            "call_ms": timed["call_ms"]}


def scan_bound(name: str, shape, itemsize: int):
    """(bound_ms, bound_by, bytes) of one K7 or K8 launch: inputs read once
    and outputs written once over the memory rate (r/k/v/w/u and the
    output in the inputs' type, the final state fp32; K8's log_a, B, C and
    state fp32); two multiply-adds per state element and step (K7: the
    output and the update; K8: the update and C H) over the bf16
    tensor-core rate."""
    if name == "rwkv6_scan":
        b, h, t, dk, dv = shape
        nbytes = (itemsize * (3 * b * h * t * dk + 2 * b * h * t * dv + h * dk)
                  + 4 * b * h * dk * dv)
        ops = 4 * b * h * t * dk * dv
    else:
        b, h, t, p, n = shape
        nbytes = (itemsize * 2 * b * h * t * p
                  + 4 * (b * h * t + 2 * b * t * n + b * h * n * p))
        ops = 4 * b * h * t * n * p
    return _larger(nbytes, ops, BF16_TENSOR_OPS_PER_S)


def events_ms(torch, fn, reps: int = 3) -> float:
    """Median over ``reps`` of CUDA events around one call: for the plain
    scans, whose one call is T steps of PyTorch launches (more than can
    queue behind ``device_ms``'s sleep), so the host's pace is in it."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def time_scans(torch, ops, served, worst) -> list:
    """K7 and K8 at the shape their serve path gave them, bf16 inputs:
    card time, plain version, bound; -> their ``kernels`` rows.  No single
    PyTorch call computes either scan (``library_ms`` null)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.mamba2_ssd import mamba2_ssd
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan

    gen = torch.Generator(device="cuda")
    gen.manual_seed(88)
    bf16 = torch.bfloat16
    rows = []
    for name, arch in (("rwkv6_scan", "rwkv6-7b"), ("mamba2_ssd", "zamba2-2.7b")):
        _cfg, counts, shapes = served[arch]
        shape = shapes[name].most_common(1)[0][0]
        if name == "rwkv6_scan":
            ins = rwkv6_inputs(torch, gen, shape, "reference", bf16)
            kern = lambda: rwkv6_scan(*ins)
            plain = lambda: ref.rwkv6_ref(*ins)
            want = ref.rwkv6_ref(*(a.float() for a in ins))
        else:
            ins = mamba2_inputs(torch, gen, shape, bf16)
            kern = lambda: mamba2_ssd(*ins)
            plain = lambda: ref.mamba2_ref(*ins)
            want = ref.mamba2_ref(ins[0].float(), *ins[1:])
        got = kern()
        torch.cuda.synchronize()
        shares = {}
        err = _scan_err(torch, got[0], want[0], f"{name} at the serve shape "
                        f"{shape}", shares, "out")
        _scan_err(torch, got[1], want[1], f"{name} state at {shape}", shares,
                  "state")
        del got, want
        before = ops.launch_counts()[name]
        c_ms = call_ms(torch, lambda _: kern(), None)
        ms = device_ms(torch, lambda _: kern(), None, c_ms)
        assert ops.launch_counts()[name] > before  # the timing ran the kernel
        plain_ms = events_ms(torch, plain)
        b_ms, b_by, nbytes = scan_bound(name, shape, 2)
        source, replaces = KERNEL_INFO[name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "library": None, "path": f"serve {arch} prefill",
            "shape": list(shape), "dtype": "bfloat16", "bytes": nbytes,
            "call_ms": c_ms,
            "plain_timing": "CUDA events around one call, median of 3",
            "tol_share": shares,
            "design": KERNEL_DESIGN.get(name, {}).get("bfloat16"),
            "design_by_dtype": KERNEL_DESIGN.get(name),
            "max_abs_err_fp32_checks": worst[(name, "float32")],
            "max_abs_err_bf16_checks": worst[(name, "bfloat16")],
        })
        log(f"{name} at {shape} bf16: card {ms:.5f} ms (bound {b_ms:.5f} ms "
            f"by {b_by}, plain {plain_ms:.5f} ms, library none); per call "
            f"with host overhead {c_ms:.5f} ms; max abs err {err:.3e} "
            "against the fp32 plain version")
        del ins
    return rows


#: K9's and K10's timed shapes: one cluster's column of phase 3 (4,000,000
#: entries over 16 clusters: the 8-byte id column and the int64 offsets),
#: then a large buffer where the memory rate shows; (shape, K10 dtype)
CODEC_TIMED = {
    "byteshuffle": [((250_000, 8), None), ((16_777_216, 8), None)],
    "delta_zigzag": [((250_000,), "int64"), ((16_777_216,), "int64"),
                     ((16_777_216,), "int32")],
}


def time_codec(torch, kernels, counts) -> list:
    """K9 and K10 at ``CODEC_TIMED``: card time, plain version, library
    call (K9: ``t().contiguous()``, the plain version itself; K10: none),
    bound.  -> their ``kernels`` rows: the first shape in the row, the
    others nested under ``at``."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(111)
    fns = kernel_fns(kernels)
    rows = []
    for name, timed in CODEC_TIMED.items():
        at = [time_wrapper(torch, fns, name, shape, gen, dname)
              for shape, dname in timed]
        source, replaces = KERNEL_INFO[name]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": counts[name],
               "path": "the op entries (phase 5)", "library": fns[name][2]}
        if name in KERNEL_DESIGN:
            row["design"] = KERNEL_DESIGN[name]["uint8"]
        row.update(at[0])
        row["at"] = at[1:]
        rows.append(row)
    return rows



# ---------------------------------------------------------------------------
# phase 7: the train path


#: K5's backward against its plain version, as |got - want| <= tol (1 +
#: |want|): fp32 within 2e-5 (the same sums in another order, over up to
#: 1,024 keys); bf16 gradients (rounded once to bf16 at the store, 2^-9
#: relative) against the plain version in fp32 on the same bf16 inputs and
#: output, within 1e-2
BWD_TOL = {"float32": 2e-5, "bfloat16": 1e-2}
#: K5's LSE (the rows' log-sum-exp its forward hands to the backward)
#: against ``ref.flash_attention_lse_ref`` in fp32 on the same values, as
#: |got - want| <= tol (1 + |want|): the same sums in another order, and
#: the bf16 route's ``exp2`` / ``log2`` in place of ``exp`` / ``log``
LSE_TOL = 2e-5
#: the train path's model and batch: smollm-360m at full width and depth,
#: (8, 1024) token batches
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ = "smollm-360m", 8, 1024
#: the train path's corpus (documents of ``synth_corpus``)
TRAIN_DOCS = 8000
#: the second train path: gemma-2b at full width and depth (18 layers,
#: d_model 2048, 8 query heads over 1 kv head of 256, GeGLU, vocab
#: 256,000, tied and scaled embeddings) on the same corpus (its token ids
#: lie below 49,152) and loader, at the largest batch of ``GEMMA_BATCHES``
#: that fits the card: one untimed step, then ``GEMMA_STEPS`` timed
GEMMA_ARCH, GEMMA_BATCHES, GEMMA_STEPS = "gemma-2b", (8, 4, 2, 1), 5
#: K5's backward's timed shapes (b, h, g, sq, sk, d[, dv]): the training
#: heads of smollm-360m, gemma-2b, chameleon-34b (head dim 128),
#: minicpm3-4b (MLA: q/k 96, v 64) and zamba2-2.7b's shared attention
#: blocks (head dim 80), causal
BWD_TIMED = {TRAIN_ARCH: (TRAIN_BATCH, 15, 5, TRAIN_SEQ, TRAIN_SEQ, 64),
             GEMMA_ARCH: (8, 8, 1, TRAIN_SEQ, TRAIN_SEQ, 256),
             "chameleon-34b": (TRAIN_BATCH, 64, 8, TRAIN_SEQ, TRAIN_SEQ,
                               128),
             "minicpm3-4b": (TRAIN_BATCH, 40, 40, TRAIN_SEQ, TRAIN_SEQ, 96,
                             64),
             "zamba2-2.7b": (TRAIN_BATCH, 32, 32, TRAIN_SEQ, TRAIN_SEQ, 80)}


def bwd_cases():
    """K5 backward cases (b, h, g, sq, sk, d, dv, causal, window): the
    training shapes (phase 10 (b)'s families' too: MLA's q/k 96 with v 64,
    zamba2-2.7b's head dim 80), a window, a ragged Sq, the other built
    head dims (32 non-causal with a padded kv tile, 80 MQA, 80 ragged and
    windowed, 128 windowed, 256 ragged and windowed, 256 with an odd
    group, whose heads do not split over two blocks), 96 / 64 ragged and
    windowed, and Sq > Sk under the causal mask, whose first Sq - Sk rows
    see no key (a q tile of them wholly; at 64, 128 and 256; two q tiles
    of the forward's 128 rows at 128 and 256, its split route)."""
    return [
        (8, 15, 5, 1024, 1024, 64, 64, True, None),    # smollm-360m
        (8, 16, 16, 1024, 1024, 128, 128, True, None),  # deepseek-moe-16b
        (8, 48, 8, 1024, 1024, 128, 128, True, 4096),   # mixtral-8x22b
        (8, 64, 8, 1024, 1024, 128, 128, True, None),   # chameleon-34b
        (8, 32, 32, 1024, 1024, 64, 64, True, None),    # musicgen-large
        (8, 40, 40, 1024, 1024, 96, 64, True, None),    # minicpm3-4b (MLA)
        (8, 32, 32, 1024, 1024, 80, 80, True, None),    # zamba2-2.7b
        (2, 15, 5, 1024, 1024, 64, 64, True, 256),      # window
        (2, 15, 5, 300, 1024, 64, 64, True, None),      # ragged Sq
        (2, 8, 8, 300, 1024, 96, 64, True, None),       # MLA, ragged Sq
        (2, 15, 5, 1024, 1024, 96, 64, True, None),     # MLA, GQA 3:1
        (3, 40, 40, 1000, 1000, 96, 64, True, None),    # MLA, items past the grid
        (1, 8, 8, 700, 700, 96, 64, True, 129),         # MLA, window
        (1, 6, 2, 77, 130, 32, 32, False, None),
        (1, 4, 1, 200, 200, 80, 80, True, None),
        (1, 4, 2, 150, 150, 128, 128, True, 40),
        (1, 4, 2, 203, 130, 64, 64, True, None),        # 73 rows see no key
        (1, 8, 1, 203, 130, 128, 128, True, None),      # the same at D=128
        (1, 4, 4, 200, 333, 80, 80, True, 70),          # D=80 ragged, window
        (8, 8, 1, 1024, 1024, 256, 256, True, None),    # gemma-2b training
        (1, 8, 1, 300, 517, 256, 256, True, 100),       # D=256 ragged, window
        (1, 3, 1, 190, 190, 256, 256, True, None),      # D=256, odd group
        (1, 8, 1, 203, 130, 256, 256, True, None),      # D=256, Sq > Sk
        # the forward's split route with whole query tiles that see no key
        (1, 8, 2, 400, 130, 128, 128, True, None),      # 270 rows
        (1, 4, 1, 330, 60, 256, 256, True, None),       # 270 rows
    ]


def empty_rows(sq: int, sk: int, causal: bool) -> int:
    """How many first query rows see no key: row i sits at position i +
    Sk - Sq, and under the causal mask sees no key below position 0."""
    return max(0, sq - sk) if causal else 0


def k5_out(torch, q, k, v, causal=True, window=None):
    """K5's forward with its LSE on the card, the output held against its
    plain version within ``ATTN_TOL`` (0 in a row that sees no key, where
    the plain version is NaN) and the LSE within ``LSE_TOL``; -> (out,
    lse, max abs err of out, of lse)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_lse

    out, lse = flash_attention_lse(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    e = empty_rows(q.shape[2], k.shape[2], causal)
    want = ref.flash_attention_ref(q[:, :, e:].float(), k.float(), v.float(),
                                   causal=causal, window=window)
    dname = str(q.dtype).split(".")[-1]
    what = (f"{dname} at {tuple(q.shape)} over {tuple(k.shape)} "
            f"causal={causal} window={window}")
    if bool(out[:, :, :e].any()):
        fail(f"flash_attention {what}: a row that sees no key is not 0")
    err = _attention_err(torch, out[:, :, e:], want, ATTN_TOL[dname],
                         f"flash_attention {what}")
    want_lse = ref.flash_attention_lse_ref(q, k, causal=causal, window=window)
    lse_err = _attention_err(torch, lse, want_lse, LSE_TOL,
                             f"flash_attention's LSE {what}")
    return out, lse, err, lse_err


def check_attention_bwd(torch) -> dict:
    """K5's forward with its LSE, then its backward on the forward's output
    and LSE, against ``ref.flash_attention_ref``,
    ``ref.flash_attention_lse_ref`` and ``ref.flash_attention_bwd_ref`` in
    fp32 and bf16; -> the worst error per (kernel, dtype), the LSE's under
    ``flash_attention_lse``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2468)
    worst = {}
    for dname, tol in BWD_TOL.items():
        dtype = getattr(torch, dname)
        for b, h, g, sq, sk, d, dv, causal, window in bwd_cases():
            q, k, v, do = _attention_inputs(torch, gen, dtype, (b, h, sq, d),
                                            (b, g, sk, d), (b, g, sk, dv),
                                            (b, h, sq, dv))
            out, lse, f_err, l_err = k5_out(torch, q, k, v, causal, window)
            for key, err in ((("flash_attention", dname), f_err),
                             (("flash_attention_lse", dname), l_err)):
                worst[key] = max(worst.get(key, 0.0), err)
            got = flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                      window=window)
            torch.cuda.synchronize()
            # the rows that see no key: dq 0, nothing to dk or dv; the
            # plain version (NaN there) takes the others
            e = empty_rows(sq, sk, causal)
            if bool(got[0][:, :, :e].any()):
                fail(f"flash_attention_bwd {dname} at "
                     f"{(b, h, g, sq, sk, d, dv)}: dq of a row that sees no "
                     "key is not 0")
            want = ref.flash_attention_bwd_ref(
                q[:, :, e:].float(), k.float(), v.float(),
                out[:, :, e:].float(), lse[:, :, e:], do[:, :, e:].float(),
                causal=causal, window=window)
            got = (got[0][:, :, e:], *got[1:])
            for name, a, w in zip(("dq", "dk", "dv"), got, want):
                err = _attention_err(torch, a, w, tol, (
                    f"flash_attention_bwd {name} {dname} at "
                    f"{(b, h, g, sq, sk, d, dv)} causal={causal} "
                    f"window={window}"))
                key = ("flash_attention_bwd", dname)
                worst[key] = max(worst.get(key, 0.0), err)
            del q, k, v, do, out, lse, got, want
    for (name, dname), err in sorted(worst.items()):
        tol = {"flash_attention": ATTN_TOL[dname], "flash_attention_lse":
               LSE_TOL, "flash_attention_bwd": BWD_TOL[dname]}[name]
        log(f"kernel {name} {dname}: within {tol} of its plain version at "
            f"the {len(bwd_cases())} backward shapes (max abs err {err:.3e}"
            f"{'; dq, dk, dv on the forward output and LSE' if 'bwd' in name else ''})")
    return worst


#: K5's backward's launches, as their names appear in a trace: dQ and
#: dK/dV (prefixes of the pair route's ``bwd_dq_wgmma_pair`` and
#: ``bwd_dkv_wgmma_pair`` and of head dim 256's ``bwd_dq_wgmma256`` and
#: ``bwd_dkv_wgmma256`` too)
BWD_LAUNCHES = ("bwd_dq_wgmma", "bwd_dkv_wgmma")


def attention_bwd_bound(shape, itemsize: int):
    """(bound_ms, bound_by, bytes) of one K5 backward call on this run's
    inputs, ``shape`` (b, h, g, sq, sk, d[, dv]): q, k, v, o and dO read
    once and dq, dk, dv written once over the memory rate; five products
    per visible (query, key) pair, three of ``2 D`` operations (QK^T again,
    dS K, dS^T Q) and two of ``2 Dv`` (dO V^T, P^T dO), over the bf16
    tensor-core rate; causal pairs with ``q_offset = Sk - Sq``."""
    b, h, g, sq, sk, d = shape[:6]
    dv = shape[6] if len(shape) > 6 else d
    off = sk - sq
    pairs = sum(max(0, min(sk, i + off + 1)) for i in range(sq))
    ops = 2 * b * h * pairs * (3 * d + 2 * dv)
    nbytes = itemsize * (b * h * sq + b * g * sk) * (2 * d + 2 * dv)
    return _larger(nbytes, ops, BF16_TENSOR_OPS_PER_S)


def time_attention_bwd(torch, arch: str, launches: int, worst: dict) -> dict:
    """K5's backward at ``arch``'s training shape (``BWD_TIMED``) in bf16,
    two calls held bit for bit: card time (and each launch's from a
    trace), plain version, SDPA's backward (``torch.autograd.grad`` through
    ``scaled_dot_product_attention(is_causal=True, enable_gqa=True)`` on a
    kept graph, with the backend it ran), bound; K5's forward there with and without its LSE,
    and SDPA's forward; -> its ``kernels`` row."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_lse, fwd_route,
    )

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1357)
    shape = BWD_TIMED[arch]
    b, h, g, sq, sk, d = shape[:6]
    dv = shape[6] if len(shape) > 6 else d
    q, k, v, do = _attention_inputs(torch, gen, torch.bfloat16, (b, h, sq, d),
                                    (b, g, sk, d), (b, g, sk, dv),
                                    (b, h, sq, dv))
    out, lse, _f_err, _l_err = k5_out(torch, q, k, v)
    kern = lambda _: flash_attention_bwd(q, k, v, out, lse, do)
    plain = lambda: ref.flash_attention_bwd_ref(q, k, v, out, lse, do)
    want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                       out.float(), lse, do.float())
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                              enable_gqa=True)
    lib = lambda _: torch.autograd.grad(sdpa_out, leaves, do,
                                        retain_graph=True)
    lib_err = max(float((a.float() - w).abs().max())
                  for a, w in zip(lib(None), want))
    backend = type(sdpa_out.grad_fn).__name__  # the SDPA route it ran
    got = kern(None)
    torch.cuda.synchronize()
    err = max(_attention_err(torch, a, w, BWD_TOL["bfloat16"],
                             f"flash_attention_bwd at {shape}")
              for a, w in zip(got, want))
    # no atomics: a second call gives the same bits
    if not all(torch.equal(a, b) for a, b in zip(got, kern(None))):
        fail(f"flash_attention_bwd at {shape}: two calls differ in bits")
    timed = {}
    fwd = {"fwd_": lambda _: flash_attention(q, k, v),  # no graph: no LSE
           "fwd_lse_": lambda _: flash_attention_lse(q, k, v),
           "library_fwd_": lambda _: F.scaled_dot_product_attention(
               q, k, v, is_causal=True, enable_gqa=True)}
    for key, fn in (("", kern), ("library_", lib), *fwd.items()):
        c_ms = call_ms(torch, fn, None, reps=10, warmup=2)
        timed[key + "call_ms"] = c_ms
        timed[key + "ms"] = device_ms(torch, fn, None, c_ms, reps=10)
    reps = 10
    by_launch = {}  # card ms a launch (a trace may miss the first launch)

    def queued(fn):
        # the calls queue behind a 20 ms sleep kernel, so that the
        # profiler's device tracing is on before the first of them runs:
        # after phase 8 (e) traces of 10 bare calls held none or few of them
        torch.cuda._sleep(int(2e6 * 20))
        for _ in range(reps):
            fn(None)

    for what, fn in (("", kern), ("sdpa ", lib)):
        want = () if what else BWD_LAUNCHES
        for _attempt in range(3):
            _busy, by_name = trace_card(
                torch, f"flash_attention_bwd_{reps}_calls",
                lambda: queued(fn), None, top=0)
            by_name = {k: v for k, v in by_name.items()
                       if "spin_kernel" not in k}  # the sleep
            if by_name and all(any(n in k for k in by_name) for n in want):
                break
            log("  the trace missed launches; tracing again")
        if what:  # every kernel of SDPA's backward, by name
            by_launch["sdpa"] = {key[:80]: t / c / 1e3 for key, (t, c) in
                                 by_name.items()}
            continue
        for n in BWD_LAUNCHES:
            hits = [tc for key, tc in by_name.items() if n in key]
            if not hits:
                fail(f"the trace of {reps} calls holds no launch of {n}")
            by_launch[n] = (sum(t for t, _ in hits) / sum(c for _, c in hits)
                            / 1e3)
    plain_ms = events_ms(torch, plain)
    b_ms, b_by, nbytes = attention_bwd_bound(shape, 2)
    source, replaces = KERNEL_INFO["flash_attention_bwd"]
    log(f"flash_attention_bwd at {shape} bf16: card {timed['ms']:.5f} ms "
        f"(bound {b_ms:.5f} ms by {b_by}, plain {plain_ms:.5f} ms, SDPA "
        f"backward {timed['library_ms']:.5f} ms); per call with host "
        f"overhead {timed['call_ms']:.5f} ms (SDPA "
        f"{timed['library_call_ms']:.5f} ms); max abs err {err:.3e} (SDPA "
        f"{lib_err:.3e}) against the fp32 plain version; SDPA ran {backend}")
    log("flash_attention_bwd launches (trace, ms a launch): " + ", ".join(
        f"{n} {ms:.5f}" for n, ms in by_launch.items() if n != "sdpa")
        + "; SDPA's: " + ", ".join(f"{n} {ms:.5f}" for n, ms in
                                   by_launch["sdpa"].items()))
    route = fwd_route(torch.bfloat16, d, dv)
    log(f"flash_attention at {shape} bf16 (the training shape, {route} "
        f"route): card {timed['fwd_ms']:.5f} ms without its LSE, "
        f"{timed['fwd_lse_ms']:.5f} ms with it; SDPA forward "
        f"{timed['library_fwd_ms']:.5f} ms")
    return {"name": "flash_attention_bwd", "route": "cuda", "source": source,
            "replaces": replaces,
            "replaces_note": "no pallas_call: the reference differentiates "
                             "the op entry",
            "launches": launches, "max_abs_err": err, "ms": timed["ms"],
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": timed["library_ms"],
            "library": "torch.autograd.grad through torch.nn.functional."
                       "scaled_dot_product_attention",
            "library_backend": backend,
            "launch_ms": by_launch,
            "forward_ms": {"no_lse": timed["fwd_ms"],
                           "lse": timed["fwd_lse_ms"],
                           "library": timed["library_fwd_ms"],
                           "route": route},
            "design": KERNEL_DESIGN["flash_attention_bwd"]["bfloat16"],
            "design_by_dtype": KERNEL_DESIGN["flash_attention_bwd"],
            "path": f"train {arch}",
            "shape": list(shape), "dtype": "bfloat16", "bytes": nbytes,
            "call_ms": timed["call_ms"],
            "library_call_ms": timed["library_call_ms"],
            "library_max_abs_err": lib_err,
            "max_abs_err_fp32_checks": worst["flash_attention_bwd", "float32"],
            "max_abs_err_bf16_checks": worst["flash_attention_bwd", "bfloat16"],
            "lse_max_abs_err": max(worst["flash_attention_lse", d]
                                   for d in ("float32", "bfloat16"))}


#: K7's and K8's backward at the training shapes of phase 10 (b)'s
#: rwkv6-7b (b, h, t, Dk, Dv) and zamba2-2.7b (b, h, t, P, N), as the
#: models give them: (8, 1024) batches, bf16
SCAN_BWD_TIMED = {"rwkv6_scan_bwd": ("rwkv6-7b", (TRAIN_BATCH, 64, TRAIN_SEQ,
                                                  64, 64)),
                  "mamba2_ssd_bwd": ("zamba2-2.7b", (TRAIN_BATCH, 80,
                                                     TRAIN_SEQ, 64, 64))}


def scan_bwd_cases():
    """K7's and K8's backward cases: every case of ``scan_cases()`` (T of
    1 and ragged, every state width, Dv and P up to 1,024, decays of
    exactly 0 and log_a of -inf and -1e4) and the training shapes, a
    final-state cotangent in every other case and at the training shapes;
    -> (K7 cases (shape, decay, with_state), K8 cases (shape, decay,
    with_state))."""
    rwkv6, mamba2 = scan_cases()
    r = [(c[:5], c[5], i % 2 == 0) for i, c in enumerate(rwkv6)]
    m = [(c[:5], c[5] if len(c) > 5 else "reference", i % 2 == 1)
         for i, c in enumerate(mamba2)]
    r.append((SCAN_BWD_TIMED["rwkv6_scan_bwd"][1], "reference", True))
    m.append((SCAN_BWD_TIMED["mamba2_ssd_bwd"][1], "reference", True))
    return r, m


def scan_bwd_inputs(torch, gen, name: str, shape, decay: str, with_state,
                    dtype):
    """(the forward's inputs, the output's cotangent, the final state's
    or None) on the card."""
    if name == "rwkv6_scan_bwd":
        b, h, t, dk, dv = shape
        ins = rwkv6_inputs(torch, gen, shape, decay, dtype)
        rows, cols = dk, dv
    else:
        b, h, t, p, n = shape
        ins = mamba2_inputs(torch, gen, shape, dtype, decay)
        rows, cols = n, p
    dout = torch.randn((b, h, t, cols), generator=gen,
                       device="cuda").to(dtype)
    ds = (torch.randn((b, h, rows, cols), generator=gen, device="cuda")
          if with_state else None)
    return ins, dout, ds


def scan_bwd_fns(name: str):
    """(the backward wrapper, its plain version, the names of its
    gradients)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.mamba2_ssd import mamba2_ssd_bwd
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_bwd

    if name == "rwkv6_scan_bwd":
        return (rwkv6_scan_bwd, ref.rwkv6_bwd_ref,
                ("dr", "dk", "dv", "dw", "du"))
    return mamba2_ssd_bwd, ref.mamba2_bwd_ref, ("dx", "dlog_a", "dB", "dC")


def check_scan_bwd(torch) -> dict:
    """K7's and K8's backward against their plain versions from the same
    input values (the bf16 route's in fp32; the fp32 route's in fp64: the
    kernels carry their sums in fp64, and an fp32 plain version's own
    rounding, at sums that cancel, used up to 0.83 of 2e-5 (1 + |want|)) at
    ``scan_bwd_cases()``, every gradient finite and within ``BWD_TOL`` of
    its route as ``|got - want| <= tol (1 + |want|)``; -> the worst error
    per (kernel, dtype)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8642)
    worst, shares = {}, {}
    cases = dict(zip(("rwkv6_scan_bwd", "mamba2_ssd_bwd"), scan_bwd_cases()))
    for dname, tol in BWD_TOL.items():
        dtype = getattr(torch, dname)
        wide = torch.float64 if dtype == torch.float32 else torch.float32
        for name, kcases in cases.items():
            kern, plain, names = scan_bwd_fns(name)
            for shape, decay, with_state in kcases:
                ins, dout, ds = scan_bwd_inputs(torch, gen, name, shape,
                                                decay, with_state, dtype)
                got = kern(*ins, dout, ds)
                torch.cuda.synchronize()
                want = plain(*(a.to(wide) for a in ins), dout.to(wide),
                             None if ds is None else ds.to(wide))
                key = (name, dname)
                for g_name, a, w in zip(names, got, want):
                    what = (f"{name} {g_name} {dname} at {tuple(shape)} decay "
                            f"{decay}{' with a state cotangent' if with_state else ''}")
                    if not bool(torch.isfinite(a.float()).all()):
                        fail(f"{what} is not finite")
                    diff = (a.to(wide) - w).abs()
                    share = float((diff / (tol * (1 + w.abs()))).max())
                    if share > 1.0:
                        fail(f"{what} differs from its plain version (max abs "
                             f"err {float(diff.max()):.3e}, tol {tol})")
                    worst[key] = max(worst.get(key, 0.0), float(diff.max()))
                    shares[key] = max(shares.get(key, 0.0), share)
                del ins, dout, ds, got, want
    for (name, dname), err in sorted(worst.items()):
        log(f"kernel {name} {dname}: finite and within {BWD_TOL[dname]} of "
            f"its plain version at {len(cases[name])} shapes (max abs err "
            f"{err:.3e}; largest share of the tolerance "
            f"{shares[(name, dname)]:.4f})")
    return worst


def scan_bwd_bound(name: str, shape, itemsize: int):
    """(bound_ms, bound_by, bytes) of one K7 or K8 backward launch on this
    run's inputs (with a final-state cotangent): the forward's inputs, the
    cotangents and the gradients each moved once (in the inputs' type; the
    state's cotangent, K8's log_a, B, C and their gradients fp32) over
    the memory rate; the operations of the meta op's FLOP formula (the
    recomputed state update and the reverse recurrence: 16 a state
    element and step for K7, 14 for K8) over the bf16 tensor-core rate."""
    if name == "rwkv6_scan_bwd":
        b, h, t, dk, dv = shape
        # r, k, w, v, u, dout in; dr, dk, dw, dv, du out; dstate in fp32
        nbytes = (itemsize * (6 * b * h * t * dk + 3 * b * h * t * dv
                              + 2 * h * dk)
                  + 4 * b * h * dk * dv)
        ops = 16 * b * h * t * dk * dv
    else:
        b, h, t, p, n = shape
        # x, dy in and dx out; log_a, B, C in and their gradients out,
        # dstate in, fp32
        nbytes = (itemsize * 3 * b * h * t * p
                  + 4 * 2 * (b * h * t + 2 * b * t * n) + 4 * b * h * n * p)
        ops = 14 * b * h * t * n * p
    return _larger(nbytes, ops, BF16_TENSOR_OPS_PER_S)


def time_scan_bwd(torch, ops, name: str, launches: int, worst: dict) -> dict:
    """K7's or K8's backward at its training shape (``SCAN_BWD_TIMED``) in
    bf16 with a final-state cotangent: card time (30 launches queued
    behind a sleep), per call with its host overhead, plain version,
    bound; no PyTorch call computes it (``library_ms`` null); the launch's
    workspace as the C library sizes it, which must be the dry-run's
    count; -> its ``kernels`` row."""
    from repro_torch.kernels import _build, meta

    arch, shape = SCAN_BWD_TIMED[name]
    # the launch's workspace as the C library sizes it: the dry-run's
    # count of it (phase 10 (b)'s peaks) must be the same
    if name == "rwkv6_scan_bwd":
        kind, (b, h, t, rows, cols) = "wkv", shape    # rows Dk, cols Dv
    else:
        kind, (b, h, t, cols, rows) = "ssd", shape    # rows N, cols P
    query = getattr(_build.library("ssm"), f"repro_{name}_ws")
    ws = 4 * query(b, h, t, rows, cols, 1)  # dtype 1: bf16
    ws_dry = meta.scan_bwd_workspace_bytes(kind, torch.bfloat16, b, h, t,
                                           rows, cols)
    if ws != ws_dry:
        fail(f"{name}'s workspace at {shape}: {ws} bytes, the dry-run "
             f"counts {ws_dry}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    kern, plain, _names = scan_bwd_fns(name)
    ins, dout, ds = scan_bwd_inputs(torch, gen, name, shape, "reference",
                                    True, torch.bfloat16)
    got = kern(*ins, dout, ds)
    want = plain(*(a.float() for a in ins), dout.float(), ds)
    torch.cuda.synchronize()
    err = max(float((a.float() - w).abs().max()) for a, w in zip(got, want))
    del got, want
    before = ops.launch_counts()[name]
    c_ms = call_ms(torch, lambda _: kern(*ins, dout, ds), None)
    ms = device_ms(torch, lambda _: kern(*ins, dout, ds), None, c_ms)
    assert ops.launch_counts()[name] > before  # the timing ran the kernel
    plain_ms = events_ms(torch, lambda: plain(*ins, dout, ds))
    b_ms, b_by, nbytes = scan_bwd_bound(name, shape, 2)
    source, replaces = KERNEL_INFO[name]
    log(f"{name} at {shape} bf16 ({arch}'s training shape): card {ms:.5f} ms "
        f"(bound {b_ms:.5f} ms by {b_by}, plain {plain_ms:.5f} ms, library "
        f"none); per call with host overhead {c_ms:.5f} ms; max abs err "
        f"{err:.3e} against the fp32 plain version; workspace of a launch "
        f"{ws / 2**30:.4f} GiB, the dry-run's")
    del ins, dout, ds
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "replaces_note": "no pallas_call: the reference differentiates "
                             "the op entry",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "library": None, "path": f"train {arch}",
            "shape": list(shape), "dtype": "bfloat16", "bytes": nbytes,
            "workspace_bytes": ws,
            "call_ms": c_ms,
            "plain_timing": "CUDA events around one call, median of 3",
            "design": KERNEL_DESIGN[name]["bfloat16"],
            "max_abs_err_fp32_checks": worst[(name, "float32")],
            "max_abs_err_bf16_checks": worst[(name, "bfloat16")]}


def check_loader(np, torch, ops, PackedLoader, path: str, n_tokens: int):
    """One epoch and a wrap of the device engine against the host engine,
    token for token, then the same after a mid-cluster ``load_state``; ->
    (batches, device-engine seconds, launches of that stream)."""
    need = TRAIN_BATCH * (TRAIN_SEQ + 1)
    n_batches = n_tokens // need + 40  # the epoch, and a wrap
    ops.reset_launch_counts()
    dev = PackedLoader(path, TRAIN_BATCH, TRAIN_SEQ, device="cuda")
    host = PackedLoader(path, TRAIN_BATCH, TRAIN_SEQ, engine="host",
                        device="cuda")
    gd, gh = dev.batches(), host.batches()
    for i in range(n_batches):
        bd, bh = next(gd), next(gh)
        for key in ("tokens", "labels"):
            if not np.array_equal(bd[key].cpu().numpy(), bh[key]):
                fail(f"device loader batch {i} {key} differs from the host "
                     "engine's")
    counts = ops.launch_counts()
    if counts["decode_offset_pages"] <= 0 or counts["unsplit_pages"] <= 0:
        fail(f"the device loader launched no K3/K4: {counts}")
    # mid-cluster resume: the host engine's state 3 batches into the first
    # 4 MiB cluster (the device engine's cursor moves a cluster at a time)
    fresh = PackedLoader(path, TRAIN_BATCH, TRAIN_SEQ, engine="host",
                         device="cuda")
    it = fresh.batches()
    for _ in range(3):
        next(it)
    state = fresh.state()
    if state["entry_cursor"] >= fresh.reader.cluster_entry_range(0)[1]:
        fail("the resume state is not inside the first cluster")
    r_dev = PackedLoader(path, TRAIN_BATCH, TRAIN_SEQ, state=state,
                         device="cuda")
    r_host = PackedLoader(path, TRAIN_BATCH, TRAIN_SEQ, state=state,
                          engine="host", device="cuda")
    gd, gh = r_dev.batches(), r_host.batches()
    for i in range(200):  # past the first cluster's end
        if not np.array_equal(next(gd)["tokens"].cpu().numpy(),
                              next(gh)["tokens"]):
            fail(f"resumed device loader batch {i} differs from the host "
                 "engine's")
    # the device engine alone, one epoch, synchronized at the end
    timed = PackedLoader(path, TRAIN_BATCH, TRAIN_SEQ, device="cuda")
    it = timed.batches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_batches):
        b = next(it)
    torch.cuda.synchronize()
    loader_s = time.perf_counter() - t0
    for ld in (dev, host, fresh, r_dev, r_host, timed):
        ld.close()
    return n_batches, loader_s, counts


def train_want(ops, cfg, steps: int, prefills: int = 0,
               decode_steps: int = 0) -> dict:
    """The launches ``steps`` train steps, ``prefills`` prefills and
    ``decode_steps`` decode steps of a model of the registry make (K3/K4:
    the loader's reads, checked apart): per step, K5 (or K7, K8) twice a
    layer under remat (the backward runs its layer again) and its
    backward once; zamba2-2.7b's shared attention blocks, applied outside
    its layers' remat as in the reference, K5 once."""
    fwd = steps * (2 if cfg.remat else 1)
    want = dict.fromkeys(ops.KERNELS, 0)
    if cfg.family == "ssm":
        want.update(rwkv6_scan=cfg.n_layers * (fwd + prefills),
                    rwkv6_scan_bwd=cfg.n_layers * steps)
        return want
    attn, attn_fwd = cfg.n_layers, fwd
    if cfg.family == "hybrid":
        attn, attn_fwd = cfg.n_layers // cfg.shared_attn_every, steps
        want.update(mamba2_ssd=cfg.n_layers * (fwd + prefills),
                    mamba2_ssd_bwd=cfg.n_layers * steps)
    want.update(flash_attention=attn * (attn_fwd + prefills),
                flash_attention_bwd=attn * steps,
                decode_attention=attn * decode_steps)
    return want


def check_launches(ops, counts: dict, want: dict, what: str,
                   reads: bool = True) -> None:
    """``counts`` must equal ``want``; K3/K4, the loader's cluster reads,
    must be > 0 where ``reads`` and 0 where not (a loader whose restored
    leftover holds every batch it is asked for reads no cluster)."""
    log(f"launches on {what}: {json.dumps(counts)}")
    for name in ops.KERNELS:
        if name in ("decode_offset_pages", "unsplit_pages"):
            if reads and counts[name] < 1:
                fail(f"{name} not launched by the loader on {what}")
            if not reads and counts[name] != 0:
                fail(f"{name} launched {counts[name]} times on {what}, whose "
                     "restored leftover holds all its batches")
        elif counts[name] != want[name]:
            fail(f"{name} launched {counts[name]} times on {what}, expected "
                 f"{want[name]}")


def train_gemma(np, torch, ops, args, path: str, out_dir) -> tuple:
    """gemma-2b at full width and depth (fp32 parameters, bf16 compute,
    remat), from ``--seed``, on the device loader's (B, 1024) batches of
    the ingested corpus: B the largest of ``GEMMA_BATCHES`` whose steps
    fit the card (a batch that runs out of memory is dropped, the state
    made anew); one untimed step and ``GEMMA_STEPS`` timed AdamW
    steps, counted from the first; then one more step under the profiler.
    -> (batch, launch counts)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build
    from repro_torch.pipeline import PackedLoader
    from repro_torch.train import (
        init_train_state, make_optimizer, make_train_step,
    )

    cfg = get_arch(GEMMA_ARCH)
    bundle = build(cfg)
    opt = make_optimizer(peak_lr=3e-4, warmup=1, total=20)
    step = make_train_step(bundle, optimizer=opt)
    too_big = []
    for batch in GEMMA_BATCHES:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state = list(init_train_state(bundle, seed=args.seed, device="cuda",
                                      optimizer=opt))
        ops.reset_launch_counts()
        loader = PackedLoader(path, batch, TRAIN_SEQ, device="cuda")
        batches = loader.batches()
        losses, step_ms = [], []
        before = torch.cuda.memory_stats()
        try:
            for _ in range(1 + GEMMA_STEPS):
                t0 = time.perf_counter()
                state[0], state[1], state[2], m = step(*state, next(batches))
                losses.append(float(m["loss"]))  # syncs
                step_ms.append((time.perf_counter() - t0) * 1e3)
        except torch.cuda.OutOfMemoryError as e:
            too_big.append(batch)
            log(f"train {cfg.name}: batch ({batch}, {TRAIN_SEQ}) does not fit "
                f"the card: {str(e).splitlines()[0]}")
            loader.close()
            del state, batches, loader, e
            continue
        break
    else:
        fail(f"{cfg.name} does not train on the card at any batch of "
             f"{GEMMA_BATCHES}")
    counts = ops.launch_counts()
    shapes = ops.launch_shapes()
    peak = torch.cuda.max_memory_allocated()
    after = torch.cuda.memory_stats()
    alloc = {k: after.get(k, 0) - before.get(k, 0) for k in (
        "num_alloc_retries", "num_device_alloc", "num_device_free")}
    check_launches(ops, counts, train_want(ops, cfg, 1 + GEMMA_STEPS),
                   f"the {cfg.name} train path")
    hd = cfg.resolved_head_dim
    k5_shape = (batch, cfg.n_heads, cfg.n_kv_heads, TRAIN_SEQ, TRAIN_SEQ, hd)
    for name, want in (("flash_attention", k5_shape + (hd,)),
                       ("flash_attention_bwd", k5_shape)):
        if set(shapes[name]) != {want}:
            fail(f"{name} ran at {dict(shapes[name])} on the {cfg.name} "
                 f"train path, expected {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"{cfg.name} train losses {losses}: not finite, or the last "
             "not below the first")
    tokens = batch * TRAIN_SEQ
    mean_ms = sum(step_ms[1:]) / GEMMA_STEPS  # the timed steps
    log(f"train {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads over {cfg.n_kv_heads} of "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff} {cfg.mlp}, vocab "
        f"{cfg.vocab_size}, {cfg.param_count():,} parameters, "
        f"{cfg.param_dtype} parameters, {cfg.compute_dtype} compute, remat "
        f"{cfg.remat}; 1 untimed and {GEMMA_STEPS} timed AdamW steps on "
        f"({batch}, {TRAIN_SEQ}) device-loader batches"
        + (f" (batches {too_big} did not fit)" if too_big else ""))
    log(f"{cfg.name} train losses: {json.dumps(losses)}")
    log(f"{cfg.name} train step ms: {json.dumps(step_ms)} (the first "
        f"untimed); total over {GEMMA_STEPS} timed steps / {GEMMA_STEPS} = "
        f"{mean_ms:.3f} ms = {tokens / mean_ms * 1e3:.1f} tokens/s; "
        f"max_memory_allocated {peak / 2**30:.3f} GiB; the allocator over "
        f"those steps: {json.dumps(alloc)}")
    b_next = next(batches)

    def one_step():
        state[:3] = step(*state, b_next)[:3]

    busy_ms, _ = trace_card(torch, "train_step_gemma", one_step, out_dir,
                            top=30)
    log(f"{cfg.name} train step: card busy {busy_ms:.3f} ms (profiled step) "
        f"against the unprofiled mean step {mean_ms:.3f} ms = "
        f"{100 * busy_ms / mean_ms:.3f} % busy, "
        f"{100 - 100 * busy_ms / mean_ms:.3f} % idle")
    loader.close()
    del state, b_next, batches
    gc.collect()
    torch.cuda.empty_cache()
    return batch, counts


def train_path(np, torch, ops, args):
    """Phase 7; -> (the ``kernels`` row of K5's backward, {arch: the launch
    counts of its train run}, the worst K5 errors by (kernel, dtype) at the
    backward's shapes, the corpus file: phase 9 trains smollm-360m on it
    through the loop, and removes its directory)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build
    from repro_torch.pipeline import PackedLoader, ingest_corpus, synth_corpus
    from repro_torch.train import loss_and_grads

    t0 = time.perf_counter()
    worst = check_attention_bwd(torch)
    t1 = time.perf_counter()
    worst.update(check_scan_bwd(torch))
    log(f"phase 7: the backward checks: K5's {t1 - t0:.3f} s, K7's and K8's "
        f"{time.perf_counter() - t1:.3f} s")
    cfg = get_arch(TRAIN_ARCH)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    path = os.path.join(tmp, "corpus.rntj")
    t0 = time.perf_counter()
    stats = ingest_corpus(synth_corpus(TRAIN_DOCS, seed=args.seed, mean_len=512,
                                       vocab=cfg.vocab_size), path,
                          n_workers=4, device="cuda")
    ingest_s = time.perf_counter() - t0
    from repro_torch.core import RNTJReader
    with RNTJReader(path, device="cuda") as r:
        n_clusters, n_docs = r.n_clusters, r.n_entries
        n_tokens = int(r.read_column("tokens._0").shape[0]) + n_docs
    if n_docs != TRAIN_DOCS or n_clusters < 2:
        fail(f"the corpus holds {n_docs} documents in {n_clusters} clusters")
    log(f"train corpus: {n_docs} documents, {n_tokens} tokens with EOS, "
        f"{n_clusters} clusters, {os.path.getsize(path) / 1e6:.3f} MB; "
        f"ingest (generation included) {ingest_s:.3f} s, write "
        f"{stats['entries']} entries")
    n_batches, loader_s, l_counts = check_loader(np, torch, ops, PackedLoader,
                                                 path, n_tokens)
    log(f"loader: {n_batches} batches of ({TRAIN_BATCH}, {TRAIN_SEQ}) (one "
        "epoch and a wrap): device engine equal to the host engine token for "
        "token, and again after a mid-cluster load_state; device engine "
        f"alone {loader_s:.4f} s = {loader_s / n_batches * 1e3:.4f} ms a "
        f"batch = {n_batches * TRAIN_BATCH * TRAIN_SEQ / loader_s:.1f} "
        f"tokens/s; K4 {l_counts['decode_offset_pages']} and K3 "
        f"{l_counts['unsplit_pages']} launches over the checked stream")

    # every parameter of smollm-360m gets a gradient, on a host-engine batch
    # (its steps run through the loop in phase 9 (a))
    bundle = build(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    params = bundle.init(gen, "cuda")
    host = PackedLoader(path, TRAIN_BATCH, TRAIN_SEQ, engine="host",
                        device="cuda")
    first = {k: torch.from_numpy(v).cuda() for k, v in
             next(host.batches()).items()}
    host.close()
    _loss, _m, grads = loss_and_grads(bundle, params, first)

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            return [x for k, v in tree.items() for x in leaves(v, f"{path}/{k}")]
        return [(path, tree)]

    for name, g in leaves(grads):
        if not bool(torch.isfinite(g).all()) or float(g.abs().max()) == 0.0:
            fail(f"parameter {name} got no finite, non-zero gradient")
    log(f"gradients: all {len(leaves(grads))} {cfg.name} parameter tensors "
        "got a finite, non-zero gradient")
    del grads, _loss, _m, params
    gc.collect()
    torch.cuda.empty_cache()
    g_batch, g_counts = train_gemma(np, torch, ops, args, path,
                                    args.profile or tmp)
    by_path = {GEMMA_ARCH: g_counts}
    # the launches of smollm-360m's paths join the row in phases 9 and 10
    row = time_attention_bwd(torch, TRAIN_ARCH, 0, worst)
    at_g = time_attention_bwd(torch, GEMMA_ARCH,
                              g_counts["flash_attention_bwd"], worst)
    row["launches_by_path"] = {f"train {a}": c["flash_attention_bwd"]
                               for a, c in by_path.items()}
    row["launches"] = sum(row["launches_by_path"].values())
    row[f"at_{GEMMA_ARCH}"] = {k: at_g[k] for k in (
        "launches", "shape", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms", "library_backend", "max_abs_err", "launch_ms",
        "forward_ms", "bytes", "call_ms", "library_call_ms",
        "library_max_abs_err")}
    row[f"at_{GEMMA_ARCH}"]["train_batch"] = g_batch
    return row, by_path, worst, path


# ---------------------------------------------------------------------------
# phase 8: multi-process writing, a writer that dies, recovery, merge, a
# remote object, and the train state's checkpoint

#: phase 8 (b): entries of each of its two participants, and the fill
#: batches after which the dying one flushes its cluster and exits
DEATH_ENTRIES, DEATH_AFTER = 300_000, 1
#: phase 8 (b): its participants' lease (the dead one is fenced two leases
#: after its last heartbeat)
DEATH_LEASE_S = 1.0
#: seconds a participant process may take, its start included
CHILD_TIMEOUT_S = 300


def mp_participant(path: str, opts, seed: int, producer: int, entries: int,
                   report: str, die_after=None) -> None:
    """One participant process of phase 8 (started with ``spawn``: its
    parent holds a CUDA context, which a forked child cannot use).  Joins
    the container at ``path`` on the card, writes producer ``producer``'s
    share of the generated data in fill batches, and writes its own launch
    counts (they are per process) and seconds to ``report`` as JSON.  With
    ``die_after`` it flushes its cluster after that many batches, writes
    the report and ``os._exit``\\ s: no DONE, no close."""
    import numpy as np

    from repro_torch import core
    from repro_torch.configs.rntj_writer import SYNTH_EVENT_SCHEMA
    from repro_torch.kernels import ops

    item = make_item(np, seed, producer, entries)
    t0 = time.perf_counter()
    w = core.join_container(path, schema=SYNTH_EVENT_SCHEMA, options=opts,
                            device="cuda")
    t_join = time.perf_counter()
    ctx = w.create_fill_context()
    for k, b in enumerate(batches(core, SYNTH_EVENT_SCHEMA, item)):
        ctx.fill_batch(b)
        if die_after is not None and k + 1 == die_after:
            ctx.flush_cluster()
            break
    if die_after is None:
        ctx.close()
        w.close()
    t_end = time.perf_counter()
    with open(report, "w") as f:
        json.dump({"counts": ops.launch_counts(), "join_s": t_join - t0,
                   "write_s": t_end - t_join, "writer_id": w.writer_id}, f)
    if die_after is not None:
        os._exit(9)  # a crash: the lease left dangling, no DONE


def run_participants(core, path: str, opts, seed: int, entries: int, tmp,
                     producers, die=()) -> tuple:
    """Start one spawned participant per producer, wait for them all, then
    seal.  -> (coordinator report, exit codes, the children's reports,
    seconds from the first start to the seal's end)."""
    import multiprocessing

    from repro_torch.configs.rntj_writer import SYNTH_EVENT_SCHEMA

    ctx = multiprocessing.get_context("spawn")
    coord = core.MultiWriterCoordinator(SYNTH_EVENT_SCHEMA, path, opts)
    t0 = time.perf_counter()
    procs, reports = [], []
    for p in producers:
        rep = os.path.join(tmp, f"participant{p}.json")
        reports.append(rep)
        procs.append(ctx.Process(target=mp_participant, args=(
            path, opts, seed, p, entries, rep,
            DEATH_AFTER if p in die else None)))
    for pr in procs:
        pr.start()
    for pr in procs:
        pr.join(CHILD_TIMEOUT_S)
        if pr.is_alive():
            for q in procs:
                q.kill()
            fail(f"a participant process ran past {CHILD_TIMEOUT_S} s")
    codes = [pr.exitcode for pr in procs]
    # every child has exited: DONE is in the log or never will be
    report = coord.seal(expect_writers=len(procs),
                        timeout=4 * opts.lease_interval + 5)
    coord.close()
    dt = time.perf_counter() - t0
    children = []
    for rep in reports:
        if not os.path.exists(rep):
            fail(f"a participant wrote no report ({rep}); exit codes {codes}")
        with open(rep) as f:
            children.append(json.load(f))
    return report, codes, children, dt


def mp_write(np, torch, core, ops, args, opts, tmp, data, raw_bytes: float,
             threads_s: float) -> dict:
    """Phase 8 (a): ``--producers`` participant processes write the paper
    configuration into one file; -> the launch counts of the children
    (summed) and of the read-back."""
    path = os.path.join(tmp, "mp.rntj")
    report, codes, children, dt = run_participants(
        core, path, opts, args.seed, args.entries, tmp,
        range(args.producers))
    log(f"mp write report: {json.dumps(report)}; exit codes {codes}")
    if any(c != 0 for c in codes):
        fail(f"participant exit codes {codes}")
    if report["fenced"] or report["salvaged"] or report["abandoned"]:
        fail("the mp seal was not clean")
    if os.path.exists(path + ".mpwlog"):
        fail("a clean mp seal left its side-car log")
    if (report["writers"], report["entries"]) != (
            args.producers, args.producers * args.entries):
        fail(f"mp seal: {report['writers']} writers, {report['entries']} "
             "entries")
    for i, c in enumerate(children):
        log(f"  participant {i}: join {c['join_s']:.3f} s, write "
            f"{c['write_s']:.3f} s, K1 {c['counts']['offsets_scan']}, K2 "
            f"{c['counts']['byteshuffle_pages']}")
        if c["counts"]["offsets_scan"] <= 0 or (
                c["counts"]["byteshuffle_pages"] <= 0):
            fail(f"participant {i} launched no K1 or no K2: {c['counts']}")
    write_s = max(c["write_s"] for c in children)
    ops.reset_launch_counts()
    r_s, _stats, n_clusters, _read = check_read_back(np, torch, core, path,
                                                     data, args.entries)
    r_counts = ops.launch_counts()
    if r_counts["unsplit_pages"] <= 0 or r_counts["decode_offset_pages"] <= 0:
        fail(f"the mp read-back launched no K3 or no K4: {r_counts}")
    mb = raw_bytes / 1e6
    log(f"mp write: {args.producers} processes x {args.entries} entries into "
        f"one file, {os.path.getsize(path) / 1e6:.3f} MB, {n_clusters} "
        f"clusters; start to seal {dt:.4f} s = {mb / dt:.3f} MB/s (process "
        f"starts included); slowest participant's join to close "
        f"{write_s:.4f} s = {mb / write_s:.3f} MB/s; phase 3's "
        f"{args.producers}-thread write of the same bytes {threads_s:.4f} s "
        f"= {mb / threads_s:.3f} MB/s; read back equal as a multiset "
        f"({r_s:.4f} s, K3 {r_counts['unsplit_pages']}, K4 "
        f"{r_counts['decode_offset_pages']})")
    os.remove(path)
    summed = dict.fromkeys(ops.KERNELS, 0)
    for c in children:
        for k, v in c["counts"].items():
            summed[k] += v
    return {"mp write": summed, "mp read-back": r_counts}


def mp_death_and_recovery(np, torch, core, ops, args, opts, tmp) -> None:
    """Phase 8 (b): a participant that dies after ``flush_cluster``, then a
    coordinator dropped before its seal."""
    import dataclasses

    from repro_torch.configs.rntj_writer import SYNTH_EVENT_SCHEMA as schema

    d_opts = dataclasses.replace(opts, lease_interval=DEATH_LEASE_S)
    data = make_data(np, args.seed, 2, DEATH_ENTRIES)
    path = os.path.join(tmp, "death.rntj")
    report, codes, children, dt = run_participants(
        core, path, d_opts, args.seed, DEATH_ENTRIES, tmp, (0, 1), die=(1,))
    if codes[0] != 0 or codes[1] != 9:
        fail(f"exit codes {codes}: expected 0 and the dead writer's 9")
    if report["fenced"] != [children[1]["writer_id"]]:
        fail(f"expected the dead writer fenced: {report}")
    _r_s, _st, _n, read = check_read_back(np, torch, core, path, data,
                                          DEATH_ENTRIES, live={0})
    if not 0 < read[1] < DEATH_ENTRIES:
        fail(f"the dead writer's salvage holds {read[1]} entries")
    log(f"a writer that dies: 2 participants x {DEATH_ENTRIES} entries, one "
        f"os._exit after {DEATH_AFTER} fill batch and flush_cluster; "
        f"{dt:.3f} s to the degraded seal; fenced {report['fenced']}, "
        f"{len(report['salvaged'])} clusters salvaged, "
        f"{len(report['abandoned'])} abandoned; the live writer's "
        f"{read[0]} entries complete, the dead writer's {read[1]} a prefix "
        "of its commit order")
    os.remove(path)
    if os.path.exists(path + ".mpwlog"):
        os.remove(path + ".mpwlog")

    # a coordinator dropped before its seal: in-process participants on
    # the card, then neither seal nor footer
    path = os.path.join(tmp, "dropped.rntj")
    coord = core.MultiWriterCoordinator(schema, path, opts)
    errors = []

    def fill(p):
        try:
            w = coord.participant(device="cuda")
            c = w.create_fill_context()
            for b in batches(core, schema, data[p]):
                c.fill_batch(b)
            c.close()
            w.close()
        except BaseException as e:  # re-raised on the main thread
            errors.append(e)

    ts = [threading.Thread(target=fill, args=(p,)) for p in (0, 1)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errors:
        raise errors[0]
    coord.sink.close()  # dropped: no seal
    coord.log.close()
    copy = os.path.join(tmp, "dropped_copy.rntj")
    shutil.copyfile(path, copy)
    shutil.copyfile(path + ".mpwlog", copy + ".mpwlog")
    try:
        core.RNTJReader(copy, device="cuda").close()
        fail("a file without its footer opened")
    except IOError:
        pass
    _s, _st, _n, tol = check_read_back(np, torch, core, copy, data,
                                       DEATH_ENTRIES, tolerant=True)
    t0 = time.perf_counter()
    rep = core.recover_container(copy)
    rec_s = time.perf_counter() - t0
    _s, _st, n_rec, _read = check_read_back(np, torch, core, copy, data,
                                            DEATH_ENTRIES)
    log(f"a dropped coordinator: recover_container rebuilt {n_rec} clusters "
        f"({rep.entries_salvaged} entries, {len(rep.clusters_dropped)} "
        f"dropped) in {rec_s:.4f} s, equal to the generated data; a "
        f"tolerant reader of the torn copy read {sum(tol.values())} entries")
    for f in (path, path + ".mpwlog", copy, copy + ".mpwlog"):
        if os.path.exists(f):
            os.remove(f)


def merge_path(np, core, ops, opts, tmp, data) -> tuple:
    """Phase 8 (c): ``merge_files`` of two one-producer paper files on the
    card, verbatim and re-encoded (``recompress=True``); each output
    byte-identical to the same merge on the numpy backend.  -> (the
    re-encode's launch counts, the path of the first input, written with
    the kernels)."""
    from repro_torch.configs.rntj_writer import SYNTH_EVENT_SCHEMA as schema

    ins = [os.path.join(tmp, f"one{p}.rntj") for p in (0, 1)]
    for f, item in zip(ins, data):
        write_single(core, schema, opts, f, item, "auto")
    counts = {}
    for route, recompress in (("verbatim", None), ("re-encode", True)):
        outs, secs = {}, {}
        for backend in ("auto", "numpy"):
            out = os.path.join(tmp, f"merged_{backend}.rntj")
            ops.reset_launch_counts()
            with kernel_backend(backend):
                t0 = time.perf_counter()
                core.merge_files(ins, out, opts, recompress=recompress,
                                 device="cuda")
                secs[backend] = time.perf_counter() - t0
            c = ops.launch_counts()
            ran = c["offsets_scan"] > 0 and c["byteshuffle_pages"] > 0
            if ran != (route == "re-encode" and backend == "auto"):
                fail(f"merge {route} on {backend}: K1 {c['offsets_scan']}, "
                     f"K2 {c['byteshuffle_pages']}")
            if backend == "auto":
                counts[route] = c
            with open(out, "rb") as f:
                outs[backend] = f.read()
            os.remove(out)
        if outs["auto"] != outs["numpy"]:
            fail(f"merge {route}: the card's output differs from numpy's")
        log(f"merge {route} of 2 one-producer files ({len(outs['auto']) / 1e6:.3f}"
            f" MB): kernels {secs['auto']:.4f} s, numpy {secs['numpy']:.4f} s;"
            f" byte-identical; K1 {counts[route]['offsets_scan']}, K2 "
            f"{counts[route]['byteshuffle_pages']}")
    os.remove(ins[1])
    return counts["re-encode"], ins[0]


def remote_path(np, torch, core, ops, args, opts, data, file_path) -> dict:
    """Phase 8 (d): one producer writes the paper data to ``mem-s3://``
    with the kernels; the object's bytes equal the same write to a file,
    and it reads back equal on the card.  -> {path: launch counts}."""
    from repro_torch.configs.rntj_writer import SYNTH_EVENT_SCHEMA as schema

    url = "mem-s3://chip-smoke/paper.rntj"
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with core.SequentialWriter(schema, url, opts, device="cuda") as w:
        for b in batches(core, schema, data[0]):
            w.fill_batch(b)
    dt = time.perf_counter() - t0
    w_counts = ops.launch_counts()
    obj = core.mem_bucket("chip-smoke").objects["paper.rntj"]
    with open(file_path, "rb") as f:
        if bytes(obj) != f.read():
            fail("the mem-s3 object differs from the same write to a file")
    ops.reset_launch_counts()
    r_s, _st, _n, _read = check_read_back(np, torch, core, url, data[:1],
                                          args.entries)
    r_counts = ops.launch_counts()
    for name, c in (("write", w_counts), ("read-back", r_counts)):
        got = ([c["offsets_scan"], c["byteshuffle_pages"]] if name == "write"
               else [c["unsplit_pages"], c["decode_offset_pages"]])
        if min(got) <= 0:
            fail(f"the remote {name} launched no kernel of its pair: {c}")
    log(f"remote: one producer to {url}, {len(obj) / 1e6:.3f} MB in "
        f"{dt:.4f} s; the object equals the file write byte for byte; read "
        f"back equal ({r_s:.4f} s); K1 {w_counts['offsets_scan']}, K2 "
        f"{w_counts['byteshuffle_pages']}, K3 {r_counts['unsplit_pages']}, "
        f"K4 {r_counts['decode_offset_pages']}")
    core.mem_bucket("chip-smoke").objects.clear()
    return {"remote write": w_counts, "remote read-back": r_counts}


#: phase 8 (f): the write path's size floors at 0, so that every fill's
#: offsets go through K1 and every seal's pages through K2 (the chaos
#: scenarios fill one entry at a time into clusters of 2-16 KiB, far below
#: the default floors)
CHAOS_FLOORS = {"REPRO_TORCH_OFFSETS_MIN": "0", "REPRO_TORCH_SHUFFLE_MIN": "0"}
#: phase 8 (f): the scenarios whose writers run in child processes, and
#: those that read a salvaged or recovered file back on the card
CHAOS_CHILDREN = ("mpkill", "mprecover")
CHAOS_SALVAGED = ("kill", "mpkill", "mprecover", "remote", "skim")
#: phase 8 (f): the driver's own default workload
CHAOS_ENTRIES = 800


def chaos_path(ops, args) -> dict:
    """Phase 8 (f): the chaos driver (``repro_torch.launch.chaos``) on the
    card with both floors at 0: every scenario in this process, each held
    to its invariants by the driver; K1 and K2 > 0 in each scenario that
    writes (in its children for the multi-process ones), K3 and K4 > 0 in
    each that reads a salvaged or recovered file back on the card;
    ``kill``'s salvage list equal to the same scenario on the numpy
    backend; then the command line once as a subprocess, with its own
    participant processes (``mprecover``).  -> {path: launch counts}."""
    from repro_torch.launch import chaos

    entries = chaos.make_entries(CHAOS_ENTRIES, args.seed)
    counts, infos, secs = {}, {}, {}
    with env_vars(CHAOS_FLOORS):
        for name in sorted(chaos.SCENARIOS):
            ops.reset_launch_counts()
            chaos.reset_child_launches()
            t0 = time.perf_counter()
            try:
                infos[name] = chaos.run(name, entries, args.seed, "cuda")
            except AssertionError as e:
                fail(f"chaos {name}: {e}")
            secs[name] = time.perf_counter() - t0
            c = counts[f"chaos {name}"] = ops.launch_counts()
            w = c
            if name in CHAOS_CHILDREN:
                w = counts[f"chaos {name} (children)"] = dict(
                    chaos.CHILD_LAUNCHES)
            pairs = {"K1": w["offsets_scan"], "K2": w["byteshuffle_pages"]}
            if name in CHAOS_SALVAGED:
                pairs.update(K3=c["unsplit_pages"],
                             K4=c["decode_offset_pages"])
            ready = sorted(chaos.CHILD_READY_S)
            log(f"chaos {name}: {secs[name]:.3f} s; {infos[name]}; "
                + ", ".join(f"{k} {v}" for k, v in pairs.items())
                + ("" if w is c else
                   f" (K1 and K2 in the children; {len(ready)} children, "
                   f"start to ready {ready[0]:.3f} / "
                   f"{statistics.median(ready):.3f} / {ready[-1]:.3f} s "
                   "min / median / max)"))
            if min(pairs.values()) <= 0:
                fail(f"chaos {name} launched no kernel of {pairs}")
        with kernel_backend("numpy"):
            t0 = time.perf_counter()
            on_numpy = chaos.run("kill", entries, args.seed, "cuda")
            np_s = time.perf_counter() - t0
        if on_numpy["salvage"] != infos["kill"]["salvage"]:
            fail(f"chaos kill: the card's salvage {infos['kill']['salvage']}"
                 f" differs from numpy's {on_numpy['salvage']}")
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.chaos", "--scenario",
             "mprecover", "--entries", "200"],
            capture_output=True, text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=os.path.join(HERE, "src")))
        cli_s = time.perf_counter() - t0
    chaos.stop_forkserver()
    if cli.returncode != 0 or "ok   mprecover" not in cli.stdout:
        fail(f"python -m repro_torch.launch.chaos exited {cli.returncode}: "
             f"{cli.stdout[-2000:]} {cli.stderr[-2000:]}")
    log(f"chaos kill on the numpy backend: the same salvage list "
        f"({np_s:.3f} s); the command line (mprecover, 200 entries): "
        f"{cli.stdout.splitlines()[0]} ({cli_s:.3f} s, its start included)")
    log(f"phase 8 (f): {len(infos)} scenarios held their invariants on the "
        f"card in {sum(secs.values()):.3f} s (" + ", ".join(
            f"{k} {v:.3f}" for k, v in secs.items()) + ")")
    return counts


def same_bits(torch, a, b) -> bool:
    """``b`` (a tensor) holds ``a``'s bytes, dtype and shape."""
    if not torch.is_tensor(a):
        a = torch.from_numpy(a)
    if (a.dtype, a.shape) != (b.dtype, b.shape):
        return False
    a, b = a.detach().reshape(-1), b.detach().reshape(-1)
    if a.device != b.device:
        a = a.to(b.device)
    return a.numel() == 0 or torch.equal(a.view(torch.uint8),
                                         b.view(torch.uint8))


def plain(tree):
    """A state tree with each DTensor leaf (a meshed loop's) as its local
    tensor (the whole tensor on a one-rank mesh)."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: plain(v) for k, v in tree.items()}
    return tree.to_local() if isinstance(tree, DTensor) else tree


def on_card(t) -> bool:
    return t.is_cuda


def loop_state(loop) -> dict:
    """The loop's parameters, moments and optimizer step as plain tensors."""
    return plain({"p": loop.params, "m": loop.opt_state.m,
                  "v": loop.opt_state.v, "step": loop.opt_state.step})


def differing(torch, a: dict, b: dict) -> list:
    """The names of the leaves of two state trees that differ in bits."""
    from repro_torch.ckpt.checkpoint import _flatten_with_names

    want, _r = _flatten_with_names(a)
    got, _r = _flatten_with_names(b)
    if [n for n, _ in want] != [n for n, _ in got]:
        return ["(other leaves)"]
    return [n for (n, x), (_m, y) in zip(want, got) if not same_bits(torch, x, y)]


def checkpoint_path(np, torch, ops, loop, corpus: str, tmp) -> tuple:
    """Phase 8 (e), on phase 9 (a)'s loop after its steps: the loop's train
    state tree (``params``, ``opt {step, m, v}``, ``err``, ``loader
    {entry_cursor, leftover}``) saved by ``CheckpointManager`` with 2
    spawned processes (the loop's own 4-thread async save is phase 9 (a)'s),
    restored by a fresh loop and loader on the same mesh and held against
    the live state bit for bit (dtype, shape, device), the resumed loader
    standing where the live one stands; then one step of each loop, equal
    bit for bit (K5 and its backward are deterministic).  -> (the launch
    counts of those two steps, the phase's seconds)."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.ckpt.checkpoint import _flatten_with_names
    from repro_torch.pipeline import PackedLoader
    from repro_torch.train import LoopConfig, TrainLoop

    t_phase = time.perf_counter()
    ld = loop.loader.state()
    tree = plain({
        "params": loop.params,
        "opt": {"step": loop.opt_state.step, "m": loop.opt_state.m,
                "v": loop.opt_state.v},
        "err": loop.err_state,
        "loader": {"entry_cursor": np.asarray(ld["entry_cursor"]),
                   "leftover": np.asarray(ld["leftover"], np.int32)},
    })
    leaves, _rebuild = _flatten_with_names(tree)
    n_bytes = sum(np.asarray(x).nbytes if not torch.is_tensor(x)
                  else x.numel() * x.element_size() for _n, x in leaves)
    route = "2 processes"
    d = os.path.join(tmp, "ckpt_2_processes")
    mgr = CheckpointManager(d, keep=1, processes=2)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = mgr.save(loop.step, tree, {"train_step": loop.step})
    save_s = time.perf_counter() - t0
    save_counts = {k: v for k, v in ops.launch_counts().items() if v}
    if stats.get("degraded") or any(stats.get("worker_exitcodes", [])):
        fail(f"checkpoint save ({route}) degraded: {stats}")
    size = os.path.getsize(mgr.path_for(loop.step))
    loader = PackedLoader(corpus, TRAIN_BATCH, TRAIN_SEQ, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resumed = TrainLoop(loop.bundle, loader, d,
                        config=LoopConfig(steps=1, ckpt_every=10 ** 9),
                        optimizer=loop.optimizer, device="cuda",
                        mesh=loop.mesh)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if resumed.step != loop.step:
        fail(f"the loop restored from the checkpoint ({route}) stands at "
             f"step {resumed.step}, not {loop.step}")
    diff = differing(torch, loop_state(loop), loop_state(resumed))
    if diff or not all(on_card(t) for _n, t in _flatten_with_names(
            loop_state(resumed))[0]):
        fail(f"checkpoint ({route}): the restored state differs in "
             f"{len(diff)} tensors, first {diff[:3]}, or lies off the card")
    r_ld = resumed.loader.state()
    if (r_ld["entry_cursor"] != ld["entry_cursor"]
            or not np.array_equal(np.asarray(r_ld["leftover"]),
                                  np.asarray(ld["leftover"]))):
        fail(f"the loader resumed from the checkpoint ({route}) stands "
             "elsewhere than the live one")
    zlib = ""
    if "compress_ms" in stats:
        zlib = (f"; zlib {stats['compress_ms'] / 1e3:.3f} s summed over "
                "the writers")
    log(f"checkpoint ({route}), {CARD}: {len(leaves)} leaves, "
        f"{n_bytes / 1e9:.4f} GB; save {save_s:.3f} s = "
        f"{n_bytes / 1e6 / save_s:.3f} MB/s, file {size / 1e9:.4f} GB"
        f"{zlib}; restore by a fresh loop onto the card {restore_s:.3f} s = "
        f"{n_bytes / 1e6 / restore_s:.3f} MB/s; every leaf equal bit for "
        f"bit (dtype, shape, device), the loader where the live one stands; "
        f"launches in the save {json.dumps(save_counts)}")
    shutil.rmtree(d)

    ops.reset_launch_counts()
    live = loop.run(1)[-1].loss
    again = resumed.run(1)[-1].loss
    counts = ops.launch_counts()
    diff = differing(torch, loop_state(loop), loop_state(resumed))
    if again != live or diff:
        fail(f"the step resumed from the checkpoint ({route}) differs from "
             f"the live step: loss {again!r} against {live!r}, "
             f"{len(diff)} tensors, first {diff[:3]}")
    log(f"resumed step ({route}): loss {again!r} and every parameter "
        "and moment equal the live step's bit for bit")
    resumed.loader.close()
    del resumed
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    log(f"phase 8 (e): {wall:.3f} s; launches of the two resumed steps "
        f"{json.dumps({k: v for k, v in counts.items() if v})}")
    return counts, wall


# ---------------------------------------------------------------------------
# phase 9: the main path as one program, the quickstart, the AGC skim

#: phase 9 (a): ``launch.train`` trains ``TRAIN_ARCH`` on phase 7's corpus
#: and (TRAIN_BATCH, TRAIN_SEQ) batches for ``LOOP_STEPS`` steps with a
#: checkpoint every ``LOOP_CKPT_EVERY`` (the loop's default async save);
#: a fresh loop then restores it and runs the rest
LOOP_STEPS, LOOP_CKPT_EVERY = 15, 10
#: phase 9 (c): the reference's AGC layout (``make_agc_dataset``'s 9
#: partitions x 4 files) at 250,000 events a file, skimmed by 8 threads
SKIM_PARTS, SKIM_FILES, SKIM_EVENTS, SKIM_THREADS = 9, 4, 250_000, 8
#: phase 9 (c): the runs, (strategy, pushdown); the first is the base the
#: others are held equal to
SKIM_RUNS = (("imt", True), ("separate", True), ("buffermerger", True),
             ("parallel", True), ("separate-null", True), ("imt", False),
             ("parallel", False))
SKIM_COLLECTIONS = ("electrons_pt", "muons_pt", "jets_pt")


def loop_path(np, torch, ops, args, corpus: str, tmp) -> tuple:
    """Phase 9 (a), with phase 7's smollm-360m steps and phase 8 (e):
    ``repro_torch.launch.train.main`` trains smollm-360m at full width and
    depth (fp32 parameters, bf16 compute, remat) from ``--seed`` on phase
    7's corpus, (8, 1024) batches, ``LOOP_STEPS`` steps on its one-rank
    mesh with the loop's async checkpoint (4 writer threads) every
    ``LOOP_CKPT_EVERY``; its launches must be K5 twice and its backward
    once a layer and step, K3/K4 > 0 and nothing else (the save launches
    none: its data column is ``uint8`` and its offsets stay under K1's
    floor); every loss finite, the last below the first; the train step's
    ms (the mean of the steps without a save in flight), tokens/s and peak
    memory.  Then a fresh loader and loop on the same directory with the
    same optimizer restore the step-``LOOP_CKPT_EVERY`` checkpoint, and
    their steps must equal the first loop's last steps bit for bit:
    losses, parameters, moments and the optimizer's step; their launches
    K5 and its backward as many as those steps need, K3/K4 > 0 where the
    restored leftover holds fewer tokens than those steps take and 0 where
    it holds them all.  Then phase 8 (e) on the first loop
    (``checkpoint_path``), and one more step of it under the profiler.
    -> ({path: launch counts}, phase 8 (e)'s seconds, the losses)."""
    from repro_torch.launch import train as launch_train
    from repro_torch.pipeline import PackedLoader
    from repro_torch.train import LoopConfig, TrainLoop
    from repro_torch.train.optimizer import tree_leaves

    ckpt = os.path.join(tmp, "loop_ckpt")
    argv = ["--arch", TRAIN_ARCH, "--steps", str(LOOP_STEPS), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--data", corpus,
            "--ckpt-dir", ckpt, "--ckpt-every", str(LOOP_CKPT_EVERY),
            "--seed", str(args.seed)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    loop = launch_train.main(argv)
    run_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    cfg = loop.bundle.cfg
    check_launches(ops, counts, train_want(ops, cfg, LOOP_STEPS),
                   f"the loop ({LOOP_STEPS} steps of launch.train)")
    losses = [h.loss for h in loop.history]
    if (len(losses) != LOOP_STEPS or not all(np.isfinite(losses))
            or not losses[-1] < losses[0]):
        fail(f"loop losses {losses}: not {LOOP_STEPS} finite ones, or the "
             "last not below the first")
    if ([s.step for s in loop.saves] != [LOOP_CKPT_EVERY]
            or loop.mgr.steps() != [LOOP_CKPT_EVERY]):
        fail(f"the loop saved {loop.saves}, committed {loop.mgr.steps()}")
    walls = [h.wall_s * 1e3 for h in loop.history]
    before, during = walls[:LOOP_CKPT_EVERY], walls[LOOP_CKPT_EVERY:]
    handoff_s = loop.saves[0].block_s
    state = loop_state(loop)
    state_bytes = sum(x.numel() * x.element_size() for k, t in state.items()
                      if k != "step" for x in tree_leaves(t))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    peak = torch.cuda.max_memory_allocated()
    mean_ms = statistics.mean(before)  # the train metric
    log(f"train {cfg.name} (launch.train, mesh {loop.mesh.mesh_dim_names} "
        f"{tuple(loop.mesh.shape)}), {CARD}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} of "
        f"{cfg.resolved_head_dim}, vocab {cfg.vocab_size}, "
        f"{cfg.param_count():,} parameters, {cfg.param_dtype} parameters, "
        f"{cfg.compute_dtype} compute, remat {cfg.remat}; train step ms "
        f"(steps 1-{LOOP_CKPT_EVERY}, no save in flight: total / "
        f"{LOOP_CKPT_EVERY}) {mean_ms:.3f} = {tokens / mean_ms * 1e3:.1f} "
        f"tokens/s; max_memory_allocated {peak / 2**30:.3f} GiB")
    log(f"loop {cfg.name}: {LOOP_STEPS} steps of ({TRAIN_BATCH}, "
        f"{TRAIN_SEQ}) in {run_s:.3f} s (model init and the save's wait "
        f"included); losses {json.dumps(losses)}")
    log(f"loop step ms without a save in flight (steps 1-{LOOP_CKPT_EVERY}): "
        f"{json.dumps(before)}, mean {statistics.mean(before):.3f} "
        f"({statistics.mean(before[1:]):.3f} without the first) = "
        f"{tokens / statistics.mean(before) * 1e3:.1f} tokens/s; with the "
        f"step-{LOOP_CKPT_EVERY} save in flight (steps "
        f"{LOOP_CKPT_EVERY + 1}-{LOOP_STEPS}): {json.dumps(during)}, mean "
        f"{statistics.mean(during):.3f} = "
        f"{tokens / statistics.mean(during) * 1e3:.1f} tokens/s")
    log(f"loop save at step {LOOP_CKPT_EVERY}: hand-off (host snapshot of "
        f"{state_bytes / 1e9:.4f} GB of parameters and moments, pageable "
        f"D2H) {handoff_s * 1e3:.3f} ms = {state_bytes / 1e9 / handoff_s:.3f}"
        f" GB/s; wait() at the end of the run {loop.wait_s:.3f} s; "
        f"straggler events {sum(h.straggler for h in loop.history)}")
    by_path = {f"train {cfg.name} loop": counts}

    # the restart: a fresh loader and loop on the same directory and mesh
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loader = PackedLoader(corpus, TRAIN_BATCH, TRAIN_SEQ, device="cuda")
    again = TrainLoop(loop.bundle, loader, ckpt,
                      config=LoopConfig(steps=LOOP_STEPS - LOOP_CKPT_EVERY,
                                        ckpt_every=LOOP_CKPT_EVERY),
                      optimizer=loop.optimizer, device="cuda",
                      seed=args.seed, mesh=loop.mesh)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if again.step != LOOP_CKPT_EVERY:
        fail(f"the restarted loop stands at step {again.step}")
    # its batches come from the restored leftover first: it reads a
    # cluster only if the leftover holds fewer tokens than its steps take
    left = len(again.loader.leftover)
    reads = left < ((LOOP_STEPS - LOOP_CKPT_EVERY) * TRAIN_BATCH
                    * (TRAIN_SEQ + 1))
    again.run()
    r_counts = ops.launch_counts()
    check_launches(ops, r_counts,
                   train_want(ops, cfg, LOOP_STEPS - LOOP_CKPT_EVERY),
                   f"the restarted loop (restored leftover {left} tokens)",
                   reads=reads)
    r_losses = [h.loss for h in again.history]
    if r_losses != losses[LOOP_CKPT_EVERY:]:
        fail(f"the restarted loop's losses {r_losses} differ from the first "
             f"loop's {losses[LOOP_CKPT_EVERY:]}")
    diff = differing(torch, loop_state(loop), loop_state(again))
    if diff:
        fail(f"the restarted loop's state differs from the first loop's in "
             f"{len(diff)} tensors, first {diff[:3]}")
    log(f"loop restart: restore of step {LOOP_CKPT_EVERY} (a fresh loader and "
        f"loop) {restore_s:.3f} s; its {LOOP_STEPS - LOOP_CKPT_EVERY} steps "
        f"equal the first loop's steps {LOOP_CKPT_EVERY + 1}-{LOOP_STEPS} bit "
        "for bit (losses, parameters, moments and the step)")
    by_path[f"train {cfg.name} loop restart"] = r_counts
    loader.close()
    del again, state
    gc.collect()
    torch.cuda.empty_cache()

    # phase 8 (e): the checkpoint of this train state by 2 processes
    ck_counts, ck_s = checkpoint_path(np, torch, ops, loop, corpus, tmp)
    by_path[f"train {cfg.name} checkpoint resume"] = ck_counts
    # one more step under the profiler: card busy share, time by kernel
    busy_ms, _ = trace_card(torch, "train_step", lambda: loop.run(1),
                            args.profile or tmp, top=30)
    log(f"train step: card busy {busy_ms:.3f} ms (profiled step of the loop) "
        f"against the unprofiled mean step {mean_ms:.3f} ms = "
        f"{100 * busy_ms / mean_ms:.3f} % busy, "
        f"{100 - 100 * busy_ms / mean_ms:.3f} % idle")
    loop.loader.close()
    del loop
    gc.collect()
    torch.cuda.empty_cache()
    return by_path, ck_s, losses


# ---------------------------------------------------------------------------
# phase 10: the meshed step, the four families' training, the dry-run

#: phase 10 (a): steps of smollm-360m through ``launch.train`` on the
#: one-rank mesh and through the loop without a mesh
MESH_STEPS = 5
#: phase 10 (b): the families that train since ``distributed`` and since
#: the backwards of MLA's K5, K7 and K8, each at its full width and the
#: deepest depth whose dry-run peak (state, gradients and activations of a
#: step at (8, 1024)) stays under ``FAMILY_BUDGET``, for ``FAMILY_STEPS``
#: AdamW steps on phase 7's loader
FAMILY_ARCHS = ("deepseek-moe-16b", "mixtral-8x22b", "chameleon-34b",
                "musicgen-large", "minicpm3-4b", "rwkv6-7b", "zamba2-2.7b")
FAMILY_STEPS = 3
#: the families' learning-rate warm-up, ``launch.train``'s: at a warm-up
#: of 1 step Adam's first, sign-like steps at the peak rate overshoot at
#: chameleon-34b's width of 8,192 (its third loss rose above its second
#: on each of 7 batch sets, above its first on 2; the batches follow the
#: corpus's order, which 4 writers leave open); at 20 every family's
#: losses fell step by step (chameleon-34b's on 5 batch sets)
FAMILY_WARMUP = 20
FAMILY_BUDGET = 72 * 2 ** 30
#: phase 10 (b): the dry-run's state bytes against ``memory_allocated``
#: after ``init_train_state``, as a share of the prediction
STATE_BYTES_TOL = 0.02
#: phase 10 (b): the step's MoE balance loss against a fresh forward's on
#: the same parameters and batch, relative
AUX_TOL = 1e-5


def mesh_path(np, torch, ops, args, corpus: str, tmp, loop_losses) -> dict:
    """Phase 10 (a): smollm-360m at full size, ``MESH_STEPS`` steps from
    ``--seed`` on phase 7's corpus, once through the loop without a mesh
    and once through ``launch.train`` on ``make_local_mesh(device="cuda")``
    (a one-rank NCCL group, mesh (data=1, model=1)), with the launcher's
    optimizer: losses, parameters, moments and the optimizer's step equal
    bit for bit (every collective of one rank is an identity), the same
    K5 and K5-backward launches, and the losses phase 9 (a)'s first ones
    (the same state, batches and learning rates).  -> {path: counts}."""
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.launch import train as launch_train
    from repro_torch.models import build
    from repro_torch.pipeline import PackedLoader
    from repro_torch.train import LoopConfig, TrainLoop, make_optimizer

    cfg = get_arch(TRAIN_ARCH)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    loader = PackedLoader(corpus, TRAIN_BATCH, TRAIN_SEQ, device="cuda")
    # launch.train's optimizer at --steps MESH_STEPS
    straight = TrainLoop(
        build(cfg), loader, os.path.join(tmp, "mesh_straight"),
        config=LoopConfig(steps=MESH_STEPS, ckpt_every=10 ** 9),
        optimizer=make_optimizer(peak_lr=3e-4, warmup=20, total=MESH_STEPS),
        device="cuda", seed=args.seed)
    straight.run()
    s_counts = ops.launch_counts()
    t1 = time.perf_counter()
    ops.reset_launch_counts()
    meshed = launch_train.main([
        "--arch", TRAIN_ARCH, "--steps", str(MESH_STEPS), "--batch",
        str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--data", corpus,
        "--ckpt-dir", os.path.join(tmp, "mesh_ckpt"), "--ckpt-every",
        str(10 ** 9), "--seed", str(args.seed)])
    m_counts = ops.launch_counts()
    t2 = time.perf_counter()
    mesh = dict(zip(meshed.mesh.mesh_dim_names, meshed.mesh.shape))
    if mesh != {"data": 1, "model": 1} or dist.get_backend() != "nccl":
        fail(f"launch.train ran on {mesh} over {dist.get_backend()}, not a "
             "one-rank NCCL mesh")
    want = train_want(ops, cfg, MESH_STEPS)
    check_launches(ops, s_counts, want, "phase 10 (a)'s loop without a mesh")
    check_launches(ops, m_counts, want, "phase 10 (a)'s meshed launch.train")
    s_losses = [h.loss for h in straight.history]
    m_losses = [h.loss for h in meshed.history]
    diff = differing(torch, loop_state(straight), loop_state(meshed))
    if m_losses != s_losses or diff:
        fail(f"the meshed step differs from the one-card step: losses "
             f"{m_losses} against {s_losses}, {len(diff)} tensors, first "
             f"{diff[:3]}")
    if s_losses != loop_losses[:MESH_STEPS]:
        fail(f"phase 10 (a)'s losses {s_losses} are not phase 9 (a)'s first "
             f"{loop_losses[:MESH_STEPS]}")
    ms = lambda loop: statistics.mean(h.wall_s * 1e3 for h in loop.history)
    log(f"phase 10 (a), {CARD}: launch.train on the one-rank NCCL mesh "
        f"{mesh} equals the loop without a mesh bit for bit over "
        f"{MESH_STEPS} steps of {cfg.name} (losses {json.dumps(m_losses)}, "
        "parameters, moments, the step), the same launches "
        f"(K5 {m_counts['flash_attention']}, its backward "
        f"{m_counts['flash_attention_bwd']}), the losses phase 9 (a)'s "
        f"first {MESH_STEPS}; step ms without the mesh {ms(straight):.3f}, "
        f"on the mesh {ms(meshed):.3f}; {t1 - t0:.3f} s and {t2 - t1:.3f} s "
        "with the model's init")
    for lp in (straight, meshed):
        lp.loader.close()
    del straight, meshed
    gc.collect()
    torch.cuda.empty_cache()
    return {f"train {cfg.name} loop without a mesh": s_counts,
            f"train {cfg.name} meshed launch.train": m_counts}


def family_depth(cfg, dryrun, mesh) -> tuple:
    """The deepest depth whose dry-run peak of a step at
    (``TRAIN_BATCH``, ``TRAIN_SEQ``) lies under ``FAMILY_BUDGET`` (the peak
    grows linearly with the layers: two probes and a check), in whole
    groups of zamba2-2.7b's ``shared_attn_every`` layers -> (depth, the
    dry-run's bytes at it)."""
    unit = cfg.shared_attn_every or 1
    probe = {n: dryrun.train_memory(cfg.with_(n_layers=n * unit), mesh,
                                    TRAIN_BATCH, TRAIN_SEQ)["peak_bytes"]
             for n in (1, 2)}
    per = probe[2] - probe[1]
    groups = max(1, min(cfg.n_layers // unit,
                        int((FAMILY_BUDGET - probe[1]) // per) + 1))
    while True:
        mem = dryrun.train_memory(cfg.with_(n_layers=groups * unit), mesh,
                                  TRAIN_BATCH, TRAIN_SEQ)
        if mem["peak_bytes"] < FAMILY_BUDGET or groups == 1:
            return groups * unit, mem
        groups -= 1


def family_batch(torch, cfg, batch) -> dict:
    """A loader batch (ids below 49,152) as the model's: ids modulo its
    vocabulary, and for a model of Q codebooks Q shifted copies, (B, S, Q)."""
    out = {}
    for k, t in batch.items():
        t = torch.as_tensor(t).cuda().long()
        if cfg.n_codebooks > 1:
            t = torch.stack([t + q * 997 for q in range(cfg.n_codebooks)], -1)
        out[k] = (t % cfg.vocab_size).to(torch.int32)
    return out


def families_path(np, torch, ops, args, corpus: str) -> dict:
    """Phase 10 (b): each of ``FAMILY_ARCHS`` at its full width and
    ``family_depth`` (fp32 parameters, bf16 compute, remat) from
    ``--seed``: the dry-run's state bytes within ``STATE_BYTES_TOL`` of
    ``memory_allocated`` after ``init_train_state``; ``FAMILY_STEPS``
    AdamW steps on phase 7's loader (``family_batch``): launches as
    ``train_want`` (K5, K7 or K8 twice and its backward once a layer and
    step, zamba2-2.7b's shared blocks K5 once), nothing else; losses
    finite and falling; the balance loss finite (0 without MoE) and the
    first step's equal to a fresh forward's on the same parameters and
    batch; peak memory beside the dry-run's prediction.  -> {path:
    counts}."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import build
    from repro_torch.pipeline import PackedLoader
    from repro_torch.train import (
        init_train_state, make_optimizer, make_train_step,
    )

    one = MeshShape(("data", "model"), (1, 1))
    by_path = {}
    for arch in FAMILY_ARCHS:
        t0 = time.perf_counter()
        full = get_arch(arch)
        depth, pred = family_depth(full, dryrun, one)
        cfg = full.with_(n_layers=depth)
        bundle = build(cfg)
        t1 = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        opt = make_optimizer(peak_lr=3e-4, warmup=FAMILY_WARMUP, total=20)
        state = list(init_train_state(bundle, seed=args.seed, device="cuda",
                                      optimizer=opt))
        torch.cuda.synchronize()
        got = torch.cuda.memory_allocated() - base
        if abs(got - pred["state"]) > STATE_BYTES_TOL * pred["state"]:
            fail(f"{arch}: the dry-run's state {pred['state']} bytes against "
                 f"{got} allocated after init_train_state")
        loader = PackedLoader(corpus, TRAIN_BATCH, TRAIN_SEQ, device="cuda")
        it = loader.batches()
        batches = [family_batch(torch, cfg, next(it))
                   for _ in range(FAMILY_STEPS)]
        loader.close()
        with torch.no_grad():
            _logits, fresh_aux = bundle.forward(state[0], batches[0]["tokens"])
        fresh_aux = float(fresh_aux)
        del _logits
        step = make_train_step(bundle, optimizer=opt)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        losses, auxes, step_ms = [], [], []
        for b in batches:
            t = time.perf_counter()
            *state[:3], m = step(*state, b)
            losses.append(float(m["loss"]))  # syncs
            auxes.append(float(m["aux"]))
            step_ms.append((time.perf_counter() - t) * 1e3)
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() - base
        check_launches(ops, counts, train_want(ops, cfg, FAMILY_STEPS),
                       f"the {arch} train path ({depth} layers)", reads=False)
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            fail(f"{arch} train losses {losses}: not finite, or the last not "
                 "below the first")
        if cfg.moe is None:
            ok_aux = auxes == [0.0] * FAMILY_STEPS and fresh_aux == 0.0
        else:
            ok_aux = (all(np.isfinite(auxes)) and auxes[0] > 0 and
                      abs(auxes[0] - fresh_aux) <= AUX_TOL * abs(fresh_aux))
        if not ok_aux:
            fail(f"{arch}: balance losses {auxes}, a fresh forward's "
                 f"{fresh_aux!r}")
        G = 2 ** 30
        log(f"train {arch}, {CARD}: {depth} of {full.n_layers} layers at full "
            f"width (d_model {cfg.d_model}, {cfg.n_heads} heads over "
            f"{cfg.n_kv_heads} of {cfg.resolved_head_dim}, vocab "
            f"{cfg.vocab_size}"
            + (f", {cfg.moe.n_experts} experts top-{cfg.moe.top_k}"
               if cfg.moe else "")
            + (f", {cfg.n_codebooks} codebooks" if cfg.n_codebooks > 1
               else "")
            + f"), {cfg.param_count():,} parameters; {FAMILY_STEPS} "
            f"AdamW steps at ({TRAIN_BATCH}, {TRAIN_SEQ}): losses "
            f"{json.dumps(losses)}, balance losses {json.dumps(auxes)} (a "
            f"fresh forward's {fresh_aux!r}), step ms {json.dumps(step_ms)}; "
            "launches " + json.dumps({k: c for k, c in counts.items()
                                      if c and k in ops.TRAIN_KERNELS}))
        log(f"  memory {arch}: state after init_train_state {got / G:.3f} GiB "
            f"allocated, dry-run {pred['state'] / G:.3f} GiB "
            f"({100 * (got - pred['state']) / pred['state']:+.3f} %); peak "
            f"max_memory_allocated {peak / G:.3f} GiB, dry-run "
            f"{pred['peak_bytes'] / G:.3f} GiB (activations "
            f"{pred['activation_bytes'] / G:.3f}, a scan backward's "
            f"workspace {pred['_meta']['bwd_workspace_bytes'] / G:.3f} of "
            f"them); depth chosen in "
            f"{t1 - t0:.3f} s, run {time.perf_counter() - t1:.3f} s")
        by_path[f"train {arch} ({depth} layers)"] = counts
        del state, step, batches, m
        gc.collect()
        torch.cuda.empty_cache()
    return by_path


def dryrun_start(tmp) -> tuple:
    """Phase 10 (c) in the background: the dry-run of every arch x cell on
    both production meshes, two child processes on the host (one a mesh,
    kept off the card) while (a) and (b) run."""
    out = os.path.join(tmp, "dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"),
               CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all", "--out",
         out, *mesh], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for mesh in ([], ["--multi-pod"])]
    return procs, out, time.perf_counter()


def dryrun_finish(procs, out: str, t0: float) -> None:
    """Phase 10 (c): every record ``ok`` or ``skipped``, none ``error``;
    the counts, the seconds, and each arch's per-rank train state on the
    single-pod mesh."""
    texts = []
    try:
        for proc in procs:
            texts.append(proc.communicate(timeout=900)[0])
    except subprocess.TimeoutExpired:
        for proc in procs:
            proc.kill()
            proc.communicate()
        fail("the dry-run outlived 900 s")
    wall = time.perf_counter() - t0
    text = "".join(texts)
    rc = max(proc.returncode for proc in procs)
    recs = [json.load(open(os.path.join(out, f)))
            for f in sorted(os.listdir(out)) if f.endswith(".json")]
    status = {}
    for r in recs:
        status[r["status"]] = status.get(r["status"], 0) + 1
    if rc != 0 or status.get("error") or len(recs) != 80:
        fail(f"the dry-run (rc {rc}) gave {status} over {len(recs)} "
             f"records: {text[-2000:]}")
    meta_s = sum(r.get("meta_s", 0.0) for r in recs)
    log(f"phase 10 (c): dry-run of 10 archs x 4 cells x 2 meshes on the "
        f"host: {json.dumps(status)}; {wall:.3f} s from its start (in the "
        f"background of (a) and (b)), {meta_s:.3f} s in meta runs")
    G = 2 ** 30
    for r in recs:
        if (r["status"] == "ok" and r["shape"] == "train_4k"
                and not r["multi_pod"]):
            m = r["memory"]
            log(f"  dry-run {r['arch']} train_4k {r['mesh']}: state "
                f"{m['state'] / G:.3f} GiB a rank, activations "
                f"{m['activation_bytes'] / G:.3f}, gathered parameters "
                f"{m['gathered_params'] / G:.3f}, peak "
                f"{m['peak_bytes'] / G:.3f}; flops a rank "
                f"{r['flops']:.4g}, collective bytes "
                f"{r['collective_bytes']:.4g}, dominant "
                f"{r['roofline']['dominant']}")


def quickstart_path(np, torch, core, ops, tmp) -> dict:
    """Phase 9 (b): ``repro_torch.launch.quickstart`` on the card at its own
    sizes (gemma-2b's smoke config, head dim 32: ingest, 30 steps with
    checkpoints every 10, a restart, serving); its launches must be K5 once
    a layer and step (no remat) and once a layer in prefill, K5's backward
    once a layer and step, all at head dim 32, K6 once a layer and decode
    step, K3/K4 > 0 and nothing else; the restart resumes at step 30 and
    the generations file reads back equal to the tokens.  -> {path: launch
    counts}."""
    from repro_torch.launch import quickstart

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = quickstart.main(["--workdir", os.path.join(tmp, "quickstart")])
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    shapes = ops.launch_shapes()
    served = res["serve"]
    cfg = served.cfg
    steps = len(res["history"]) + len(res["resumed"])
    check_launches(ops, counts, train_want(
        ops, cfg, steps, prefills=1, decode_steps=served.tokens.shape[1] - 1),
        "the quickstart")
    if res["restored_at"] != 30 or res["resumed"][-1].step != 40:
        fail(f"the quickstart restarted at step {res['restored_at']} and "
             f"ended at {res['resumed'][-1].step}")
    dims = {s[5] for s in shapes["flash_attention_bwd"]}
    if dims != {32}:
        fail(f"the quickstart's K5 backward ran at head dims {dims}")
    losses = [h.loss for h in res["history"] + res["resumed"]]
    if not all(np.isfinite(losses)):
        fail(f"quickstart losses {losses}")
    with core.RNTJReader(served.out, device="cuda") as r:
        ids = np.asarray(r.read_column("request_id"))
        toks = np.asarray(r.read_column("tokens._0"))
    if not np.array_equal(toks.reshape(len(ids), -1),
                          served.tokens[ids]):
        fail("the quickstart's generations file differs from its tokens")
    log(f"quickstart ({cfg.name} smoke, head dim {cfg.resolved_head_dim}): "
        f"{wall:.3f} s; {res['ingest']['entries']} docs ingested; losses "
        f"{losses[0]:.4f} -> {losses[29]:.4f}, restarted at step "
        f"{res['restored_at']}, {losses[-1]:.4f} at step 40; K5's backward "
        f"at {dict(shapes['flash_attention_bwd'])}; the generations file "
        "equal to the served tokens")
    return {"quickstart": counts}


def skim_events(np, core, path: str) -> dict:
    """A skim output's events sorted by ``event_id``, as columns: the ids,
    and each collection's sizes and values in that order."""
    cols_by = {"event_id": []}
    for c in SKIM_COLLECTIONS:
        cols_by[c], cols_by[c + "._0"] = [], []
    with core.RNTJReader(path, device="cuda") as r:
        col = r.schema.column_of_path
        for _i, cols in r.iter_clusters(recycle=False):
            cols_by["event_id"].append(cols[col["event_id"]])
            for c in SKIM_COLLECTIONS:
                cols_by[c].append(np.diff(cols[col[c]].astype(np.int64),
                                          prepend=0))
                cols_by[c + "._0"].append(cols[col[c + "._0"]])
    flat = {k: np.concatenate(v) for k, v in cols_by.items()}
    order = np.argsort(flat["event_id"], kind="stable")
    out = {"event_id": flat["event_id"][order]}
    for c in SKIM_COLLECTIONS:
        sizes = flat[c]
        starts = np.cumsum(sizes) - sizes
        so = sizes[order]
        shift = np.repeat(starts[order] - (np.cumsum(so) - so), so)
        out[c] = so
        out[c + "._0"] = flat[c + "._0"][np.arange(int(so.sum())) + shift]
    return out


def file_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def skim_path(np, core, ops, args, tmp) -> dict:
    """Phase 9 (c): the paper's skim application on the card.
    ``make_agc_dataset`` builds the reference's layout (``SKIM_PARTS``
    partitions x ``SKIM_FILES`` files, ``SKIM_EVENTS`` events a file, from
    ``--seed``; the paper's 787 input files cut to 36) with its writers on
    the card; then ``skim_partitions`` runs every ``SKIM_RUNS`` entry with
    ``SKIM_THREADS`` threads.  ``kept_events`` must be equal across the
    runs, and each partition's events, sorted by ``event_id``, equal to the
    first run's column by column.  ``imt`` (one sequential writer a
    partition, fed its files in order) is the one strategy whose files do
    not depend on thread timing: its files with and without pushdown must
    equal byte for byte the same skim under the numpy backend, as must
    the first input file rebuilt there.

    The kernels, from the writer: each input file is ONE fill batch of
    ``SKIM_EVENTS`` >= 65,536 entries, so K1 integrates its three
    collections' sizes (exactly 3 a file), and its seal's page blocks of
    at least 256 KiB (the jets' values, 2 MB and more) go through K2
    (> 0).  A skim fills one batch per surviving input cluster, about
    4-5 % of 250,000 events, far under K1's floor: K1 0 in every run.
    ``imt`` fills one writer a partition, whose cluster gathers the
    partition's ~44,000 kept events and seals page blocks above K2's
    floor: K2 > 0 there, with and without pushdown.  The other strategies
    seal one cluster per input file (~11,000 events; the jets' block
    ~220 KB, under the floor) and ``separate`` merges verbatim: K2 is
    printed, not required.  The skim reads on the host (the reference's
    numpy kernel over ``iter_cluster_segments``): K3/K4 0.
    -> {path: launch counts}."""
    from repro_torch.skim import make_agc_dataset, skim_partitions

    root = os.path.join(tmp, "skim")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    parts = make_agc_dataset(os.path.join(root, "in"), SKIM_PARTS,
                             SKIM_FILES, SKIM_EVENTS, seed=args.seed,
                             device="cuda")
    build_s = time.perf_counter() - t0
    b_counts = ops.launch_counts()
    n_files = SKIM_PARTS * SKIM_FILES
    in_mb = sum(os.path.getsize(f) for fs in parts.values() for f in fs) / 1e6
    log(f"skim dataset: {SKIM_PARTS} partitions x {SKIM_FILES} files x "
        f"{SKIM_EVENTS} events = {n_files * SKIM_EVENTS} events, "
        f"{in_mb:.3f} MB of files, built in {build_s:.3f} s; K1 "
        f"{b_counts['offsets_scan']}, K2 {b_counts['byteshuffle_pages']}")
    if (b_counts["offsets_scan"] != 3 * n_files
            or b_counts["byteshuffle_pages"] < 1):
        fail(f"the skim dataset's build launched {b_counts}: K1 must be "
             f"3 x {n_files}, K2 > 0")
    with kernel_backend("numpy"):
        again = make_agc_dataset(os.path.join(root, "in_numpy"), 1, 1,
                                 SKIM_EVENTS, seed=args.seed, device="cuda")
    if file_bytes(again[0][0]) != file_bytes(parts[0][0]):
        fail("the first skim input differs from its numpy-backend build")

    by_path, base, kept = {"skim dataset build": b_counts}, None, set()
    for strategy, pushdown in SKIM_RUNS:
        name = f"{strategy}{'' if pushdown else ' (no pushdown)'}"
        out = os.path.join(root, name.replace(" ", "_"))
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = skim_partitions(parts, out, strategy, SKIM_THREADS,
                              pushdown=pushdown, device="cuda")
        dt = time.perf_counter() - t0
        counts = ops.launch_counts()
        kept.add(res["kept_events"])
        outs = ([] if strategy == "separate-null" else
                [os.path.join(out, f"skim_{p}.rntj") for p in parts])
        out_mb = sum(os.path.getsize(f) for f in outs) / 1e6
        log(f"skim {name}: {dt:.3f} s, {res['kept_events']} events kept, "
            f"input {in_mb:.3f} MB, output {out_mb:.3f} MB; K1 "
            f"{counts['offsets_scan']}, K2 {counts['byteshuffle_pages']}, "
            f"K3 {counts['unsplit_pages']}, K4 "
            f"{counts['decode_offset_pages']}")
        if counts["unsplit_pages"] or counts["decode_offset_pages"]:
            fail(f"the skim ({name}) decoded on the card: {counts}")
        if strategy == "imt" and counts["byteshuffle_pages"] < 1:
            fail(f"the skim ({name}) launched no K2: {counts}")
        by_path[f"skim {name}"] = counts
        if outs:
            events = [skim_events(np, core, f) for f in outs]
            if base is None:
                base = events
            for p, (a, b) in enumerate(zip(base, events, strict=True)):
                for k in a:
                    if not np.array_equal(a[k], b[k]):
                        fail(f"skim {name}: partition {p}'s {k} differs from "
                             f"the {SKIM_RUNS[0][0]} run's")
    if len(kept) != 1:
        fail(f"the skim runs kept different event counts: {kept}")
    with kernel_backend("numpy"):
        ops.reset_launch_counts()
        skim_partitions(parts, os.path.join(root, "imt_numpy"), "imt",
                        SKIM_THREADS, device="cuda")
        if any(ops.launch_counts().values()):
            fail("the numpy backend launched kernels")
    for p in parts:
        want = file_bytes(os.path.join(root, "imt_numpy", f"skim_{p}.rntj"))
        for name in ("imt", "imt_(no_pushdown)"):
            if file_bytes(os.path.join(root, name, f"skim_{p}.rntj")) != want:
                fail(f"skim {name}: partition {p}'s file differs from the "
                     "numpy backend's")
    log(f"skim: every run kept {kept.pop()} events; every partition's "
        "events equal across the strategies; imt's files (pushdown on and "
        "off) byte-identical to the numpy backend's")
    shutil.rmtree(root)
    return by_path


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--entries", type=int, default=1_000_000,
                    help="entries per producer")
    ap.add_argument("--producers", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=16,
                    help="prompts served in one batch")
    ap.add_argument("--prompt-len", type=int, default=1000)
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also trace one read-back, one single-producer "
                         "write, and the served batch's prefill and 8 "
                         "decode steps with torch.profiler; chrome traces "
                         "go to DIR")
    args = ap.parse_args()

    # gemma-2b's AdamW step holds its old and new fp32 state (60 GB) beside
    # the gradients: in the caching allocator's fixed segments 9-12 GiB
    # stayed reserved but unusable at that peak and no batch above 2 fit;
    # growable segments leave no such holes (read when the card is first
    # used)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
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
        from repro_torch.launch import serve
    except ImportError as e:
        print(f"FAIL: the repository's src/repro_torch is missing: {e}",
              file=sys.stderr)
        return 2
    # full-precision fp32 products in the fp32 checks (the defaults, stated)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 1: the card and the build ------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    global CARD
    CARD = smi
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device 0: {kind}")
    t0 = time.perf_counter()
    for lib in _build.SIGNATURES:  # the first one builds them all
        _build.library(lib)
    log(f"build and load: {time.perf_counter() - t0:.3f} s into "
        f"{_build.build_dir()}")
    for lib in ("attention", "attention_bwd", "byteplanes", "scans", "ssm"):
        for line in ptxas_report(_build.build_log(lib)):
            log(line)
    for line in ptxas_summary(_build.build_log("attention_bwd")):
        log(line)
    for line in ptxas_summary(_build.build_log("attention"),
                              FWD_SPLIT_KERNELS, "forward split route"):
        log(line)

    # -- phase 2: kernels against their plain versions ----------------------
    lap_t = [time.perf_counter()]

    def lap(what: str) -> None:  # the seconds since the last lap
        now = time.perf_counter()
        log(f"{what}: {now - lap_t[0]:.3f} s")
        lap_t[0] = now

    check_kernels(torch, kernels, ragged_shapes(), odd_views=True)
    check_offsets_calls(np, torch, kernels)
    check_codec(torch, kernels)
    flash_cases, decode_cases = attention_cases()
    worst = check_attention(torch, flash_cases, decode_cases)
    worst.update(check_scans(torch, *scan_cases()))

    lap("phase 2")
    # -- phase 3: the write -> read path ------------------------------------
    data = make_data(np, args.seed, args.producers, args.entries)
    raw_bytes = sum(len(ids) * 16 + len(vals) * 4
                    for ids, _s, vals, _e in data)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    path = os.path.join(tmp, "paper.rntj")
    ops.reset_launch_counts()
    w_s, wstats = write_parallel(core, SYNTH_EVENT_SCHEMA,
                                 PAPER_WRITE_OPTIONS, path, data)
    r_s, rstats, n_clusters, _read = check_read_back(np, torch, core, path,
                                                     data, args.entries)
    # the path's own launches: taken before any check launches more
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
    log(f"write -> read path: {args.producers} producers x {args.entries} "
        f"entries, {raw_bytes / 1e6:.3f} MB uncompressed, {file_mb:.3f} MB "
        f"file, {n_clusters} clusters; read back equal to the generated "
        "data and, on the first and last cluster, to the host decode")
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
    log("launches on the write -> read path: " + json.dumps(
        {k: counts[k] for k in ops.WRITE_READ_KERNELS}))
    for name in ops.WRITE_READ_KERNELS:
        log(f"  {name} shapes: "
            + ", ".join(f"{tuple(s)} x{c}" for s, c in shapes[name].most_common()))
    missing = [k for k in ops.WRITE_READ_KERNELS if counts[k] <= 0]
    if missing:
        fail(f"kernels not launched on the write -> read path: {missing}")

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
        profile_write_read(torch, core, SYNTH_EVENT_SCHEMA,
                           PAPER_WRITE_OPTIONS, path, data[0], args.profile)
    for f in (path, p_card, p_numpy):
        os.remove(f)

    lap("phase 3")
    # -- phase 4: the serve path, one model after another --------------------
    from repro_torch.models import build

    served = {}
    for arch in SERVE_ARCHS:
        res, s_counts, s_shapes = serve_path(np, torch, core, serve, ops,
                                             args, tmp, arch)
        check_consistency(torch, res,
                          build(res.cfg.with_(compute_dtype="float32")),
                          min(2, args.requests), 8)
        res.logits = None
        if args.profile:
            profile_serve(torch, res, args.profile)
        served[arch] = (res.cfg, s_counts, s_shapes)
        # free the model before the next one (deepseek-moe-16b: 62.9 GiB
        # in fp32)
        del res
        gc.collect()
        torch.cuda.empty_cache()
        lap(f"phase 4, {arch}")
    os.rmdir(tmp)

    # -- phase 5: the kernels package's entry points -------------------------
    o_counts, _o_shapes = ops_phase(torch, ops)

    lap("phase 5")
    # -- phase 6: time every kernel at its path's shapes ---------------------
    gen = torch.Generator(device="cuda")
    gen.manual_seed(99)
    fns = kernel_fns(kernels)
    # every distinct shape a path gave a kernel is checked too
    check_kernels(torch, kernels,
                  {k: list(shapes[k]) for k in ops.WRITE_READ_KERNELS})
    for _cfg, _counts, s_shapes in served.values():
        check_attention(torch, [x + (True, None)
                                for x in s_shapes["flash_attention"]],
                        [x + (None,) for x in s_shapes["decode_attention"]])
    _cfg, r_counts, r_shapes = served["rwkv6-7b"]
    _cfg, z_counts, z_shapes = served["zamba2-2.7b"]
    check_scans(torch, [x + ("reference",) for x in r_shapes["rwkv6_scan"]],
                list(z_shapes["mamba2_ssd"]))
    rows = []
    for name in ops.WRITE_READ_KERNELS:
        path_shapes = [x for x, _c in shapes[name].most_common()]
        before = ops.launch_counts()[name]
        row = time_wrapper(torch, fns, name, path_shapes[0], gen)
        assert ops.launch_counts()[name] > before  # the timing ran the kernel
        source, replaces = KERNEL_INFO[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": counts[name],
                     "library": fns[name][2], **row})
        if name in KERNEL_DESIGN:
            rows[-1]["design"] = next(iter(KERNEL_DESIGN[name].values()))
        if name == "offsets_scan":
            rows[-1]["at_sizes"] = time_offsets_sizes(
                torch, fns[name][0], fns[name][1], gen)
        if name in FLOOR_SHAPES:
            # the path's next shape, and the launch floor
            rows[-1]["at"] = [time_wrapper(torch, fns, name, x, gen)
                              for x in path_shapes[1:2]]
            rows[-1]["floor"] = time_wrapper(torch, fns, name,
                                             FLOOR_SHAPES[name], gen)
    # K5/K6 at smollm-360m's shapes (the rows), at gemma-2b's head dim 256
    # and at zamba2-2.7b's head dim 80 (nested); launches summed over the
    # serve paths; K5's narrow-v form at minicpm3-4b's q/k 96, v 64 (a row
    # of its own, its launches minicpm3-4b's)
    _cfg, d_counts, d_shapes = served["smollm-360m"]
    attn_rows = time_attention(torch, ops, d_shapes, d_counts, worst)
    _cfg, g_counts, g_shapes = served[GEMMA_ARCH]
    at_g = time_attention(torch, ops, g_shapes, g_counts, worst)
    at_z = time_attention(torch, ops, z_shapes, z_counts, worst)
    # K6 at chameleon-34b's and mixtral-8x22b's decode (head dim 128, 8 and
    # 6 query heads a kv group: the tensor-core route)
    at_k6 = {arch: time_attention(torch, ops, served[arch][2],
                                  served[arch][1], worst,
                                  names=("decode_attention",))[0]
             for arch in ("chameleon-34b", "mixtral-8x22b")}
    _cfg, m_counts, m_shapes = served["minicpm3-4b"]
    at_m = time_attention(torch, ops, m_shapes, m_counts, worst,
                          names=("flash_attention",))
    narrow = "flash_attention q/k 96, v 64"
    at_m[0].update(name=narrow, path="serve minicpm3-4b",
                   launches_by_path={"minicpm3-4b": at_m[0]["launches"]},
                   design=KERNEL_DESIGN[narrow]["bfloat16"],
                   design_by_dtype=KERNEL_DESIGN[narrow])
    # and at minicpm3-4b's training shape, with the LSE; the split route
    # (head dims 128 and 256) at gemma-2b's and chameleon-34b's
    at_m[0]["at_training"] = time_attention_training(
        torch, BWD_TIMED["minicpm3-4b"])
    attn_rows[0]["at_training"] = {
        arch: time_attention_training(torch, BWD_TIMED[arch]
                                      + BWD_TIMED[arch][5:6])
        for arch in (GEMMA_ARCH, "chameleon-34b")}
    nested = ("launches", "shape", "length", "design", "ms", "plain_ms",
              "bound_ms", "bound_by", "library_ms", "library_backend",
              "max_abs_err", "bytes", "call_ms")
    for row, rg, rz in zip(attn_rows, at_g, at_z):
        name = row["name"]
        row["path"] = "serve smollm-360m"
        row["launches_by_path"] = {a: c[name] for a, (_g, c, _s) in
                                   served.items() if c[name]}
        row["launches"] = sum(row["launches_by_path"].values())
        row[f"at_{GEMMA_ARCH}"] = {k: rg[k] for k in nested}
        row["at_zamba2-2.7b"] = {k: rz[k] for k in nested}
        if name == "decode_attention":
            for arch, rk in at_k6.items():
                row[f"at_{arch}"] = {k: rk[k] for k in nested}
    rows += attn_rows + at_m
    rows += time_scans(torch, ops, served, worst)
    rows += time_codec(torch, kernels, o_counts)
    # the host entries (K1, K2: the seal path's; K9): numpy in, numpy
    # out, PCIe both ways
    for name, entry, shape in (
            ("offsets_scan", kernels.offsets_scan.offsets_scan_host,
             shapes["offsets_scan"].most_common(1)[0][0]),
            ("byteshuffle_pages", kernels.byteshuffle.byteshuffle_pages_host,
             shapes["byteshuffle_pages"].most_common(1)[0][0]),
            ("byteshuffle", kernels.byteshuffle.byteshuffle_host,
             CODEC_TIMED["byteshuffle"][0][0])):
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
    for row in rows:
        row["launches_by_op_entries"] = o_counts.get(row["name"], 0)

    lap("phase 6")
    # -- phase 7: the train path ---------------------------------------------
    bwd_row, t_counts, t_worst, corpus = train_path(np, torch, ops, args)
    for row in rows:  # K5's forward runs on the train paths too
        if row["name"] == "flash_attention":
            for arch, c in t_counts.items():
                row["launches_by_path"][f"train {arch}"] = c["flash_attention"]
            row["launches"] = sum(row["launches_by_path"].values())
            row[f"at_{GEMMA_ARCH}_train"] = {
                "shape": bwd_row[f"at_{GEMMA_ARCH}"]["shape"],
                **bwd_row[f"at_{GEMMA_ARCH}"]["forward_ms"]}
            for key, dname in (("max_abs_err_fp32_checks", "float32"),
                               ("max_abs_err_bf16_checks", "bfloat16")):
                row[key] = max(row[key], t_worst["flash_attention", dname])
    rows.append(bwd_row)

    lap("phase 7")
    # -- phase 8: multi-process writing, recovery, merge, remote -------------
    # ((e), the checkpoint, runs in phase 9 (a) on the loop's train state)
    gc.collect()
    torch.cuda.empty_cache()
    t8 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mp_")
    p8 = mp_write(np, torch, core, ops, args, PAPER_WRITE_OPTIONS, tmp, data,
                  raw_bytes, w_s)
    mp_death_and_recovery(np, torch, core, ops, args, PAPER_WRITE_OPTIONS, tmp)
    two = data if len(data) >= 2 else make_data(np, args.seed, 2, args.entries)
    p8["merge re-encode"], one = merge_path(np, core, ops, PAPER_WRITE_OPTIONS,
                                            tmp, two[:2])
    p8.update(remote_path(np, torch, core, ops, args, PAPER_WRITE_OPTIONS,
                          data, one))
    shutil.rmtree(tmp)
    t8f = time.perf_counter()
    p8.update(chaos_path(ops, args))
    w8 = time.perf_counter() - t8
    log(f"phase 8: (a)-(d) {t8f - t8:.3f} s, (f) {w8 - (t8f - t8):.3f} s "
        "((e) in phase 9 (a))")
    for row in rows:
        name = row["name"]
        if name in ops.WRITE_READ_KERNELS:
            by = row.setdefault("launches_by_path",
                                {"write -> read": row["launches"]})
            by.update({k: c[name] for k, c in p8.items() if c[name]})
            row["launches"] = sum(by.values())

    # -- phase 9: the main path as one program, the quickstart, the skim ----
    gc.collect()
    torch.cuda.empty_cache()
    t9 = time.perf_counter()
    tmp = os.path.dirname(corpus)
    p9, ck_s, loop_losses = loop_path(np, torch, ops, args, corpus, tmp)
    t9b = time.perf_counter()
    p9.update(quickstart_path(np, torch, core, ops, tmp))
    t9c = time.perf_counter()
    p9.update(skim_path(np, core, ops, args, tmp))
    t9d = time.perf_counter()
    log(f"phase 9: (a) {t9b - t9:.3f} s (phase 8 (e) {ck_s:.3f} s of it), "
        f"(b) {t9c - t9b:.3f} s, (c) {t9d - t9c:.3f} s, {t9d - t9:.3f} s in "
        "all")

    # -- phase 10: the meshed step, the four families, the dry-run ----------
    gc.collect()
    torch.cuda.empty_cache()
    t10 = time.perf_counter()
    dry = dryrun_start(tmp)
    p10 = mesh_path(np, torch, ops, args, corpus, tmp, loop_losses)
    t10b = time.perf_counter()
    p10.update(families_path(np, torch, ops, args, corpus))
    t10c = time.perf_counter()
    dryrun_finish(*dry)
    shutil.rmtree(tmp)
    t10d = time.perf_counter()
    log(f"phase 10: (a) {t10b - t10:.3f} s, (b) {t10c - t10b:.3f} s, (c) "
        f"waited {t10d - t10c:.3f} s more, {t10d - t10:.3f} s in all")
    for row in rows:  # K1-K8 and K5's backward: each has its paths' counts
        extra = {k: c[row["name"]] for p in (p9, p10) for k, c in p.items()
                 if c.get(row["name"])}
        if extra:
            if "launches_by_path" not in row:  # K7's and K8's: serve alone
                row["launches_by_path"] = {row["path"]: row["launches"]}
            row["launches_by_path"].update(extra)
            row["launches"] = sum(row["launches_by_path"].values())
    # K5's backward timed at the training shapes of chameleon-34b (head dim
    # 128), minicpm3-4b (q/k 96, v 64) and zamba2-2.7b (head dim 80);
    # K7's and K8's backward at rwkv6-7b's and zamba2-2.7b's (rows of
    # their own, their launches phase 10 (b)'s)
    for fam in ("chameleon-34b", "minicpm3-4b", "zamba2-2.7b"):
        n_fam = sum(c["flash_attention_bwd"] for k, c in p10.items()
                    if k.startswith(f"train {fam} "))
        at_fam = time_attention_bwd(torch, fam, n_fam, t_worst)
        bwd_row[f"at_{fam}"] = {k: at_fam[k] for k in (
            "launches", "shape", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_backend", "max_abs_err", "launch_ms",
            "forward_ms", "bytes", "call_ms", "library_call_ms",
            "library_max_abs_err")}
    for name in SCAN_BWD_TIMED:
        by = {k: c[name] for k, c in p10.items() if c.get(name)}
        rows.append(time_scan_bwd(torch, ops, name, sum(by.values()),
                                  t_worst))
        rows[-1]["launches_by_path"] = by
    log(f"phase 10: the backwards timed at the families' shapes "
        f"{time.perf_counter() - t10d:.3f} s")

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
