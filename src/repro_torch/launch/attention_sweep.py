"""Time the attention kernels (K5, K6) on one card beside the PyTorch
call computing the same function, and read the kernels' own durations
from ``torch.profiler``.

    PYTHONPATH=src python -m repro_torch.launch.attention_sweep [--out FILE]

K5 (bf16) runs at the serve shapes (smollm-360m's 15 over 5 heads of 64,
zamba2-2.7b's 32 heads of 80, 16 x 1,000 tokens) and at 4,096 tokens,
causal and not, against ``scaled_dot_product_attention``; each line gives
the card time (CUDA events between 20 launches queued behind a sleep
kernel, median) and the rate in TFLOP/s (``4 D`` operations per visible
(query, key) pair).  K6 (bf16) runs at the serve decode shapes (a
1,064-slot cache holding 1,032 rows) with its launch shape; both K6 and
the SDPA call are also traced, and the lines name every kernel each one
ran with its mean duration on the card.  The last line is one JSON
object of every number.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F

from repro_torch.kernels import decode_attention as K6
from repro_torch.kernels.flash_attention import flash_attention


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


def traced_kernels(fn, reps: int = 20) -> dict:
    """{kernel name: mean card microseconds per call} from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / reps for e in prof.key_averages()
            if e.device_time_total > 0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    result = {"card": card, "flash_attention": [], "decode_attention": []}
    for b, h, g, s, d in [(16, 15, 5, 1000, 64), (4, 15, 5, 4096, 64),
                          (16, 32, 32, 1000, 80), (2, 32, 32, 4096, 80)]:
        q, k, v = randn(b, h, s, d), randn(b, g, s, d), randn(b, g, s, d)
        for causal in (True, False):
            pairs = s * (s + 1) // 2 if causal else s * s
            ops = 4 * b * h * d * pairs
            ms = card_ms(lambda: flash_attention(q, k, v, causal=causal))
            lib = card_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True))
            row = {"shape": [b, h, g, s, s, d], "causal": causal, "ms": ms,
                   "tflops": ops / ms / 1e9, "sdpa_ms": lib,
                   "sdpa_tflops": ops / lib / 1e9}
            result["flash_attention"].append(row)
            print(f"K5 {tuple(row['shape'])} causal={causal}: {ms:.5f} ms = "
                  f"{row['tflops']:.1f} TFLOP/s; SDPA {lib:.5f} ms = "
                  f"{row['sdpa_tflops']:.1f} TFLOP/s", flush=True)
        del q, k, v
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b, h, g, d in [(16, 15, 5, 64), (16, 32, 32, 80)]:
        s, length = 1064, 1032
        q, k, v = randn(b, h, d), randn(b, g, s, d), randn(b, g, s, d)
        lens = torch.full((b,), length, dtype=torch.int32, device="cuda")
        k_l, v_l = k[:, :, :length].contiguous(), v[:, :, :length].contiguous()
        kern = lambda: K6.decode_attention(q, k, v, length=lens)
        lib = lambda: F.scaled_dot_product_attention(
            q[:, :, None], k_l, v_l, enable_gqa=True)
        row = {"shape": [b, h, g, s, d], "length": length,
               "launch_shape": list(K6.launch_shape(b, g, h // g, s, d, sms)),
               "ms": card_ms(kern), "sdpa_ms": card_ms(lib),
               "kernels": traced_kernels(kern),
               "sdpa_kernels": traced_kernels(lib)}
        result["decode_attention"].append(row)
        print(f"K6 {tuple(row['shape'])} length {length}, (chunk, chunks, "
              f"warps) {tuple(row['launch_shape'])}: {row['ms']:.5f} ms, SDPA "
              f"{row['sdpa_ms']:.5f} ms", flush=True)
        for who in ("kernels", "sdpa_kernels"):
            for name, us in row[who].items():
                print(f"  {who}: {name[:90]} {us:.3f} us", flush=True)
        del q, k, v, k_l, v_l
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
