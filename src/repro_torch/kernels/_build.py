"""Build and bind the port's CUDA kernels.

Each source under ``repro_torch/csrc/`` compiles with ``nvcc`` into a
shared library with a plain C interface, loaded with ``ctypes``.  Builds
run at first use, one ``nvcc`` per source, all started together, into
``build/repro_torch/`` at the root of the checkout (``REPRO_TORCH_BUILD_DIR``
overrides it).  A library's file name carries a hash of every source and
the flags, so an edited source rebuilds and an unchanged one loads as is.

Nothing here runs when a module is imported: this package imports on
machines without ``nvcc`` or a card, and only a launch on a CUDA tensor
reaches :func:`library`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

#: extra flags per library: every library reports each kernel's
#: registers and spills (``ptxas -v``, kept in the build log), and the
#: attention libraries take ``dlopen`` for libcuda's tensor-map encoder
EXTRA_FLAGS: Dict[str, List[str]] = {"attention": ["-Xptxas", "-v", "-ldl"],
                                     "attention_bwd": ["-Xptxas", "-v",
                                                       "-ldl"],
                                     "byteplanes": ["-Xptxas", "-v"],
                                     "scans": ["-Xptxas", "-v"],
                                     "ssm": ["-Xptxas", "-v"]}

_P, _I64, _INT, _F32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_float)

#: library -> {C function: argtypes}; every launcher returns the
#: ``cudaGetLastError()`` code of its launches (0 = success), a size query
#: of ``RESTYPES`` its own type
SIGNATURES: Dict[str, Dict[str, List]] = {
    "scans": {
        # (in, out, workspace, capacity, n, epoch, base, stream)
        "repro_offsets_scan_i64": [_P, _P, _P, _I64, _I64, _I64, _I64, _P],
        # () -> values per tile, the unit of the workspace's capacity
        "repro_offsets_scan_tile": [],
        # (planes, out, n_pages, per, cluster, tile, stream)
        "repro_decode_offset_pages": [_P, _P, _I64, _I64, _INT, _I64, _P],
        # (in, out, n, stream)
        "repro_delta_zigzag_i32": [_P, _P, _I64, _P],
        "repro_delta_zigzag_i64": [_P, _P, _I64, _P],
    },
    "byteplanes": {
        # (in, out, n_pages, per, nb, stream)
        "repro_byteshuffle_pages": [_P, _P, _I64, _I64, _INT, _P],
        "repro_unsplit_pages": [_P, _P, _I64, _I64, _INT, _P],
        # (in, out, n, nb, stream)
        "repro_byteshuffle": [_P, _P, _I64, _INT, _P],
    },
    "attention": {
        # (q, k, v, o, lse (or null), B, H, G, Sq, Sk, D, Dv, dtype, causal,
        #  window, scale, stream)
        "repro_flash_attention": [_P, _P, _P, _P, _P, _I64, _I64, _I64,
                                  _I64, _I64, _INT, _INT, _INT, _INT, _INT,
                                  _F32, _P],
        # (q, k, v, length, o, part_m, part_l, part_acc, counters, B, H, G,
        #  S, D, dtype, chunk, n_chunks, warps, window, scale, stream)
        "repro_decode_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64,
                                   _I64, _I64, _I64, _INT, _INT, _INT, _INT,
                                   _INT, _INT, _F32, _P],
    },
    "attention_bwd": {
        # (q, k, v, o, dout, lse, dq, dk, dv, delta, part, B, H, G, Sq, Sk,
        #  D, Dv, dtype, causal, window, scale, stream)
        "repro_flash_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                      _P, _I64, _I64, _I64, _I64, _I64, _INT,
                                      _INT, _INT, _INT, _INT, _F32, _P],
    },
    "ssm": {
        # (r, k, v, w, u, o, state, B, H, T, Dk, Dv, dtype, stream)
        "repro_rwkv6_scan": [_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64,
                             _INT, _INT, _INT, _P],
        # (x, log_a, Bm, Cm, y, state, B, H, T, N, P, dtype, stream)
        "repro_mamba2_ssd": [_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _INT,
                             _INT, _INT, _P],
        # (B, H, T, Dk, Dv, dtype) -> the backward's workspace in floats
        "repro_rwkv6_scan_bwd_ws": [_I64, _I64, _I64, _INT, _INT, _INT],
        # (B, H, T, N, P, dtype) -> the same for K8's backward
        "repro_mamba2_ssd_bwd_ws": [_I64, _I64, _I64, _INT, _INT, _INT],
        # (r, k, v, w, u, dout, dstate, dr, dk, dv, dw, du, ws, ws_floats,
        #  B, H, T, Dk, Dv, dtype, stream)
        "repro_rwkv6_scan_bwd": [_P] * 13 + [_I64, _I64, _I64, _I64, _INT,
                                             _INT, _INT, _P],
        # (x, log_a, Bm, Cm, dy, dstate, dx, dlog_a, dBm, dCm, ws, ws_floats,
        #  B, H, T, N, P, dtype, stream)
        "repro_mamba2_ssd_bwd": [_P] * 11 + [_I64, _I64, _I64, _I64, _INT,
                                             _INT, _INT, _P],
    },
}
#: C functions that return something else than an error code
RESTYPES = {"repro_rwkv6_scan_bwd_ws": ctypes.c_int64,
            "repro_mamba2_ssd_bwd_ws": ctypes.c_int64}
_ERROR_STRING = "repro_cuda_error_string"  # (code) -> const char*, in every library

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/_build.py -> the checkout root
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels cannot build"
        )
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(EXTRA_FLAGS.items())).encode())
    for f in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _target(name: str, digest: str) -> Path:
    return build_dir() / f"lib{name}-{digest}.so"


def build_log(name: str) -> Path:
    """The compiler's output of library ``name``'s last build."""
    return _target(name, _digest()).with_suffix(".log")


def build_all() -> Dict[str, Path]:
    """Compile every library that is not built yet, one ``nvcc`` per
    source in parallel; returns ``{name: path}``.  Raises with the
    compiler's output when a build fails; keeps it beside the library
    (:func:`build_log`) when it succeeds."""
    digest = _digest()
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    todo = {n: _target(n, digest) for n in SIGNATURES}
    procs = []
    for name, target in todo.items():
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *EXTRA_FLAGS.get(name, []), "-I",
               str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for name, target, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed:\n{log.decode(errors='replace')}")
        else:
            target.with_suffix(".log").write_bytes(log)
            os.replace(tmp, target)  # atomic: a reader never sees half a file
    if errors:
        raise RuntimeError("\n".join(errors))
    return todo


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` with its functions' argtypes set,
    building every library on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            paths = build_all()
            for n, path in paths.items():
                cdll = ctypes.CDLL(str(path))
                for fn, argtypes in SIGNATURES[n].items():
                    f = getattr(cdll, fn)
                    f.argtypes = argtypes
                    f.restype = RESTYPES.get(fn, ctypes.c_int)
                f = getattr(cdll, _ERROR_STRING)
                f.argtypes = [ctypes.c_int]
                f.restype = ctypes.c_char_p
                _libs[n] = cdll
            lib = _libs[name]
        return lib


def check(lib: ctypes.CDLL, rc: int, kernel: str) -> None:
    """Raise when a launch reported a CUDA error."""
    if rc != 0:
        msg = getattr(lib, _ERROR_STRING)(rc).decode(errors="replace")
        raise RuntimeError(f"CUDA launch of {kernel} failed: {msg} ({rc})")


def launch_args(t):
    """``(device guard, stream handle)`` for launching on ``t``'s device
    on PyTorch's current stream of the calling thread."""
    import torch

    return (torch.cuda.device(t.device),
            torch.cuda.current_stream(t.device).cuda_stream)
