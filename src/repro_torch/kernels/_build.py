"""Build-at-first-use loader for the hand-written CUDA kernels.

Every ``.cu`` source under ``csrc/`` is compiled with ``nvcc`` — one
compiler process per source, all started together — and the objects are
linked into one shared library with a plain C interface, loaded with
:mod:`ctypes`. No PyTorch headers, so a build takes seconds rather than
minutes. The library is cached under ``build/repro_torch_kernels/`` at
the repository root, keyed by a hash of every source and header under
``csrc/`` and the compiler flags, so editing or adding one rebuilds it.

Nothing here runs at import time: the CPU tests import every module, and
this host may have no ``nvcc`` and no card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = sorted(CSRC.glob("*.cu"))
HEADERS = sorted(CSRC.glob("*.cuh"))
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [
    *ARCH_FLAGS,
    "-O3", "-fmad=false", "-std=c++17",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_SIGNATURES = {
    # name: argtypes (pointers and the stream as void*, counts as long long)
    "bw8_quantize": [_P, _P, _P, ctypes.c_longlong, _P],
    "bw8_dequantize": [_P, _P, _P, ctypes.c_longlong, _P],
    "bw8_fold": [_P, _P, _P, ctypes.c_float, ctypes.c_longlong, _P],
    # qs, absmax, weights, out; K, nblocks; stream
    "bw8_agg": [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, _P],
    # device x, packed, absmax; count; host code, mids, perm; stream
    "fb4_quantize": [_P, _P, _P, ctypes.c_longlong, _P, _P, _P, _P],
    "fb4_dequantize": [_P, _P, _P, ctypes.c_longlong, _P, _P, _P, _P],
    # q, k, v, o; B, H, KV, sq, sk, hd; bf16, causal, has_window; window;
    # scale; the layout's rows, warps; its shared bytes; stream
    "flash_attention_fwd": [_P, _P, _P, _P, *[ctypes.c_longlong] * 6,
                            *[ctypes.c_int] * 3, ctypes.c_longlong, ctypes.c_float,
                            *[ctypes.c_int] * 2, ctypes.c_longlong, _P],
    # hd; bf16; out[4] (CTAs an SM, registers, local bytes, threads)
    "flash_attention_occupancy": [ctypes.c_longlong, ctypes.c_int, _P],
    # gx, r, h_out, state; B, S, H, hd; bf16, split, threads; smem bytes; stream
    "slstm_scan_fwd": [_P, _P, _P, _P, *[ctypes.c_longlong] * 4, *[ctypes.c_int] * 3,
                       ctypes.c_longlong, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: guards every wrapper's ``launches`` counter: the async runtime launches
#: kernels from worker threads, and a bare ``+=`` there can lose a count
count_lock = threading.Lock()


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else
    ``nvcc`` on ``PATH``; raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "the repro_torch CUDA kernels need nvcc to build; none found in "
            "$CUDA_HOME/bin, /usr/local/cuda/bin or on PATH"
        )
    return found


def build() -> tuple[Path, str]:
    """Compile ``SOURCES`` if their cached library is missing; returns the
    library path and the compiler's output (``-Xptxas -v`` register and
    spill report per kernel; empty when the cache was hit)."""
    nvcc = find_nvcc()
    key = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        key.update(src.name.encode() + b"\0" + src.read_bytes())
    lib_path = BUILD_DIR / f"librepro_torch_kernels-{key.hexdigest()[:16]}.so"
    if lib_path.is_file():
        return lib_path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{key.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}-{tag}.o" for src in SOURCES]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(SOURCES, objs)
    ]
    logs = [p.communicate()[0] for p in procs]
    for src, proc, log in zip(SOURCES, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} (exit {proc.returncode}):\n{log}")
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True, check=False)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc failed to link the kernel library (exit "
                           f"{link.returncode}):\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib_path)
    return lib_path, "".join(f"== {src.name}\n{log}" for src, log in zip(SOURCES, logs))


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call kernel entry ``name`` on ``device``'s current stream; raises
    if the launch was refused (a refused launch never runs, and a later
    synchronize would not report it)."""
    fn = getattr(library(), name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
