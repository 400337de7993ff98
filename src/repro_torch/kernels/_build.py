"""Build-at-first-use loader for the hand-written CUDA kernels.

The sources under ``csrc/`` are compiled with ``nvcc`` into a shared
library with a plain C interface and loaded with :mod:`ctypes` — no
PyTorch headers, so a build takes seconds rather than minutes. The
library is cached under ``build/repro_torch_kernels/`` at the repository
root, keyed by a hash of the source and the compiler flags, so editing a
source rebuilds it.

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

SOURCE = Path(__file__).resolve().parent / "csrc" / "blockwise8.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-fmad=false", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_SIGNATURES = {
    # name: argtypes (pointers and the stream as void*, counts as long long)
    "bw8_quantize": [_P, _P, _P, ctypes.c_longlong, _P],
    "bw8_dequantize": [_P, _P, _P, ctypes.c_longlong, _P],
    "bw8_fold": [_P, _P, _P, ctypes.c_float, ctypes.c_longlong, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


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
    """Compile ``SOURCE`` if its cached library is missing; returns the
    library path and the compiler's output (``-Xptxas -v`` register and
    spill report; empty when the cache was hit)."""
    nvcc = find_nvcc()
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib_path = BUILD_DIR / f"lib{SOURCE.stem}-{key.hexdigest()[:16]}.so"
    if lib_path.is_file():
        return lib_path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True, check=False,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {SOURCE.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib_path)
    return lib_path, proc.stdout + proc.stderr


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
