"""Build and load the hand-written CUDA kernels (``jlm_tpu_torch/csrc``).

One ``nvcc`` process per ``csrc/*.cu``, all started together, compiles
each source to an object; one more links them into a shared library with
a plain C interface, loaded with ``ctypes`` — no PyTorch headers, so a
build takes seconds rather than the minutes a ``torch.utils.cpp_extension``
build takes.  The library lands in ``build/kernels/`` at the repository root,
named by a hash of the sources and flags, so an unchanged tree reuses it.

Nothing here runs at import: the first kernel launch calls :func:`lib`.
``--use_fast_math`` is deliberately absent: it would change ``/``, ``expf``
and ``tanhf``, and the int8 head's activation quantization must divide
exactly as the reference does.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry point -> argtypes; every entry returns a cudaError_t as int.
_SIGNATURES = {
    "jlm_project_ms": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _P],
    "jlm_lstm_cell": [_P, _P, _P, _I, _P, _P, _P, _I, _P,
                      _I, _I, _I, ctypes.c_float, _P],
    "jlm_cand_dot": [_P, _P, _I, _P, _P, _I, _I, _I, _I, _P],
    "jlm_ce_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "jlm_ce_bwd_dh": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _I, _P],
    "jlm_ce_bwd_dw": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "jlm_lstm_scan_max_blocks": [_I, _I, _I, _I, _I],
    "jlm_lstm_scan_fwd": [_P] * 9 + [_I] * 4 + [ctypes.c_float, _I, _P],
    "jlm_lstm_scan_bwd": [_P] * 14 + [_I] * 4 + [ctypes.c_float, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: no CUDA toolkit on PATH or CUDA_HOME")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _tag() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the kernels if this source tree has no library yet; return
    the library's path.  Records timing and nvcc's log in ``build_info``."""
    so = os.path.join(BUILD_DIR, f"libjlm_kernels_{_tag()}.so")
    if os.path.exists(so):
        build_info.update(path=so, seconds=0.0, cached=True)
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in sources():
        obj = f"{tmp}.{os.path.basename(src)}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True)))
    logs = []
    for cmd, proc in procs:
        _, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
    cmd = [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", tmp, *objs]
    link = subprocess.run(cmd, capture_output=True, text=True)
    for obj in objs:
        os.remove(obj)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}): {' '.join(cmd)}\n"
                           f"{link.stderr}")
    seconds = time.perf_counter() - t0
    os.replace(tmp, so)  # atomic: concurrent builders race harmlessly
    build_info.update(path=so, seconds=seconds, cached=False, log="".join(logs))
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(t) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
