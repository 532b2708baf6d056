"""Build the CUDA sources under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into
``build/repro_torch_kernels/lib<name>-<digest>.so`` with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC

and exposes plain C entry points (no PyTorch headers, so a build takes
seconds).  ``digest`` hashes the source, the shared headers and the flags: a
changed source gets a new library, an unchanged one is reused.  Libraries
build at first use, or all at once, one ``nvcc`` each in parallel, through
:func:`build`; a lock makes threads that reach a missing library together
(the async tier's replica loops) build it once.

Each entry point takes device pointers and the stream as ``c_void_p``,
launches on that stream without synchronising, and returns
``cudaGetLastError()``; :func:`check` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

KERNELS = ("bloom_build", "bloom_probe", "edge_sample")
CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# one build at a time in a process: two threads would write one temporary
# file (its name holds the process id)
_BUILD_LOCK = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cands.append(shutil.which("nvcc"))
    for cand in cands:
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict:
    """Compile every library in ``names`` that is missing, one ``nvcc`` per
    source, all started together.  Returns ``{name: (seconds, nvcc's
    report)}`` for the ones it compiled (ptxas prints registers and spills).
    """
    with _BUILD_LOCK:
        return _build(names)


def _build(names) -> dict:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, procs = None, {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs[name] = (out, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    report, failed = {}, []
    for name, (out, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}:\n{log}")
            continue
        os.replace(tmp, out)
        report[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return report


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    build((name,))
    return ctypes.CDLL(str(library_path(name)))


@functools.cache
def function(lib: str, fn: str, argspec: str, restype=ctypes.c_int):
    """C entry point ``fn`` of library ``lib``; ``argspec`` has one letter
    per argument: ``p`` for a pointer or the stream, ``i`` for an int64."""
    f = getattr(load(lib), fn)
    f.argtypes = [ctypes.c_void_p if c == "p" else ctypes.c_int64
                  for c in argspec]
    f.restype = restype
    return f


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def require(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
            device: torch.device) -> None:
    """Raise unless ``t`` is what the kernel takes: dtype, shape, device,
    contiguous."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"{name}: want contiguous {dtype} {tuple(shape)} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def require_aligned(name: str, what: str, t: torch.Tensor, nbytes: int) -> None:
    """Raise unless ``t``'s data starts on a multiple of ``nbytes``."""
    if t.data_ptr() % nbytes:
        raise ValueError(f"{name}: {what} must be {nbytes}-byte aligned, "
                         f"starts at {t.data_ptr():#x}")
