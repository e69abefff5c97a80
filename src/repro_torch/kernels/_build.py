"""Build the port's CUDA kernels with nvcc and bind them through ctypes.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled on
first use into its own shared library under ``build/repro_torch_kernels/``
at the root of the checkout (``-gencode arch=compute_90a,code=sm_90a``),
named by a digest of the source so an edited kernel is rebuilt.  No
PyTorch header is included, which keeps a build to seconds.  ``build``
starts one ``nvcc`` per source at once and waits for all of them.

Every C entry returns ``cudaGetLastError()`` after its launches;
:func:`check` raises on a non-zero code, because a refused launch never
runs and a later synchronise does not report it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("frontier_min", "hash_probe", "bool_matmul", "flash_attention",
           "embedding_bag")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# source name -> (build seconds, ptxas register / spill lines), for reports
build_log: Dict[str, Tuple[float, List[str]]] = {}


def _nvcc() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _target(name: str) -> Tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return src, BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> None:
    """Compile every named source whose library is missing, in parallel."""
    jobs = []
    for name in names:
        src, lib = _target(name)
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, lib, tmp, proc))
    t0 = time.perf_counter()
    failed = []
    for name, lib, tmp, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{out}")
            continue
        os.replace(tmp, lib)
        lines = [ln.strip() for ln in out.splitlines()
                 if "registers" in ln or "spill" in ln]
        build_log[name] = (time.perf_counter() - t0, lines)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)[1]))
            _libs[name] = lib
        return lib


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
            device: torch.device) -> None:
    """Reject what a kernel does not take: wrong device, type, rank or a
    non-contiguous layout."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has {t.dim()} dims, expected {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# impl values of GraphConfig.sparse_impl / dense_matmul_impl that ask for
# the plain version; on a CUDA tensor that is an error, never a fallback
PLAIN_IMPLS = ("xla", "pallas_interpret")


def require_kernel_impl(impl: str, name: str) -> None:
    if impl in PLAIN_IMPLS:
        raise ValueError(
            f"{name}: impl={impl!r} asks for the plain version, which runs "
            f"only on CPU tensors; CUDA tensors take the kernel "
            f"(impl='auto' or 'pallas')")
    if impl not in ("auto", "pallas"):
        raise ValueError(f"{name}: unknown impl {impl!r}")
