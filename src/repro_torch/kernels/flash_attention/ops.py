"""Grouped-query attention wrapper: the plain version for CPU tensors, the
CUDA kernels (``csrc/flash_attention.cu``) for CUDA tensors: bf16 on the
tensor cores (wgmma, TMA), f32 on FMAs.

Replaces ``repro.kernels.flash_attention.ops.mha`` and its TPU kernel
``flash_one_head``.  The kernels read the kv head of each query head by
index (no ``repeat``), take S as it is (no padding to tile multiples) and
read q, k and v through their strides, so a [B,S,H,D] buffer viewed as
[B,H,S,D] goes in without a copy; the output keeps q's layout.  TMA reads
a bf16 tensor only if its base address and strides are multiples of 16
bytes; a tensor that is not so is first copied to a dense layout, counted
in ``mha.layout_copies``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref

HEAD_DIMS = (8, 16, 120, 128)  # the head dims the kernel is built for
DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 12
                   + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, q: torch.Tensor, shape) -> None:
    if t.device != q.device or t.dtype != q.dtype:
        raise ValueError(f"{name} is {t.dtype} on {t.device}; q is "
                         f"{q.dtype} on {q.device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{shape}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name}'s head dim must be contiguous")


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: int = 0, impl: str = "auto"
        ) -> torch.Tensor:
    """Grouped-query attention.  q: [B,H,S,D]; k,v: [B,Hkv,S,D] ->
    [B,H,S,D].  Query head h reads kv head h // (H / Hkv).  window > 0
    keeps key j for query i only if i - j < window."""
    if q.device.type == "cpu":
        return ref.mha(q, k, v, causal=causal, window=window)
    _build.require_kernel_impl(impl, "flash_attention")
    if q.dim() != 4:
        raise ValueError(f"q has {q.dim()} dims, expected 4")
    b, h, s, d = q.shape
    hkv = k.shape[1] if k.dim() == 4 else 0
    if q.dtype not in DTYPES:
        raise ValueError(f"q has dtype {q.dtype}, expected one of {DTYPES}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one of {HEAD_DIMS}")
    if hkv == 0 or h % hkv:
        raise ValueError(f"{hkv} kv heads do not divide {h} heads")
    _check(q, "q", q, (b, h, s, d))
    _check(k, "k", q, (b, hkv, s, d))
    _check(v, "v", q, (b, hkv, s, d))
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        q, k, v = (_tma_ready(x) for x in (q, k, v))
    out = torch.empty_like(q)  # q's layout, dense
    _build.check(_entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], b, h, hkv, s, d, int(bf16),
        int(causal), int(window), _build.stream_ptr(out)), "flash_attention")
    mha.launches += 1
    return out


mha.launches = 0
mha.layout_copies = 0

TMA_ALIGN = 16  # bytes: TMA's rule for a base address and each stride


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` if TMA can read it as it lies, else a dense copy (counted)."""
    if t.data_ptr() % TMA_ALIGN == 0 and all(
            st * t.element_size() % TMA_ALIGN == 0 for st in t.stride()[:3]):
        return t
    mha.layout_copies += 1
    return t.clone(memory_format=torch.contiguous_format)
