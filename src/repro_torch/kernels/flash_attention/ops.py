"""GQA flash attention: CUDA kernel for CUDA tensors, plain version for CPU.

The wrapper runs ``flash_attention_ref`` only when q lies on the CPU; for
CUDA tensors it launches ``csrc/flash_attention.cu`` or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
HEAD_DIMS = (16, 64, 128, 256)  # the kernel's instantiations


def flash_attention(q, k, v, *, causal: bool = True):
    """q: (B, nh, Sq, hd); k, v: (B, nkv, Skv, hd).  Returns (B, nh, Sq, hd)
    in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    _build.require_cuda("flash_attention", q, k, v)
    B, nh, Sq, hd = q.shape
    if k.dim() != 4 or k.shape != v.shape:
        raise ValueError("k and v must both be (B, nkv, Skv, hd)")
    _, nkv, Skv, _ = k.shape
    if k.shape[0] != B or k.shape[3] != hd or nh % nkv:
        raise ValueError(f"q {tuple(q.shape)} does not match k "
                         f"{tuple(k.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k and v must share a dtype")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    code = _build.dtype_code(q)
    fn = _build.function("flash_attention", "flash_attention", _ARGS)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                 nh, nkv, Sq, Skv, hd, int(causal), code,
                 _build.stream_ptr(q.device))
    _build.check("flash_attention", err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
