"""GQA flash attention: CUDA kernel for CUDA tensors, plain version for CPU.

The wrapper runs ``flash_attention_ref`` only when q lies on the CPU; for
CUDA tensors it launches one of two CUDA kernels, or raises.  The route
depends on dtype and head dim alone (``route``): bf16 with hd 64 or 128
takes the tensor-core kernel ``csrc/flash_attention_wgmma.cu``; f32, and
bf16 with hd 16 or 256, take the CUDA-core kernel
``csrc/flash_attention.cu`` (f32 stays off the tensor cores, whose TF32
would not hold the f32 result to 2e-5).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

HEAD_DIMS = (16, 64, 128, 256)  # the CUDA-core kernel's instantiations
WGMMA_HEAD_DIMS = (64, 128)     # the tensor-core kernel's
ROUTES = {  # route -> (library, C entry, argtypes)
    "wgmma": ("flash_attention_wgmma", "flash_attention_wgmma",
              [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
              + [ctypes.c_void_p]),
    "cuda-core": ("flash_attention", "flash_attention",
                  [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                  + [ctypes.c_void_p]),
}


def route(dtype, hd: int) -> str:
    """The kernel a CUDA call takes: "wgmma" or "cuda-core"."""
    if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "cuda-core"


# The wgmma route rounds P to bf16 before P @ V, which flash_attention_ref
# does not, so against that plain version run in f32 (inputs upcast) each
# output row is held to max |err| <= WGMMA_ROW_REL * max |plain| of the row:
# the limit that tests/test_torch_kernels.py shows flash_attention_tiled_ref
# (the same rounding) keeps.  Not elementwise, even against that tiled
# version: where a P value lands on the other side of a bf16 rounding
# boundary in the kernel (its exp2, its order of summation), a near-zero
# output of a short row moves by more than the bf16 atol.
WGMMA_ROW_REL = 2.0 ** -7


def row_relative_error(out, plain) -> float:
    """Largest max |out - plain| / max |plain| over the rows (last axis)."""
    err = (out.float() - plain.float()).abs().amax(-1)
    top = plain.float().abs().amax(-1).clamp(min=1e-30)
    return (err / top).max().item()


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
    name = route(q.dtype, hd)
    lib, entry, argtypes = ROUTES[name]
    fn = _build.function(lib, entry, argtypes)
    extra = () if name == "wgmma" else (code,)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                 nh, nkv, Sq, Skv, hd, int(causal), *extra,
                 _build.stream_ptr(q.device))
    _build.check(lib, err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
