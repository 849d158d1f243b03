"""Build the CUDA C++ kernels in ``repro_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` is compiled on its own with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, which is loaded with
``ctypes``.  No PyTorch header is included, so a build takes seconds.  The
libraries go into ``build/`` at the root of the checkout, named by a hash of
the sources and flags so that an edited source is rebuilt.  Nothing is built
when a module is imported: only the first launch of a kernel (or
``build_all``) builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo", "-ldl"]

_loaded: Dict[str, ctypes.CDLL] = {}
_functions: Dict[tuple, ctypes._CFuncPtr] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")
    return str(path)


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for one source, its output going to the log beside the
    library; returns (target, tmp, process) or None when already built."""
    target = _target(name)
    if target.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    with open(target.with_suffix(".log"), "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    return target, tmp, proc


def _finish(name: str, started) -> None:
    target, tmp, proc = started
    if proc.wait() != 0:
        out = target.with_suffix(".log").read_text()
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, target)


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> Dict[str, Path]:
    """Compile every source that is not built yet, all nvcc's at once."""
    started = {n: _start(n) for n in sources()}
    for n, s in started.items():
        if s is not None:
            _finish(n, s)
    return {n: _target(n) for n in sources()}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    if name not in _loaded:
        started = _start(name)
        if started is not None:
            _finish(name, started)
        lib = ctypes.CDLL(str(_target(name)))
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return _loaded[name]


def function(lib_name: str, fn_name: str, argtypes) -> ctypes._CFuncPtr:
    """C entry ``fn_name`` of ``csrc/<lib_name>.cu``, returning an int."""
    key = (lib_name, fn_name)
    if key not in _functions:
        fn = getattr(library(lib_name), fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _functions[key] = fn
    return _functions[key]


def check(lib_name: str, err: int) -> None:
    """Raise if a C entry returned a CUDA error (its cudaGetLastError())."""
    if err != 0:
        msg = library(lib_name).cuda_error_string(err).decode()
        raise RuntimeError(f"{lib_name} kernel launch failed: "
                           f"CUDA error {err} ({msg})")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # as in common.cuh


def dtype_code(t) -> int:
    """Code of a float32 / bfloat16 tensor for the C entries; raises on
    any other dtype."""
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")
    return _DTYPE_CODES[t.dtype]


def require_cuda(name: str, *tensors) -> None:
    """Check what every CUDA wrapper needs of its tensor arguments: on one
    CUDA device, contiguous, 16-byte aligned."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: all tensors must be on one CUDA "
                             f"device, got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")
