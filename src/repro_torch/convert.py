"""Carry parameter trees between numpy (as JAX hands them out) and torch.

Leaves keep their ``path_str`` names: the tree structure (dicts with the
same keys, tuples for the per-pattern stacks) is the same on both sides.
bf16 crosses bit-exactly: JAX's bf16 arrives as a numpy array whose dtype is
named ``bfloat16`` (ml_dtypes); it is viewed as uint16 and reinterpreted as
``torch.bfloat16`` with no rounding.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.utils import tree_map


def _to_torch(arr, device):
    arr = np.array(arr)  # a writable copy: caches are updated in place
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def _to_numpy(t: torch.Tensor):
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        # numpy knows 'bfloat16' only once ml_dtypes is loaded (JAX loads
        # it); the caller that wants bf16 numpy arrays has it loaded.
        return t.view(torch.int16).numpy().view(np.uint16).view(
            np.dtype("bfloat16"))
    return t.numpy()


def params_from_numpy(tree, device="cuda"):
    """numpy tree (e.g. ``jax.tree.map(np.asarray, params)``) -> torch tree."""
    dev = resolve_device(device)
    return tree_map(lambda a: _to_torch(a, dev), tree)


def params_to_numpy(tree):
    """torch tree -> numpy tree (bf16 leaves as numpy 'bfloat16')."""
    return tree_map(_to_numpy, tree)
