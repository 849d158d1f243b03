"""Tree helpers over nested dicts/tuples/lists of tensors.

Copies of ``path_str``/``tree_paths``/``tree_bytes`` of the JAX package,
written without ``jax.tree_util``: dict keys are visited in sorted order,
as JAX flattens them, so both packages give every leaf the same name
('layers/0/attn/wq') and the same order.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple


def path_str(path: Tuple[Any, ...]) -> str:
    """Human-readable tree path ('layers/0/attn/wq')."""
    return "/".join(str(p) for p in path)


def _walk(tree, prefix):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, prefix + (i,))
    else:
        yield prefix, tree


def tree_paths(tree) -> list:
    """[(name, leaf)] in JAX's flatten order."""
    return [(path_str(p), leaf) for p, leaf in _walk(tree, ())]


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf, keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_bytes(tree) -> int:
    """Total bytes of the tensor leaves."""
    return sum(t.numel() * t.element_size() for _, t in tree_paths(tree))
