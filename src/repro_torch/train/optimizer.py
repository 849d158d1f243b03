"""AdamW with global-norm clipping, as plain functions on tensor trees.

The JAX package's ``repro.train.optimizer`` (no ``torch.optim``): moment
buffers live in f32 whatever the param dtype; the update is computed in f32
and cast back; weight decay applies to every leaf, norms and embeddings
included.  Leaves are visited in JAX's flatten order (sorted dict keys), so
the squares of the global norm are summed leaf by leaf in the same order.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.utils import tree_leaves, tree_map, tree_unflatten

PyTree = Any


class OptHyper(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def init_opt_state(params: PyTree) -> Tuple[PyTree, PyTree]:
    """(m, v): f32 zeros shaped like each param, on its device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return tree_map(zeros, params), tree_map(zeros, params)


def global_norm(tree: PyTree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


def adamw_update(params: PyTree, grads: PyTree, m: PyTree, v: PyTree,
                 step: torch.Tensor, hyper: OptHyper = OptHyper()):
    """Returns (new_params, new_m, new_v, grad_norm); the inputs are not
    modified."""
    gnorm = global_norm(grads)
    scale = torch.clamp(hyper.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    t = step.float() + 1.0
    bc1 = 1.0 - hyper.b1 ** t
    bc2 = 1.0 - hyper.b2 ** t

    def upd(p, g, m_, v_):
        g = g.float() * scale
        m2 = hyper.b1 * m_ + (1 - hyper.b1) * g
        v2 = hyper.b2 * v_ + (1 - hyper.b2) * g * g
        mhat = m2 / bc1
        vhat = v2 / bc2
        pf = p.float()
        pf = pf - hyper.lr * (mhat / (torch.sqrt(vhat) + hyper.eps)
                              + hyper.weight_decay * pf)
        return pf.to(p.dtype), m2, v2

    out = [upd(*leaves) for leaves in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(m),
        tree_leaves(v))]
    new_p = tree_unflatten(params, [o[0] for o in out])
    new_m = tree_unflatten(params, [o[1] for o in out])
    new_v = tree_unflatten(params, [o[2] for o in out])
    return new_p, new_m, new_v, gnorm
