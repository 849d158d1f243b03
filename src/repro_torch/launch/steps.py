"""Step factories: the single-device train step and the train state.

The JAX package's ``repro.launch.steps`` without the mesh: no sharding
rules, no ``shard_grads`` (ROADMAP Queue 1 item 10).  The state is the same
tree, ``{"params", "m", "v", "step"}``, with the same leaf names, so a
checkpoint manifest of either package restores in the other.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.transformer import forward, init_params, lm_loss, \
    lm_loss_chunked
from repro_torch.train.optimizer import OptHyper, adamw_update, \
    init_opt_state
from repro_torch.utils import tree_leaves, tree_unflatten

PyTree = Any


def _state(cfg, seed, device):
    params = init_params(cfg, seed, device)
    m, v = init_opt_state(params)
    return {"params": params, "m": m, "v": v,
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def abstract_state(cfg: ModelConfig) -> PyTree:
    """The train state's tree of shapes and dtypes, on the meta device:
    nothing is drawn or allocated (the counterpart of ``jax.eval_shape``)."""
    meta = torch.device("meta")
    with meta:
        return _state(cfg, 0, meta)


def make_init_fn(cfg: ModelConfig, device="cuda") -> Callable[[int], PyTree]:
    """``init_fn(seed)`` -> a fresh train state on ``device``."""
    dev = resolve_device(device)
    return lambda seed: _state(cfg, seed, dev)


def make_train_step(cfg: ModelConfig, shape: ShapeConfig,
                    hyper: OptHyper = OptHyper(), device="cuda"):
    """``train_step(state, batch) -> (new_state, {"loss", "grad_norm"})``.

    ``batch`` holds int tensors "tokens" and "labels" of (B, S) on
    ``device``.  With ``cfg.grad_accum > 1`` the batch is split into that
    many micro-batches whose f32 gradients (and losses) are summed, then
    divided.  The input state is not modified."""
    dev = resolve_device(device)
    if shape.global_batch % cfg.grad_accum:
        raise ValueError(f"batch {shape.global_batch} does not split into "
                         f"{cfg.grad_accum} micro-batches")

    def loss_of(params, tokens, labels):
        if cfg.loss_chunk:
            hidden, _ = forward(params, tokens, cfg, mode="train",
                                return_hidden=True)
            return lm_loss_chunked(params, hidden, labels, cfg)
        logits, _ = forward(params, tokens, cfg, mode="train")
        return lm_loss(logits, labels)

    def value_and_grad(params, tokens, labels):
        live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        loss = loss_of(tree_unflatten(params, live), tokens, labels)
        return loss.detach(), torch.autograd.grad(loss, live)

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        tokens, labels = batch["tokens"], batch["labels"]
        accum = cfg.grad_accum
        if accum > 1:
            B = tokens.shape[0]
            tk = tokens.reshape((accum, B // accum) + tokens.shape[1:])
            lb = labels.reshape((accum, B // accum) + labels.shape[1:])
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
                     for p in tree_leaves(state["params"])]
            loss = 0.0
            for i in range(accum):
                l_i, g_i = value_and_grad(state["params"], tk[i], lb[i])
                grads = [a + g for a, g in zip(grads, g_i)]
                loss = loss + l_i
            grads = [g / accum for g in grads]
            loss = loss / accum
        else:
            loss, grads = value_and_grad(state["params"], tokens, labels)
        new_p, new_m, new_v, gnorm = adamw_update(
            state["params"], tree_unflatten(state["params"], grads),
            state["m"], state["v"], state["step"], hyper)
        new_state = {"params": new_p, "m": new_m, "v": new_v,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss.float(), "grad_norm": gnorm}

    return train_step
