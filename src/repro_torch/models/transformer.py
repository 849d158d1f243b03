"""Model assembly: repeating-unit block stacks, looped over repeats.

The per-layer block pattern (cfg.block_pattern) is a repeating unit; params
for each unit position are stacked over repeats on axis 0, as in the JAX
package, and a Python loop over repeats takes the place of ``lax.scan``.
In train mode each layer is rematerialised as ``cfg.remat`` says, the
counterpart of the JAX package's ``jax.checkpoint`` policies.  The port
runs the ``ATTN`` and ``ATTN_MOE`` blocks; the recurrent block kinds and
Zamba2's shared attention raise ``NotImplementedError`` naming their ROADMAP
item.
"""
from __future__ import annotations

import functools
from typing import Any

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, \
    create_selective_checkpoint_contexts

from repro_torch import resolve_device
from repro_torch.configs.base import ATTN, ATTN_MOE, MAMBA2, MLSTM, SLSTM, \
    ModelConfig
from repro_torch.models import attention, moe as moe_mod
from repro_torch.models.layers import embed, embed_init, mlp, mlp_init, \
    param_dtype, rmsnorm, rmsnorm_init, unembed
from repro_torch.utils import tree_leaves, tree_map

PyTree = Any


# the block kinds still to port, by the ROADMAP Queue 1 item that ports them
_UNPORTED = {MAMBA2: "item 9.3: Mamba-2", MLSTM: "item 9.4: xLSTM",
             SLSTM: "item 9.4: xLSTM"}


def _attn_only(cfg):
    for kind in cfg.block_pattern:
        if kind in _UNPORTED:
            raise NotImplementedError(
                f"{cfg.name}: block kind {kind!r} is not ported yet "
                f"(ROADMAP Queue 1 {_UNPORTED[kind]})")
        if kind not in (ATTN, ATTN_MOE):
            raise ValueError(kind)
    if cfg.shared_attn_every:
        raise NotImplementedError(
            f"{cfg.name}: shared attention is not ported yet "
            "(ROADMAP Queue 1 item 9.3: Zamba2 shared attention)")


# ------------------------------------------------------------------- init
def _block_init(gen, cfg, kind):
    dt = param_dtype(cfg)
    p = {"ln1": rmsnorm_init(cfg.d_model, dt),
         "attn": attention.attn_init(gen, cfg),
         "ln2": rmsnorm_init(cfg.d_model, dt)}
    if kind == ATTN:
        p["mlp"] = mlp_init(gen, cfg)
    else:
        p["moe"] = moe_mod.moe_init(gen, cfg)
    return p


def n_repeats(cfg) -> int:
    if cfg.n_layers % len(cfg.block_pattern):
        raise ValueError(f"{cfg.name}: n_layers must divide by unit length")
    return cfg.n_layers // len(cfg.block_pattern)


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> PyTree:
    """Random params with the JAX package's names, shapes and dtypes, drawn
    on the CPU from a ``torch.Generator`` seeded with ``seed`` (so every
    device gets the same values), block by block, each block copied into
    its repeat of the stacked leaves on ``device`` as it is drawn (the host
    holds one block at a time)."""
    dev = resolve_device(device)
    _attn_only(cfg)
    gen = torch.Generator().manual_seed(seed)
    reps = n_repeats(cfg)
    layers = []
    for kind in cfg.block_pattern:
        stacked = None
        for r in range(reps):
            block = _block_init(gen, cfg, kind)
            if stacked is None:
                stacked = tree_map(lambda t: torch.empty(
                    (reps,) + t.shape, dtype=t.dtype, device=dev), block)
            for dst, src in zip(tree_leaves(stacked), tree_leaves(block)):
                dst[r].copy_(src)
        layers.append(stacked)
    params = {
        "embed": embed_init(gen, cfg),
        "layers": tuple(layers),
        "final_norm": rmsnorm_init(cfg.d_model, param_dtype(cfg)),
    }
    return tree_map(lambda t: t.to(dev), params)


# ------------------------------------------------------------------ cache
def init_cache(cfg, batch: int, max_seq: int, layout: str = "dense",
               device="cuda") -> PyTree:
    """KV cache {"layers": (group, ...)}, one group per block of the unit,
    each leaf with a leading repeats axis: "dense" {"k", "v"} of
    (reps, B, max_seq, nkv, hd); "paged" {"pool_k", "pool_v", "table"} of
    (reps, B, nblk, bs, nkv, hd) and (reps, B, nblk)."""
    dev = resolve_device(device)
    _attn_only(cfg)
    reps = n_repeats(cfg)

    def stacked():
        c = attention.init_attn_cache(cfg, batch, max_seq, layout,
                                      device=dev)
        return {k: v[None].repeat((reps,) + (1,) * v.dim())
                for k, v in c.items()}

    return {"layers": tuple(stacked() for _ in cfg.block_pattern)}


# ------------------------------------------------------------------ apply
def _block_apply(kind, p, x, cfg, mode, cache, pos):
    """One ATTN or ATTN_MOE block."""
    eps = cfg.norm_eps
    h = rmsnorm(p["ln1"], x, eps)
    a, cache = attention.attn_apply(p["attn"], h, cfg, mode=mode,
                                    cache=cache, pos=pos)
    x = x + a
    h2 = rmsnorm(p["ln2"], x, eps)
    if kind == ATTN_MOE:
        return x + moe_mod.moe_apply(p["moe"], h2, cfg), cache
    return x + mlp(p["mlp"], h2, cfg), cache


def _save_matmuls(ctx, op, *args, **kwargs):
    """remat="dots": keep the 2-D matmul outputs (the projections, whose
    operands carry no batch dimension), recompute everything else: the
    counterpart of ``checkpoint_dots_with_no_batch_dims``."""
    return (CheckpointPolicy.MUST_SAVE if op == torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_kwargs(cfg):
    """Keyword arguments of ``checkpoint`` for one train-mode layer, or None
    when ``cfg.remat`` is "none".  "full" saves nothing inside the layer
    (``nothing_saveable``)."""
    if cfg.remat == "none":
        return None
    if cfg.remat == "full":
        return {"use_reentrant": False}
    if cfg.remat == "dots":
        return {"use_reentrant": False, "context_fn": functools.partial(
            create_selective_checkpoint_contexts, _save_matmuls)}
    raise ValueError(f"remat={cfg.remat!r}")


def _train_block(kind, p, x, cfg):
    return _block_apply(kind, p, x, cfg, "train", None, None)[0]


def forward(params, inputs, cfg: ModelConfig, *, mode="train", caches=None,
            pos=None, return_hidden=False):
    """inputs: (B, S) int tokens or (B, S, d) embeds.  Returns (logits,
    caches), or (the final normed hidden states, caches) with
    ``return_hidden``.

    mode is "train" (no cache), "prefill" (writes rows 0..S-1 of a dense
    cache, or whole blocks through a paged cache's tables, when S must be
    a multiple of kv_block_size) or "decode" (S == 1 at per-sequence
    ``pos``).  Caches are updated in place and returned."""
    _attn_only(cfg)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(mode)
    x = embed(params["embed"], inputs, cfg)
    use_cache = caches is not None
    remat = _remat_kwargs(cfg) if mode == "train" else None
    for pi, kind in enumerate(cfg.block_pattern):
        lp = params["layers"][pi]
        lc = caches["layers"][pi] if use_cache else None
        for r in range(n_repeats(cfg)):
            p_r = tree_map(lambda a: a[r], lp)
            if remat is not None:
                x = checkpoint(_train_block, kind, p_r, x, cfg, **remat)
                continue
            c_r = {k: v[r] for k, v in lc.items()} if use_cache else None
            x, _ = _block_apply(kind, p_r, x, cfg, mode, c_r, pos)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if return_hidden:
        return x, caches
    return unembed(params["embed"], x, cfg), caches


def _token_nll(logits, labels):
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    return lse - ll


def lm_loss(logits, labels, mask=None):
    """Mean next-token cross-entropy. logits:(B,S,V) labels:(B,S)."""
    nll = _token_nll(logits, labels)
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()


def _chunk_nll_sum(params, h, labels, cfg):
    return _token_nll(unembed(params["embed"], h, cfg), labels).sum()


def lm_loss_chunked(params, hidden, labels, cfg):
    """Cross-entropy computed in sequence chunks of ``cfg.loss_chunk``: the
    (B, S, V) logits tensor never materializes (per-chunk unembed + CE,
    recomputed in the backward pass).  Memory: O(B * loss_chunk * V)."""
    B, S, d = hidden.shape
    c = min(cfg.loss_chunk, S)
    n = S // c
    hc = hidden.reshape(B, n, c, d)
    lc = labels.reshape(B, n, c)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n):
        total = total + checkpoint(_chunk_nll_sum, params, hc[:, i],
                                   lc[:, i], cfg, use_reentrant=False)
    return total / (B * S)
