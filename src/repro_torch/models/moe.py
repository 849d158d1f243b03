"""Token-choice top-k Mixture-of-Experts FFN, without a mesh.

The JAX package's ``moe_apply`` on one device: the dense no-drop path
(every expert computed, the top-k weights mask the sum) for B*S <= 4096,
and the capacity-bounded dispatch of ``_moe_local`` (model_axis=None, all
experts local) above it.  The expert-parallel ``shard_map`` branch waits
for the mesh (ROADMAP Queue 1 item 10).  The JAX package has no kernel for
MoE, so this is plain PyTorch on every device; the expert products go to
``torch.matmul``.

Routing runs in f32 (the router is an f32 parameter).  Every scatter here
has a deterministic CUDA implementation, so the module runs under
``torch.use_deterministic_algorithms(True)``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, param_dtype


def moe_init(gen, cfg):
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = param_dtype(cfg)
    return {
        "router": dense_init(gen, (d, E), torch.float32),
        "experts_wi": dense_init(gen, (E, d, ff), dt),
        "experts_wg": dense_init(gen, (E, d, ff), dt),
        "experts_wo": dense_init(gen, (E, ff, d), dt, fan_in=ff),
    }


def _route(xt, router_w, top_k):
    """(T, d) -> top-k weights (T, k) renormalised to sum 1, their expert
    indices (T, k) and the router's probabilities (T, E).

    ``jax.lax.top_k`` order: values descending, the lower index first on
    ties.  ``torch.topk`` does not promise that tie order; a stable
    descending sort does."""
    logits = xt.float() @ router_w                      # (T, E)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :top_k], topi[:, :top_k]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    return topv, topi, probs


def _expert_ffn(buf, wi, wg, wo):
    """buf: (E, C, d) -> (E, C, d) via per-expert SwiGLU."""
    h = F.silu(torch.matmul(buf, wg)) * torch.matmul(buf, wi)
    return torch.matmul(h, wo)


def _moe_dense_nodrop(xt, p, cfg):
    """All-experts dense path (small T): no capacity drops.

    The expert products are batched matmuls over E that broadcast ``xt``
    (T, d), so the weights are read in place; the results are (E, T, .)
    where the JAX package's einsums give (T, E, .)."""
    topv, topi, _ = _route(xt, p["router"], cfg.top_k)
    h = F.silu(torch.matmul(xt, p["experts_wg"])) * \
        torch.matmul(xt, p["experts_wi"])                # (E, T, ff)
    y_all = torch.matmul(h, p["experts_wo"])            # (E, T, d)
    # a row's top-k indices are distinct: a plain scatter adds them
    w = torch.zeros((xt.shape[0], y_all.shape[0]), dtype=torch.float32,
                    device=xt.device)
    w = w.scatter(1, topi, topv)                        # (T, E)
    # per token t: (1, E) @ (E, d)
    out = torch.bmm(w[:, None, :], y_all.float().transpose(0, 1))
    return out[:, 0].to(xt.dtype)


def _moe_local(xt, router_w, wi, wg, wo, *, cfg, E_local):
    """Capacity-bounded dispatch over ``E_local`` experts.  xt: (T, d).

    Each (token, choice) pair takes the next free row of its expert's
    buffer, in the order of the flattened (T * k,) choices; pairs past the
    capacity C go to the drop bucket (row E_local), which the expert
    products never read."""
    T, d = xt.shape
    k, E = cfg.top_k, cfg.n_experts
    topv, topi, _ = _route(xt, router_w, k)
    e_flat = topi.reshape(-1)                           # (T*k,)
    w_flat = topv.reshape(-1)
    is_local = e_flat < E_local
    e_loc = torch.where(is_local, e_flat, E_local)      # E_local = drop bucket
    onehot = F.one_hot(e_loc, E_local + 1)
    pos = torch.cumsum(onehot, dim=0) - onehot
    pos = torch.gather(pos, 1, e_loc[:, None])[:, 0]
    C = max(int(cfg.capacity_factor * k * T / E), 1)
    keep = is_local & (pos < C)
    e_sc = torch.where(keep, e_loc, E_local)            # scatter drop row
    p_sc = torch.where(keep, pos, 0)
    x_rep = torch.repeat_interleave(xt, k, dim=0)       # (T*k, d)
    buf = torch.zeros((E_local + 1, C, d), dtype=xt.dtype, device=xt.device)
    # every dropped pair lands on (E_local, 0): the sum is real there
    buf = buf.index_put((e_sc, p_sc), x_rep * keep[:, None].to(xt.dtype),
                        accumulate=True)
    y = _expert_ffn(buf[:E_local], wi, wg, wo)          # (E_local, C, d)
    y = torch.cat([y, torch.zeros((1, C, d), dtype=y.dtype,
                                  device=y.device)], dim=0)
    gathered = y[e_sc, p_sc] * (w_flat * keep)[:, None].to(y.dtype)
    out = gathered.reshape(T, k, d).sum(dim=1)
    return out.to(xt.dtype)


def moe_apply(params, x, cfg):
    """x: (B, S, d) -> (B, S, d)."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    if B * S <= 4096:
        out = _moe_dense_nodrop(xt, params, cfg)
    else:
        out = _moe_local(xt, params["router"], params["experts_wi"],
                         params["experts_wg"], params["experts_wo"],
                         cfg=cfg, E_local=cfg.n_experts)
    return out.reshape(B, S, d)
