"""Core layer primitives: norms, RoPE, MLPs, embeddings, initializers.

Plain functions on tensors: parameters are nested dicts of tensors with the
JAX package's names and ``(in, out)`` weight layout, every layer is
``apply(params, x, ...) -> y``.  Activations stay in the config dtype (bf16
by default) with reductions in f32 where it matters, as in the JAX package.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def param_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def dense_init(gen: torch.Generator, shape, dtype, fan_in=None):
    """Normal(0, 1/fan_in) drawn in f32 from ``gen`` on the CPU, then cast."""
    fan_in = fan_in if fan_in is not None else shape[0]
    w = torch.randn(shape, generator=gen, dtype=torch.float32)
    return w.div_(math.sqrt(fan_in)).to(dtype)


# ----------------------------------------------------------------- RMSNorm
def rmsnorm_init(d, dtype):
    return {"scale": torch.ones((d,), dtype=dtype)}


def rmsnorm(params, x, eps):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


# -------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Half-split rotation.  x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    angles = positions[..., None].float() * freqs           # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                   # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# --------------------------------------------------------------------- MLP
def mlp_init(gen, cfg):
    d, ff, dt = cfg.d_model, cfg.d_ff, param_dtype(cfg)
    if cfg.mlp_kind == "swiglu":
        return {"wi": dense_init(gen, (d, ff), dt),
                "wg": dense_init(gen, (d, ff), dt),
                "wo": dense_init(gen, (ff, d), dt, fan_in=ff)}
    return {"wi": dense_init(gen, (d, ff), dt),
            "wo": dense_init(gen, (ff, d), dt, fan_in=ff)}


def mlp(params, x, cfg):
    if cfg.mlp_kind == "swiglu":
        h = F.silu(x @ params["wg"]) * (x @ params["wi"])
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ params["wi"], approximate="tanh")
    return h @ params["wo"]


# -------------------------------------------------------------- Embeddings
def embed_init(gen, cfg):
    """Token embedding (none for ``input_kind="embeds"``: the frontend hands
    in (B, S, d) embeddings) and, untied, the output head."""
    dt = param_dtype(cfg)
    p = {}
    if cfg.input_kind == "tokens":
        p["embedding"] = dense_init(gen, (cfg.vocab_size, cfg.d_model), dt,
                                    fan_in=cfg.d_model)
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), dt)
    return p


def embed(params, tokens_or_embeds, cfg):
    """(B, S) int tokens -> (B, S, d); (B, S, d) embeds are cast to the
    param dtype."""
    if cfg.input_kind == "tokens":
        return params["embedding"][tokens_or_embeds]
    return tokens_or_embeds.to(param_dtype(cfg))


def unembed(params, x, cfg):
    if cfg.tie_embeddings and cfg.input_kind == "tokens":
        w = params["embedding"].T
    else:
        w = params["unembed"]
    return x @ w
