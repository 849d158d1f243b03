"""Architecture configuration schema (copy of the JAX package's).

Every architecture the port runs gets one module in ``repro_torch/configs``
exporting ``CONFIG`` (the exact published figures) and ``SMOKE`` (a reduced
config of the same family for CPU tests).  ``repro_torch.configs.get(name)``
resolves either.  ``ModelConfig`` keeps every field of the JAX schema, so a
config carries over field for field; the port runs the ``ATTN`` and
``ATTN_MOE`` block kinds.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Optional, Tuple

# Block kinds of the schema; repro_torch.models.transformer runs ATTN and
# ATTN_MOE
ATTN = "attn"          # GQA attention + MLP (dense transformer layer)
ATTN_MOE = "attn_moe"  # GQA attention + MoE FFN
MAMBA2 = "mamba2"      # Mamba-2 (SSD) block
MLSTM = "mlstm"        # xLSTM matrix-memory block
SLSTM = "slstm"        # xLSTM scalar-memory block


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default: d_model // n_heads
    # attention variants
    qk_norm: bool = False            # qwen3 / chameleon
    qkv_bias: bool = False           # qwen2
    rope_theta: float = 10_000.0
    mlp_kind: str = "swiglu"         # swiglu | gelu
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # layer pattern: repeating unit of block kinds, cycled to n_layers
    block_pattern: Tuple[str, ...] = (ATTN,)
    # zamba2-style shared attention block applied every k-th layer (0 = off)
    shared_attn_every: int = 0
    # SSM
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    # frontends
    input_kind: str = "tokens"       # tokens | embeds (stub modality frontend)
    tie_embeddings: bool = True
    norm_eps: float = 1e-5
    # precision
    param_dtype: str = "bfloat16"
    # sequence parallelism: shard the residual stream's seq dim over the
    # model axis (Megatron-SP pattern; GSPMD inserts the AG/RS pairs).
    # Without it the remat-saved layer inputs alone exceed HBM on the
    # large archs (measured: 245GiB/dev for qwen2-72b train_4k).
    seq_shard: bool = True
    # pin gradients to the param (fsdp, model) sharding => reduce-scatter
    # instead of per-layer full all-reduce in the backward scan
    grad_shard: bool = True
    # sequence-parallel ATTENTION: shard the query seq dim over the model
    # axis inside attention (context parallelism).  The rescue for archs
    # whose head count does not divide the model axis (smollm: 9 heads vs
    # model=16 => 16x replicated attention compute without this).
    attn_seq_parallel: bool = False
    # chunked cross-entropy: compute unembed+CE in seq chunks of this many
    # tokens (0 = off).  Kills the (B, S, V) logits transient.
    loss_chunk: int = 0
    # training
    remat: str = "full"              # none | dots | full
    grad_accum: int = 1
    # serving
    kv_block_size: int = 64          # paged KV cache block size (tokens)
    # citation provenance
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def pattern_for_layers(self) -> Tuple[str, ...]:
        """Full per-layer block kinds (len == n_layers)."""
        unit = self.block_pattern
        out = tuple(unit[i % len(unit)] for i in range(self.n_layers))
        return out

    @property
    def has_attention(self) -> bool:
        return (any(k in (ATTN, ATTN_MOE) for k in self.pattern_for_layers())
                or self.shared_attn_every > 0)

    @property
    def attention_free(self) -> bool:
        return not self.has_attention

    @property
    def subquadratic(self) -> bool:
        """True if sequence mixing is sub-quadratic (SSM / linear recurrent),
        allowing the long_500k shape."""
        kinds = set(self.pattern_for_layers())
        return kinds <= {MAMBA2, MLSTM, SLSTM} or (
            kinds <= {MAMBA2, MLSTM, SLSTM, ATTN} and self.shared_attn_every > 0
            and ATTN not in kinds)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- analytic parameter / FLOP accounting (for roofline MODEL_FLOPS) ----
    def param_count(self) -> int:
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        hd, nh, nkv = self.hd, self.n_heads, self.n_kv_heads
        total = V * d  # embed
        if not self.tie_embeddings:
            total += V * d
        attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
        if self.qkv_bias:
            attn += (nh + 2 * nkv) * hd
        mlp = (3 if self.mlp_kind == "swiglu" else 2) * d * ff
        moe = self.n_experts * (3 * d * ff) + d * self.n_experts if self.is_moe else 0
        di = self.ssm_expand * d
        nh_ssm = max(di // self.ssm_head_dim, 1)
        mamba = (d * (2 * di + 2 * self.ssm_state + nh_ssm)  # in_proj(z,x)+B,C+dt
                 + self.ssm_conv * (di + 2 * self.ssm_state) + di * d + 2 * nh_ssm)
        for kind in self.pattern_for_layers():
            total += 2 * d  # norms
            if kind == ATTN:
                total += attn + mlp
            elif kind == ATTN_MOE:
                total += attn + moe
            elif kind == MAMBA2:
                total += mamba
            elif kind == MLSTM:
                di_m = 2 * d  # up-projection factor 2
                # in: d->2*di (x and gate z); qkv: 3 projections di->di; out di->d
                total += d * 2 * di_m + 3 * di_m * di_m + di_m * d
            elif kind == SLSTM:
                # 4 gates d->d recurrent cell + FFN with pf=4/3 (up+down)
                total += 4 * d * d + 2 * d * int(4 * d / 3)
        if self.shared_attn_every > 0:
            total += attn + mlp  # one shared block
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if not self.is_moe:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        dead = self.n_experts * 3 * d * ff - self.top_k * 3 * d * ff
        n_moe_layers = sum(1 for k in self.pattern_for_layers() if k == ATTN_MOE)
        return int(self.param_count() - dead * n_moe_layers)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# the architectures this port runs: the JAX package's ARCH_IDS in its order,
# without zamba2_1p2b and xlstm_125m (ROADMAP Queue 1 items 9.3 and 9.4)
ARCH_IDS = [
    "smollm_135m", "deepseek_7b", "qwen2_72b", "qwen3_8b", "musicgen_medium",
    "chameleon_34b", "olmoe_1b_7b", "dbrx_132b",
]


def get(name: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(
        f"repro_torch.configs.{name.replace('-', '_')}")
    return mod.SMOKE if smoke else mod.CONFIG
