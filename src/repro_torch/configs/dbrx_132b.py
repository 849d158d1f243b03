"""DBRX-132B — 16-expert top-4 fine-grained MoE [hf:databricks/dbrx-base;
unverified]."""
from repro_torch.configs.base import ATTN_MOE, ModelConfig

CONFIG = ModelConfig(
    name="dbrx_132b", family="moe", n_layers=40, d_model=6144, n_heads=48,
    n_kv_heads=8, d_ff=10752, vocab_size=100352, head_dim=128,
    n_experts=16, top_k=4, block_pattern=(ATTN_MOE,), tie_embeddings=False,
    grad_accum=8,  # 33.9 -> 16.2 GiB/dev (EXPERIMENTS.md §Dry-run)
    rope_theta=5e5, source="hf:databricks/dbrx-base",
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                       head_dim=16, d_ff=64, vocab_size=128, n_experts=4,
                       top_k=2)
