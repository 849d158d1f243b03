"""OLMoE-1B-7B — 64-expert top-8 MoE [arXiv:2409.02060; hf]."""
from repro_torch.configs.base import ATTN_MOE, ModelConfig

CONFIG = ModelConfig(
    name="olmoe_1b_7b", family="moe", n_layers=16, d_model=2048, n_heads=16,
    n_kv_heads=16, d_ff=1024, vocab_size=50304, head_dim=128,
    n_experts=64, top_k=8, block_pattern=(ATTN_MOE,), tie_embeddings=False,
    qk_norm=True, source="arXiv:2409.02060",
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                       head_dim=16, d_ff=64, vocab_size=128, n_experts=8,
                       top_k=2)
