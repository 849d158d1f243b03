"""Qwen3-8B — qk-norm + GQA dense LM [hf:Qwen/Qwen3-8B; hf]."""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="qwen3_8b", family="dense", n_layers=36, d_model=4096, n_heads=32,
    n_kv_heads=8, d_ff=12288, vocab_size=151936, head_dim=128, qk_norm=True,
    block_pattern=(ATTN,), tie_embeddings=False, rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B",
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                       head_dim=16, d_ff=160, vocab_size=128)
