"""Qwen2-72B — GQA + QKV bias dense LM [arXiv:2407.10671; hf]."""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="qwen2_72b", family="dense", n_layers=80, d_model=8192, n_heads=64,
    n_kv_heads=8, d_ff=29568, vocab_size=152064, head_dim=128, qkv_bias=True,
    grad_accum=4,  # fits 16GiB HBM (see EXPERIMENTS.md §Perf)
    block_pattern=(ATTN,), tie_embeddings=False, rope_theta=1e6,
    source="arXiv:2407.10671",
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                       head_dim=16, d_ff=160, vocab_size=128)
