"""DeepSeek-7B — llama-arch dense LM [arXiv:2401.02954; hf]."""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="deepseek_7b", family="dense", n_layers=30, d_model=4096, n_heads=32,
    n_kv_heads=32, d_ff=11008, vocab_size=102400, head_dim=128,
    block_pattern=(ATTN,), tie_embeddings=False,
    source="arXiv:2401.02954",
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                       head_dim=16, d_ff=160, vocab_size=128)
