"""Chameleon-34B backbone — early-fusion, VQ image tokens in a unified vocab
[arXiv:2405.09818; unverified].  Frontend is a STUB: VQ-tokenized inputs are
ordinary token ids inside the 65536 vocab; qk-norm per the paper."""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="chameleon_34b", family="vlm", n_layers=48, d_model=8192, n_heads=64,
    n_kv_heads=8, d_ff=22016, vocab_size=65536, head_dim=128, qk_norm=True,
    grad_accum=4,  # fits 16GiB HBM (see EXPERIMENTS.md §Perf)
    block_pattern=(ATTN,), tie_embeddings=False,
    source="arXiv:2405.09818",
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                       head_dim=16, d_ff=160, vocab_size=128)
