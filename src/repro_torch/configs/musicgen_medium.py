"""MusicGen-medium backbone — decoder-only over EnCodec tokens
[arXiv:2306.05284; hf].  Modality frontend is a STUB: input_specs() supplies
precomputed frame embeddings (B, S, d_model); the LM head predicts the 2048
EnCodec codewords."""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="musicgen_medium", family="audio", n_layers=48, d_model=1536,
    n_heads=24, n_kv_heads=24, d_ff=6144, vocab_size=2048, head_dim=64,
    mlp_kind="gelu", input_kind="embeds", block_pattern=(ATTN,),
    tie_embeddings=False, source="arXiv:2306.05284",
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                       head_dim=16, d_ff=128, vocab_size=64)
