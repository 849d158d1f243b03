"""SmolLM-135M — llama-arch small dense LM [hf:HuggingFaceTB/SmolLM-135M; hf]."""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="smollm_135m", family="dense", n_layers=30, d_model=576, n_heads=9,
    n_kv_heads=3, d_ff=1536, vocab_size=49152, head_dim=64,
    block_pattern=(ATTN,), tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M",
)

SMOKE = CONFIG.replace(n_layers=2, d_model=48, n_heads=3, n_kv_heads=3,
                       head_dim=16, d_ff=96, vocab_size=128)
