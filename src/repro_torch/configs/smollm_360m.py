"""SmolLM-360M — llama-arch small [hf:HuggingFaceTB/SmolLM; hf].
32L d960, 15H (GQA kv=5, head_dim 64), SwiGLU d_ff 2560, vocab 49152."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, head_dim=64,
    d_ff=2560, vocab_size=49152,
    activation="swiglu", norm="rmsnorm", tie_embeddings=True,
    notes="15 heads not divisible by 16-way model axis -> heads replicated, "
          "TP via d_ff/vocab (sharding rules fall back automatically).",
)
