"""Gemma-7B — GeGLU, head_dim 256 [arXiv:2403.08295; hf].
28L d3072, 16H (kv=16, head_dim 256), GeGLU d_ff 24576, vocab 256k."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, vocab_size=256000,
    activation="geglu", norm="rmsnorm",
    tie_embeddings=True, embed_scale=True,
)
