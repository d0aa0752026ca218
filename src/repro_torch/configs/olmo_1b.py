"""OLMo-1B — non-parametric LayerNorm [arXiv:2402.00838; hf].
16L d2048, 16H (kv=16, head_dim 128), SwiGLU d_ff 8192, vocab 50304."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=8192, vocab_size=50304,
    activation="swiglu", norm="nonparam_ln", tie_embeddings=True,
)
