"""RecurrentGemma-2B — RG-LRU + local attention hybrid, 1 attn : 2 recurrent
[arXiv:2402.19427; hf].  26L d2560, 10 heads (MQA kv=1, head_dim 256),
GeGLU d_ff 7680, vocab 256k, window 2048, logits soft-capped at 30."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab_size=256000,
    activation="geglu", norm="rmsnorm",
    tie_embeddings=True, embed_scale=True, logit_softcap=30.0,
    mixer_pattern=("rglru", "rglru", "local"),
    local_window=2048, lru_width=2560, conv_width=4,
    rope_theta=10000.0,
    notes="Griffin layout; sub-quadratic (runs long_500k).",
)
