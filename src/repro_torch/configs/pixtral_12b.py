"""Pixtral-12B — Pixtral-ViT frontend (STUB: precomputed patch embeddings)
on a Mistral-Nemo-style decoder [hf:mistralai/Pixtral-12B-2409; unverified].
40L d5120, 32H (GQA kv=8, head_dim 128), SwiGLU d_ff 14336, vocab 131072."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=131072,
    activation="swiglu", norm="rmsnorm", rope_theta=1e6,
    frontend="patch", frontend_dim=1024, patch_frac=16,
    notes="backbone-only per brief; 1/16 of seq are patch positions.",
)
