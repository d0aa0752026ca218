"""Granite-20B (code) — llama-arch per assignment [arXiv:2405.04324; hf].
52L d6144, 48H (MQA kv=1, head_dim 128), SwiGLU d_ff 24576, vocab 49152."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1, head_dim=128,
    d_ff=24576, vocab_size=49152,
    activation="swiglu", norm="rmsnorm",
    notes="MQA: kv replicated across model axis; tiny decode cache.",
)
