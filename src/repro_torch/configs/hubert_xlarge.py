"""HuBERT-XLarge — encoder-only audio transformer [arXiv:2106.07447;
unverified].  48L d1280, 16H (head_dim 80), GELU d_ff 5120, 504 targets.
Frontend is a STUB: input_specs() provides precomputed frame embeddings."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
    d_ff=5120, vocab_size=504,
    activation="gelu", norm="layernorm", encoder_only=True,
    frontend="frame", frontend_dim=512,
    notes="no decode step (decode_32k/long_500k skipped).",
)
