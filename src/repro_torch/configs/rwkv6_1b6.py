"""RWKV-6 "Finch" 1.6B — attention-free, data-dependent decay
[arXiv:2404.05892; unverified].  24L d2048 (32 heads of 64),
channel-mix d_ff 7168, vocab 65536."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=7168, vocab_size=65536,
    activation="swiglu", norm="layernorm",
    mixer_pattern=("rwkv",),
    notes="O(1) recurrent state; runs long_500k.",
)
