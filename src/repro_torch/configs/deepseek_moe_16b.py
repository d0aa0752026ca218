"""DeepSeekMoE-16B — 2 shared + 64 routed top-6 fine-grained experts
[arXiv:2401.06066; hf].  28L d2048, 16H (kv=16, head_dim 128),
routed d_ff 1408, first layer dense (d_ff 10944), vocab 102400."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=10944, vocab_size=102400,
    activation="swiglu", norm="rmsnorm",
    n_experts=64, n_shared_experts=2, moe_top_k=6, moe_d_ff=1408,
    first_k_dense=1,
)
