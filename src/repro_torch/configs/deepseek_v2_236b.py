"""DeepSeek-V2 236B — MLA (kv_lora 512) + fine-grained MoE
[arXiv:2405.04434; hf].  60L d5120, 128 heads, 2 shared + 160 routed
experts top-6 (d_ff 1536 each), first layer dense (d_ff 12288), vocab 102400."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, head_dim=192,
    d_ff=12288, vocab_size=102400,
    activation="swiglu", norm="rmsnorm",
    n_experts=160, n_shared_experts=2, moe_top_k=6, moe_d_ff=1536,
    first_k_dense=1,
    q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    notes="MLA absorbed decode against compressed (512+64)-dim cache.",
)
