"""Architecture + shape configuration system (PyTorch dtypes).

The port's copy of the reference's configuration module: every assigned
architecture is a frozen ``ArchConfig`` in its own module
(``repro_torch/configs/<id>.py``) registered under its public id;
``--arch <id>`` resolves through ``get_arch()``.  ``reduced()`` derives the
CPU smoke-test variant (same family/topology, tiny dims).  ``ShapeConfig``
captures the four assigned input-shape suites.  The fields, the derived
block pattern and ``reduced()`` are the reference's; only the dtypes are
torch's.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

import torch

# block = (mixer, ffn); mixer in {attn, local, enc, mla, rglru, rwkv},
# ffn in {mlp, moe, cmix}
Block = Tuple[str, str]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    activation: str = "swiglu"    # swiglu | geglu | gelu
    norm: str = "rmsnorm"         # rmsnorm | layernorm | nonparam_ln
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    embed_scale: bool = False
    logit_softcap: Optional[float] = None
    encoder_only: bool = False
    # hybrid / ssm
    mixer_pattern: Optional[Tuple[str, ...]] = None   # per-layer mixer override
    local_window: int = 2048
    lru_width: Optional[int] = None
    conv_width: int = 4
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0
    capacity_factor: float = 1.25
    # MLA
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # modality frontend stubs ([audio]/[vlm]: precomputed embeddings)
    frontend: Optional[str] = None        # None | "patch" | "frame"
    frontend_dim: int = 0
    patch_frac: int = 16                  # 1/16 of seq are patches (vlm)
    # numerics / execution
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    remat: str = "full"           # none | full | dots (models.model.forward)
    max_position: int = 32768
    notes: str = ""

    # ---- derived ----
    def blocks(self) -> Tuple[Block, ...]:
        out = []
        for i in range(self.n_layers):
            if self.mixer_pattern is not None:
                mixer = self.mixer_pattern[i % len(self.mixer_pattern)]
            elif self.encoder_only:
                mixer = "enc"
            elif self.kv_lora_rank > 0:
                mixer = "mla"
            else:
                mixer = "attn"
            if mixer == "rwkv":
                ffn = "cmix"
            elif self.n_experts > 0 and i >= self.first_k_dense:
                ffn = "moe"
            else:
                ffn = "mlp"
            out.append((mixer, ffn))
        return tuple(out)

    def sub_quadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def has_decode(self) -> bool:
        return not self.encoder_only

    def dense_ffn_dim(self) -> int:
        return self.d_ff

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        pat = self.mixer_pattern
        n_layers = max(2, len(pat) if pat else 2)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=n_layers,
            d_model=64,
            n_heads=4, n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads > 1 else 1,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            n_experts=min(self.n_experts, 8),
            n_shared_experts=min(self.n_shared_experts, 1),
            moe_top_k=min(self.moe_top_k, 2),
            moe_d_ff=32 if self.moe_d_ff else 0,
            first_k_dense=min(self.first_k_dense, 1),
            q_lora_rank=24 if self.q_lora_rank else 0,
            kv_lora_rank=16 if self.kv_lora_rank else 0,
            qk_nope_head_dim=8 if self.qk_nope_head_dim else 0,
            qk_rope_head_dim=8 if self.qk_rope_head_dim else 0,
            v_head_dim=8 if self.v_head_dim else 0,
            lru_width=64 if self.lru_width else None,
            local_window=16,
            frontend_dim=32 if self.frontend_dim else 0,
            param_dtype=torch.float32,
            compute_dtype=torch.float32,
            remat="none",
            max_position=128,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = (
    "recurrentgemma_2b", "pixtral_12b", "smollm_360m", "gemma_7b",
    "granite_20b", "olmo_1b", "hubert_xlarge", "deepseek_v2_236b",
    "deepseek_moe_16b", "rwkv6_1b6",
)

_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}
_ALIASES["rwkv6-1.6b"] = "rwkv6_1b6"


def get_arch(name: str) -> ArchConfig:
    key = _ALIASES.get(name, name).replace("-", "_")
    if key not in ARCH_IDS:
        raise KeyError(f"unknown architecture {name!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{key}")
    return mod.CONFIG


def cell_is_runnable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch x shape) cell runs, else the documented skip reason."""
    if shape.kind == "decode" and not arch.has_decode():
        return False, "encoder-only: no decode step"
    if shape.name == "long_500k" and not arch.sub_quadratic():
        return False, "pure full-attention arch: 500k needs sub-quadratic attention"
    return True, ""
