"""Architecture configuration (PyTorch dtypes).

The port's copy of the reference's configuration module, cut to what the
ported model code reads: every architecture is a frozen ``ArchConfig`` in
its own module (``repro_torch/configs/<id>.py``) registered under its public
id; ``--arch <id>`` resolves through ``get_arch()``.  ``reduced()`` derives
the CPU smoke-test variant (same topology, tiny dims).

Only the families whose model code is ported have a configuration module
here: RecurrentGemma (rglru + local attention + GeGLU MLP).  The other
architecture ids are listed so their names resolve, and ``get_arch`` raises
for them until their mixers are ported (ROADMAP Q9c); their fields (MoE,
MLA, frontends) come with them.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

import torch

# block = (mixer, ffn); mixer in {attn, local, enc, rglru}, ffn is mlp (the
# reference's mla, rwkv, moe and cmix come with ROADMAP Q9c)
Block = Tuple[str, str]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
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
    # hybrid
    mixer_pattern: Optional[Tuple[str, ...]] = None   # per-layer mixer override
    local_window: int = 2048
    lru_width: Optional[int] = None
    conv_width: int = 4
    # numerics
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16

    # ---- derived ----
    def blocks(self) -> Tuple[Block, ...]:
        out = []
        for i in range(self.n_layers):
            if self.mixer_pattern is not None:
                mixer = self.mixer_pattern[i % len(self.mixer_pattern)]
            elif self.encoder_only:
                mixer = "enc"
            else:
                mixer = "attn"
            out.append((mixer, "mlp"))
        return tuple(out)

    def has_decode(self) -> bool:
        return not self.encoder_only

    def reduced(self) -> "ArchConfig":
        """Tiny same-topology variant for CPU smoke tests."""
        pat = self.mixer_pattern
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=max(2, len(pat) if pat else 2),
            d_model=64,
            n_heads=4, n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads > 1 else 1,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            lru_width=64 if self.lru_width else None,
            local_window=16,
            param_dtype=torch.float32,
            compute_dtype=torch.float32,
        )


ARCH_IDS = (
    "recurrentgemma_2b", "pixtral_12b", "smollm_360m", "gemma_7b",
    "granite_20b", "olmo_1b", "hubert_xlarge", "deepseek_v2_236b",
    "deepseek_moe_16b", "rwkv6_1b6",
)
#: ids whose configuration and model code are ported
PORTED_ARCH_IDS = ("recurrentgemma_2b",)

_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}
_ALIASES["rwkv6-1.6b"] = "rwkv6_1b6"


def get_arch(name: str) -> ArchConfig:
    key = _ALIASES.get(name, name).replace("-", "_")
    if key not in ARCH_IDS:
        raise KeyError(f"unknown architecture {name!r}; known: {ARCH_IDS}")
    if key not in PORTED_ARCH_IDS:
        raise NotImplementedError(
            f"{key} is not ported yet: its families (MLA, MoE, RWKV6, dense "
            f"attention stacks, the modality frontends) come with ROADMAP "
            f"Q9c; ported: {PORTED_ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{key}")
    return mod.CONFIG

