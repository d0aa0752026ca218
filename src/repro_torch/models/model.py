"""Model assembly: block-pattern decomposition, forward, loss, decode.

The port of the reference's ``models/model.py``.  Parameters are an
``nn.Module`` tree (``LM``) that keeps the reference's names and layouts,
one ``LayerBlock`` per layer in layer order; the math stays in plain
functions on tensors.  The reference scans a repeated unit of blocks with
stacked parameters (``decompose``) to keep its compiled program small;
PyTorch runs eagerly, so the port loops over the layers, and uses
``decompose`` to map the reference's stacked tree onto its layers
(``models/convert.py``) and to find the unit that activation
checkpointing (``cfg.remat``) wraps, the unit the reference's scan
checkpoints.

Ported mixers: ``attn``, ``local``, ``enc`` and ``rglru``, with the ``mlp``
ffn; ``configs.get_arch`` raises ``NotImplementedError`` for the
architectures that need the others until ROADMAP Q9c brings them.
``forward`` is differentiable: both kernels have a backward kernel on the
card.  A caller that wants no gradient (a prefill, serving) runs it under
``torch.inference_mode()``; parameters are frozen until a trainer asks for
gradients (``train.step.init_train_state``).  ``decode_step`` runs under
``torch.inference_mode()`` itself.  ``forward`` returns the logits alone:
the reference's second output, the MoE auxiliary loss, is 0 for every
ported block and comes back with MoE; ``loss_fn`` reports it as a zero
tensor.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ArchConfig, Block
from repro_torch.launch.mesh import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import rglru as rglru_mod
from repro_torch.models.common import (MLP, Embed, Norm, apply_mlp,
                                       apply_norm, dense_init, embed_tokens,
                                       lm_logits)

ATTN_MIXERS = ("attn", "local", "enc")
AUX_COEF = 0.01


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Q9c: the MLA, MoE and RWKV6 "
        f"families and the modality frontends)")


# ---------------------------------------------------------------------------
# pattern decomposition
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Layout:
    prefix: Tuple[Block, ...]
    unit: Tuple[Block, ...]
    reps: int
    suffix: Tuple[Block, ...]


def decompose(blocks: Tuple[Block, ...]) -> Layout:
    best = None
    n = len(blocks)
    for pre in range(0, min(4, n) + 1):
        for ul in range(1, min(4, n - pre) + 1):
            unit = blocks[pre:pre + ul]
            reps = 0
            i = pre
            while i + ul <= n and blocks[i:i + ul] == unit:
                reps += 1
                i += ul
            suffix = blocks[i:]
            if reps < 1 or len(suffix) > 4:
                continue
            score = (pre + len(suffix), ul)
            if best is None or score < best[0]:
                best = (score, Layout(blocks[:pre], unit, reps, suffix))
    assert best is not None, "pattern not decomposable"
    return best[1]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

class LayerBlock(nn.Module):
    """One pre-LN residual block: norm1, mixer, norm2, ffn."""

    def __init__(self, cfg, block: Block, generator, device):
        super().__init__()
        mixer, _ = block
        self.norm1 = Norm(cfg, device)
        if mixer in ATTN_MIXERS:
            self.mixer = attn.Attention(cfg, generator, device)
        elif mixer == "rglru":
            self.mixer = rglru_mod.RGLRU(cfg, generator, device)
        else:
            raise _not_ported(f"mixer {mixer!r}")
        self.norm2 = Norm(cfg, device)
        self.ffn = MLP(cfg, cfg.d_ff, generator, device)


class LM(nn.Module):
    """The whole model's parameters: ``embed.table [V, d]``, ``blocks`` in
    layer order, ``out_norm`` and, untied, ``head.w_out [d, V]``."""

    def __init__(self, cfg: ArchConfig, generator, device):
        super().__init__()
        self.embed = Embed(cfg, generator, device)
        self.blocks = nn.ModuleList(
            [LayerBlock(cfg, b, generator, device) for b in cfg.blocks()])
        self.out_norm = Norm(cfg, device)
        if not cfg.tie_embeddings:
            self.head = nn.Module()
            self.head.w_out = dense_init(cfg.d_model, cfg.vocab_size,
                                         generator, device, cfg.param_dtype)
        else:
            self.head = None

    @property
    def device(self) -> torch.device:
        return self.embed.table.device


def init_params(cfg: ArchConfig, device=None,
                generator: Optional[torch.Generator] = None,
                seed: int = 0) -> LM:
    """Random parameters on ``device`` (``None`` = CUDA, which raises where
    there is none), drawn from ``generator`` (default: a generator on that
    device seeded with ``seed``).  The distributions are the reference's;
    the numbers are not — torch and JAX generators differ.  To compute the
    reference's function, convert its parameters
    (``models.convert.params_from_reference``)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    return LM(cfg, generator, dev)


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def apply_block(x, p: LayerBlock, cfg, block: Block):
    """Pre-LN residual block (prefill)."""
    mixer, _ = block
    h = apply_norm(x, p.norm1, cfg)
    if mixer == "rglru":
        h, _ = rglru_mod.rglru_forward(h, p.mixer, cfg)
    else:
        h, _ = attn.attention_forward(h, p.mixer, cfg, mixer)
    x = x + h
    h = apply_norm(x, p.norm2, cfg)
    h = apply_mlp(h, p.ffn, cfg)
    return x + h


def _saves_2d_products(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the outputs of plain 2-D matrix products (the
    projections, whose batch and sequence axes fold into rows) and recompute
    everything else — the counterpart of JAX's
    ``dots_with_no_batch_dims_saveable``."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ArchConfig):
    """``fn`` under ``cfg.remat``: ``none`` as it is, ``full`` checkpointed
    (its activations dropped and recomputed in the backward), ``dots``
    checkpointed but for the matrix products' outputs.  Non-reentrant, as
    ``jax.checkpoint`` is."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    if cfg.remat == "dots":
        ctx_fn = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                   _saves_2d_products)
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False,
                                 context_fn=ctx_fn)
    raise ValueError(f"remat must be none, full or dots, got {cfg.remat!r}")


def forward(params: LM, batch: Dict[str, torch.Tensor], cfg: ArchConfig):
    """Returns logits [B,S,V] float32.

    The layers of each repetition of ``decompose(cfg.blocks())``'s unit run
    as one checkpointed call under ``cfg.remat``, as the reference's scan
    body does; the prefix and suffix layers run plain, as in the
    reference.  Checkpointing only acts where autograd records a graph."""
    layout = decompose(cfg.blocks())
    blocks = list(zip(params.blocks, cfg.blocks()))
    n_pre, n_unit = len(layout.prefix), len(layout.unit)
    n_body = n_unit * layout.reps

    def run(x, *layers):
        for p, b in layers:
            x = apply_block(x, p, cfg, b)
        return x

    x = embed_tokens(batch["tokens"], params.embed, cfg)
    x = run(x, *blocks[:n_pre])
    unit = _remat(run, cfg) if torch.is_grad_enabled() else run
    for r in range(layout.reps):
        x = unit(x, *blocks[n_pre + r * n_unit:n_pre + (r + 1) * n_unit])
    x = run(x, *blocks[n_pre + n_body:])
    x = apply_norm(x, params.out_norm, cfg)
    return lm_logits(x, params.embed, params.head, cfg)


def loss_fn(params: LM, batch: Dict[str, torch.Tensor], cfg: ArchConfig):
    """Mean next-token cross-entropy over labels >= 0 (others are masked),
    the reference's ``loss_fn``: returns ``(total, {"loss", "aux"})`` with
    ``total = loss + AUX_COEF * aux``; ``aux``, the MoE auxiliary loss, is a
    float32 zero for the ported blocks."""
    logits = forward(params, batch, cfg)
    labels = batch["labels"]
    if not cfg.encoder_only:   # next-token prediction
        logits = logits[:, :-1]
        labels = labels[:, 1:]
    valid = labels >= 0
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          labels.clamp(min=0).reshape(-1).long(),
                          reduction="none").view(labels.shape)
    nll = torch.where(valid, nll, torch.zeros((), device=nll.device))
    loss = nll.sum() / valid.sum().clamp(min=1)
    aux = torch.zeros((), dtype=torch.float32, device=loss.device)
    return loss + AUX_COEF * aux, {"loss": loss, "aux": aux}


# ---------------------------------------------------------------------------
# decode (serve_step)
# ---------------------------------------------------------------------------

def init_block_cache(cfg, block: Block, batch: int, length: int, device):
    mixer, _ = block
    if mixer == "rglru":
        return {"rec": rglru_mod.init_rglru_cache(cfg, batch, device)}
    return {"kv": attn.init_kv_cache(cfg, batch, length, mixer, device)}


@torch.inference_mode()
def init_cache(cfg: ArchConfig, batch: int, length: int,
               device=None) -> List[dict]:
    """One cache entry per layer, in layer order, on ``device`` (``None`` =
    CUDA)."""
    dev = resolve_device(device)
    return [init_block_cache(cfg, b, batch, length, dev)
            for b in cfg.blocks()]


def apply_block_decode(x, p: LayerBlock, cfg, block: Block, cache, pos):
    mixer, _ = block
    h = apply_norm(x, p.norm1, cfg)
    if mixer in ("attn", "local"):
        h, kv = attn.attention_decode(h, p.mixer, cfg, cache["kv"], pos,
                                      mixer)
        new_cache = {"kv": kv}
    elif mixer == "rglru":
        h, rec = rglru_mod.rglru_decode(h, p.mixer, cfg, cache["rec"])
        new_cache = {"rec": rec}
    else:
        raise ValueError(f"no decode step for mixer {mixer!r}")
    x = x + h
    h = apply_norm(x, p.norm2, cfg)
    h = apply_mlp(h, p.ffn, cfg)
    return x + h, new_cache


@torch.inference_mode()
def decode_step(params: LM, cache: List[dict], tokens, pos: int,
                cfg: ArchConfig):
    """tokens [B,1]; pos a Python int.  Returns (logits [B,1,V], cache).

    Attention caches are updated in place (see ``attention_decode``); the
    returned list holds every layer's current cache."""
    x = embed_tokens(tokens, params.embed, cfg)
    new_cache = []
    for p, b, c in zip(params.blocks, cfg.blocks(), cache):
        x, c = apply_block_decode(x, p, cfg, b, c, pos)
        new_cache.append(c)
    x = apply_norm(x, params.out_norm, cfg)
    return lm_logits(x, params.embed, params.head, cfg), new_cache


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------

def make_dummy_batch(cfg: ArchConfig, batch: int, seq: int,
                     generator: torch.Generator, device=None):
    """Token inputs and labels, uniform over the vocab (int64)."""
    dev = resolve_device(device)
    draw = [torch.randint(0, cfg.vocab_size, (batch, seq),
                          generator=generator, device=generator.device)
            .to(dev) for _ in range(2)]
    return {"tokens": draw[0], "labels": draw[1]}
