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

Every mixer of the reference (``attn``, ``local``, ``enc``, ``mla``,
``rglru``, ``rwkv``) and every ffn (``mlp``, ``moe``, ``cmix``), and both
modality frontends: ``patch`` (precomputed patch embeddings projected and
put before the text, logits over the text positions only) and ``frame``
(precomputed frame embeddings projected, plus a learned position
embedding; encoder-only, no decode step).  ``forward`` returns ``(logits,
aux)``, aux the MoE layers' summed auxiliary loss (float32; 0 without
MoE), and is differentiable: both LM kernels have a backward kernel on the
card.  A caller that wants no gradient (a prefill, serving) runs it under
``torch.inference_mode()``; parameters are frozen until a trainer asks for
gradients (``train.step.init_train_state``).  ``decode_step`` runs under
``torch.inference_mode()`` itself.
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
from repro_torch.distributed import perf_options
from repro_torch.launch import op_analysis
from repro_torch.launch.mesh import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.common import (MLP, Embed, Norm, apply_mlp,
                                       apply_norm, dense_init, embed_tokens,
                                       lm_logits, normal)

ATTN_MIXERS = ("attn", "local", "enc")
AUX_COEF = 0.01


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
        mixer, ffn = block
        self.norm1 = Norm(cfg, device)
        if mixer in ATTN_MIXERS:
            self.mixer = attn.Attention(cfg, generator, device)
        elif mixer == "mla":
            self.mixer = mla_mod.MLA(cfg, generator, device)
        elif mixer == "rglru":
            self.mixer = rglru_mod.RGLRU(cfg, generator, device)
        elif mixer == "rwkv":
            self.mixer = rwkv_mod.RWKVTimeMix(cfg, generator, device)
        else:
            raise ValueError(mixer)
        self.norm2 = Norm(cfg, device)
        if ffn == "mlp":
            self.ffn = MLP(cfg, cfg.d_ff, generator, device)
        elif ffn == "moe":
            self.ffn = moe_mod.MoE(cfg, generator, device)
        elif ffn == "cmix":
            self.ffn = rwkv_mod.RWKVChannelMix(cfg, generator, device)
        else:
            raise ValueError(ffn)


class LM(nn.Module):
    """The whole model's parameters: ``embed.table [V, d]`` (not with the
    ``frame`` frontend), ``frontend_proj.w [frontend_dim, d]`` (with either
    frontend), ``pos_embed [max_position, d]`` (``frame``), ``blocks`` in
    layer order, ``out_norm`` and, untied, ``head.w_out [d, V]``."""

    def __init__(self, cfg: ArchConfig, generator, device):
        super().__init__()
        self.embed = (Embed(cfg, generator, device)
                      if cfg.frontend in (None, "patch") else None)
        if cfg.frontend is not None:
            self.frontend_proj = nn.Module()
            self.frontend_proj.w = dense_init(cfg.frontend_dim, cfg.d_model,
                                              generator, device,
                                              cfg.param_dtype)
        if cfg.frontend == "frame":
            self.pos_embed = normal((cfg.max_position, cfg.d_model),
                                    generator, device, cfg.param_dtype, 0.02)
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
        return next(self.parameters()).device


def init_params(cfg: ArchConfig, device=None,
                generator: Optional[torch.Generator] = None,
                seed: int = 0) -> LM:
    """Random parameters on ``device`` (``None`` = CUDA, which raises where
    there is none), drawn from ``generator`` (default: a generator on that
    device seeded with ``seed``).  The distributions are the reference's;
    the numbers are not — torch and JAX generators differ.  To compute the
    reference's function, convert its parameters
    (``models.convert.params_from_reference``).  ``device="meta"`` builds
    the shapes alone, allocating nothing (the dry-run's records)."""
    dev = resolve_device(device)
    if generator is None:
        # the meta device has no generator of its own (and draws nothing)
        gen_dev = "cpu" if dev.type == "meta" else dev
        generator = torch.Generator(device=gen_dev).manual_seed(seed)
    return LM(cfg, generator, dev)


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def apply_block(x, p: LayerBlock, cfg, block: Block, aux):
    """Pre-LN residual block (train/prefill).  Returns (x, aux)."""
    mixer, ffn = block
    h = apply_norm(x, p.norm1, cfg)
    if mixer in ATTN_MIXERS:
        h, _ = attn.attention_forward(h, p.mixer, cfg, mixer)
    elif mixer == "mla":
        h, _ = mla_mod.mla_forward(h, p.mixer, cfg)
    elif mixer == "rglru":
        h, _ = rglru_mod.rglru_forward(h, p.mixer, cfg)
    elif mixer == "rwkv":
        h, _ = rwkv_mod.rwkv_tmix(h, p.mixer, cfg)
    x = x + h
    h = apply_norm(x, p.norm2, cfg)
    if ffn == "mlp":
        h = apply_mlp(h, p.ffn, cfg)
    elif ffn == "moe":
        h, a = moe_mod.apply_moe(h, p.ffn, cfg)
        aux = aux + a
    elif ffn == "cmix":
        h, _ = rwkv_mod.rwkv_cmix(h, p.ffn, cfg)
    return x + h, aux


def _saves_2d_products(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the outputs of plain 2-D matrix products (the
    projections, whose batch and sequence axes fold into rows) and recompute
    everything else — the counterpart of JAX's
    ``dots_with_no_batch_dims_saveable``."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ArchConfig):
    """``fn`` under ``cfg.remat`` (``"dots"`` whenever ``perf_options
    ("remat_dots")`` is on, as in the reference): ``none`` as it is,
    ``full`` checkpointed (its activations dropped and recomputed in the
    backward), ``dots`` checkpointed but for the matrix products' outputs.
    Non-reentrant, as ``jax.checkpoint`` is."""
    remat = "dots" if perf_options.enabled("remat_dots") else cfg.remat
    if remat == "none":
        return fn
    if remat == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    if remat == "dots":
        ctx_fn = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                   _saves_2d_products)
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False,
                                 context_fn=ctx_fn)
    raise ValueError(f"remat must be none, full or dots, got {remat!r}")


def _embed_inputs(params: LM, batch, cfg):
    cd = cfg.compute_dtype
    if cfg.frontend == "frame":
        x = batch["frames"].to(cd) @ params.frontend_proj.w.to(cd)
        return x + params.pos_embed[:x.shape[1]].to(cd)[None]
    if cfg.frontend == "patch":
        px = batch["patches"].to(cd) @ params.frontend_proj.w.to(cd)
        tx = embed_tokens(batch["tokens"], params.embed, cfg)
        return torch.cat([px, tx], dim=1)
    return embed_tokens(batch["tokens"], params.embed, cfg)


def forward(params: LM, batch: Dict[str, torch.Tensor], cfg: ArchConfig):
    """Returns (logits [B,S,V] float32, aux float32 scalar); with the
    ``patch`` frontend the logits cover the text positions only.

    The layers of each repetition of ``decompose(cfg.blocks())``'s unit run
    as one checkpointed call under ``cfg.remat``, as the reference's scan
    body does; the prefix and suffix layers run plain, as in the
    reference.  Checkpointing only acts where autograd records a graph.
    On meta tensors (the dry-run) the repetitions are trip-counted, as the
    reference's scan is (``launch/op_analysis.py``)."""
    layout = decompose(cfg.blocks())
    blocks = list(zip(params.blocks, cfg.blocks()))
    n_pre, n_unit = len(layout.prefix), len(layout.unit)
    n_body = n_unit * layout.reps

    def run(x, aux, *layers):
        for p, b in layers:
            x, aux = apply_block(x, p, cfg, b, aux)
        return x, aux

    x = _embed_inputs(params, batch, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x, aux = run(x, aux, *blocks[:n_pre])
    unit = _remat(run, cfg) if torch.is_grad_enabled() else run
    for r in op_analysis.trips(layout.reps, x, "layers"):
        step = unit
        if x.is_meta and torch.is_grad_enabled():  # recompute as this trip
            step = _remat(op_analysis.replay_trips(run), cfg)
        x, aux = step(x, aux,
                      *blocks[n_pre + r * n_unit:n_pre + (r + 1) * n_unit])
    x, aux = run(x, aux, *blocks[n_pre + n_body:])
    x = apply_norm(x, params.out_norm, cfg)
    if cfg.frontend == "patch":     # logits only over text positions
        x = x[:, batch["patches"].shape[1]:]
    return lm_logits(x, params.embed, params.head, cfg), aux


def loss_fn(params: LM, batch: Dict[str, torch.Tensor], cfg: ArchConfig):
    """Mean next-token cross-entropy over labels >= 0 (others are masked;
    encoder-only: every position's own label), the reference's
    ``loss_fn``: returns ``(total, {"loss", "aux"})`` with
    ``total = loss + AUX_COEF * aux``."""
    logits, aux = forward(params, batch, cfg)
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
    return loss + AUX_COEF * aux, {"loss": loss, "aux": aux}


# ---------------------------------------------------------------------------
# decode (serve_step)
# ---------------------------------------------------------------------------

def init_block_cache(cfg, block: Block, batch: int, length: int, device):
    mixer, _ = block
    if mixer in ATTN_MIXERS:
        return {"kv": attn.init_kv_cache(cfg, batch, length, mixer, device)}
    if mixer == "mla":
        return {"kv": mla_mod.init_mla_cache(cfg, batch, length, device)}
    if mixer == "rglru":
        return {"rec": rglru_mod.init_rglru_cache(cfg, batch, device)}
    if mixer == "rwkv":
        return rwkv_mod.init_rwkv_cache(cfg, batch, device)
    raise ValueError(mixer)


@torch.inference_mode()
def init_cache(cfg: ArchConfig, batch: int, length: int,
               device=None) -> List[dict]:
    """One cache entry per layer, in layer order, on ``device`` (``None`` =
    CUDA)."""
    dev = resolve_device(device)
    return [init_block_cache(cfg, b, batch, length, dev)
            for b in cfg.blocks()]


def apply_block_decode(x, p: LayerBlock, cfg, block: Block, cache, pos):
    mixer, ffn = block
    h = apply_norm(x, p.norm1, cfg)
    if mixer in ("attn", "local"):
        h, kv = attn.attention_decode(h, p.mixer, cfg, cache["kv"], pos,
                                      mixer)
        new_cache = {"kv": kv}
    elif mixer == "mla":
        h, kv = mla_mod.mla_decode(h, p.mixer, cfg, cache["kv"], pos)
        new_cache = {"kv": kv}
    elif mixer == "rglru":
        h, rec = rglru_mod.rglru_decode(h, p.mixer, cfg, cache["rec"])
        new_cache = {"rec": rec}
    elif mixer == "rwkv":
        h, tmix = rwkv_mod.rwkv_tmix(h, p.mixer, cfg, state=cache["tmix"])
        new_cache = {"tmix": tmix}
    else:
        raise ValueError(f"no decode step for mixer {mixer!r}")
    x = x + h
    h = apply_norm(x, p.norm2, cfg)
    if ffn == "mlp":
        h = apply_mlp(h, p.ffn, cfg)
    elif ffn == "moe":
        h, _ = moe_mod.apply_moe(h, p.ffn, cfg)
    elif ffn == "cmix":
        h, cm = rwkv_mod.rwkv_cmix(h, p.ffn, cfg, state=cache["cmix"])
        new_cache["cmix"] = cm
    return x + h, new_cache


@torch.inference_mode()
def decode_step(params: LM, cache: List[dict], tokens, pos: int,
                cfg: ArchConfig, embeds=None):
    """tokens [B,1]; pos a Python int.  Returns (logits [B,1,V], cache).

    ``embeds`` [B,1,d_model] overrides the token embedding — how a VLM's
    patch positions are prefilled through the decode path (pixtral
    serving).  Attention caches are updated in place (see
    ``attention_decode``); the returned list holds every layer's current
    cache."""
    if cfg.frontend == "frame":
        raise ValueError("encoder-only archs have no decode step")
    if embeds is not None:
        x = embeds.to(cfg.compute_dtype)
    else:
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
    """Random inputs and labels of ``seq`` positions, drawn on the
    generator's device and moved to ``device``: token ids uniform over the
    vocab (int64); for the ``frame`` frontend, N(0, 1) float32 frames
    ``[B, S, frontend_dim]``; for ``patch``, ``seq // patch_frac`` (at
    least 1) N(0, 1) patches ahead of the text, tokens and labels over the
    rest."""
    dev = resolve_device(device)

    def ids(n):
        return torch.randint(0, cfg.vocab_size, (batch, n),
                             generator=generator,
                             device=generator.device).to(dev)

    def normal_(n):
        return torch.randn((batch, n, cfg.frontend_dim), generator=generator,
                           device=generator.device).to(dev)

    if cfg.frontend == "frame":
        return {"frames": normal_(seq), "labels": ids(seq)}
    if cfg.frontend == "patch":
        n_patch = max(1, seq // cfg.patch_frac)
        return {"patches": normal_(n_patch), "tokens": ids(seq - n_patch),
                "labels": ids(seq - n_patch)}
    return {"tokens": ids(seq), "labels": ids(seq)}
