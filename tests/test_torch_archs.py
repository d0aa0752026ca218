"""The dense attention stacks and the modality frontends of the port
against the JAX package on the CPU, at ``reduced()`` in float32: Pixtral-12B
(GQA, the ``patch`` frontend), SmolLM-360M (GQA), Gemma-7B (GeGLU, tied and
scaled embeddings), Granite-20B (MQA), OLMo-1B (non-parametric LayerNorm)
and HuBERT-XLarge (encoder-only, the ``frame`` frontend).  Each: forward's
logits and aux, ``loss_fn`` and every gradient leaf at S 32 and again at
S 1 024, where attention takes the plain flash path, and decode step by
step (Pixtral prefilling its patches through ``embeds=``).  HuBERT runs with
``max_position`` 1 024 on both sides, so that its learned positions cover
S 1 024.  Tolerances are
stated in ``tests/_torch_arch_check.py``.
"""
import pytest

from _torch_arch_check import (check_decode, check_forward,
                               check_loss_and_grads, pair)
from _torch_fixtures import one_torch_thread  # noqa: F401
from repro_torch.kernels.flash_attention import ops as flash_ops

ARCHS = ["pixtral_12b", "smollm_360m", "gemma_7b", "granite_20b", "olmo_1b",
         "hubert_xlarge"]
DECODERS = [a for a in ARCHS if a != "hubert_xlarge"]   # encoder-only

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _pair(arch):
    # HuBERT's learned positions (max_position 128 at reduced()) must
    # cover S 1 024 on both sides
    if arch == "hubert_xlarge":
        return pair(arch, max_position=1024)
    return pair(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_reference(arch):
    pr = _pair(arch)
    logits, aux = check_forward(pr, 2, 32)
    assert float(aux) == 0.0 and flash_ops.PATH_COUNTS["ref"] == 0
    if pr.cfg.frontend == "patch":      # logits over the text only
        assert logits.shape[1] == 32 - 32 // pr.cfg.patch_frac
    check_loss_and_grads(pr, 2, 32)


@pytest.mark.parametrize("arch", ARCHS)
def test_flash_path_matches_reference(arch):
    """S 1 024: every attention layer takes the plain flash version."""
    pr = _pair(arch)
    check_forward(pr, 1, 1024)
    assert flash_ops.PATH_COUNTS["ref"] == pr.cfg.n_layers
    check_loss_and_grads(pr, 1, 1024)


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_matches_reference(arch):
    check_decode(_pair(arch), 20)
