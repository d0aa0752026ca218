"""The port's spec trees (``distributed/sharding.py``) against the JAX
package's ``distributed/sharding.py``: every parameter and cache leaf of
all ten architectures covered exactly, each spec equal to the reference's
``PartitionSpec`` leaf by leaf through the port's names (the reference's
stacked ``body`` unstacked into layers, its leading reps axis dropped);
``sanitize`` and ``batch_specs`` as the reference's tests have them; and
the bytes a device of a mesh holds."""
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.distributed import sharding as jsh
from repro_torch.configs.base import ARCH_IDS, get_arch
from repro_torch.distributed import sharding as sh
from repro_torch.models import model as M

RULES = [((), "data"), (("pod",), "data"), ((), None)]


def _layer_path(cfg, li):
    """(section, key, stacked) of layer ``li`` in the reference's tree."""
    lay = M.decompose(cfg.blocks())
    n_pre, n_unit = len(lay.prefix), len(lay.unit)
    if li < n_pre:
        return "prefix", str(li), False
    if li < n_pre + n_unit * lay.reps:
        return "body", str((li - n_pre) % n_unit), True
    return "suffix", str(li - n_pre - n_unit * lay.reps), False


def _ref_leaf(tree, cfg, path):
    """The reference's spec at the port's dotted ``path``, as a tuple."""
    parts = path.split(".")
    stacked = False
    if parts[0] == "blocks":
        section, key, stacked = _layer_path(cfg, int(parts[1]))
        leaf, parts = tree[section][key], parts[2:]
    else:
        leaf = tree
    for part in parts:
        leaf = leaf[part]
    spec = tuple(leaf)
    if stacked:
        assert spec[0] is None
        spec = spec[1:]
    return spec


def _rules(pod, fsdp):
    return (sh.ShardingRules(dp=pod + ("data",), fsdp=fsdp),
            jsh.ShardingRules(dp=pod + ("data",), fsdp=fsdp))


@pytest.mark.parametrize("pod,fsdp", RULES, ids=["16x16", "2x16x16",
                                                "no_fsdp"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference(arch, pod, fsdp):
    cfg, jcfg = get_arch(arch), jax_get_arch(arch)
    rules, jrules = _rules(pod, fsdp)
    specs = sh.param_specs(cfg, rules)
    named = dict(M.init_params(cfg, "meta").named_parameters())
    assert set(specs) == set(named)
    ref = jsh.param_specs(jcfg, jrules)
    for name, p in named.items():
        assert specs[name] == _ref_leaf(ref, cfg, name), name
        assert len(specs[name]) == p.dim(), name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_reference(arch):
    cfg, jcfg = get_arch(arch), jax_get_arch(arch)
    rules, jrules = _rules(("pod",), "data")
    specs = sh.cache_specs(cfg, rules)
    cache = M.init_cache(cfg, 8, 128, "meta")
    ref = jsh.cache_specs(jcfg, jrules)
    assert len(specs) == len(cache)
    for li, (s, c) in enumerate(zip(specs, cache)):
        section, key, stacked = _layer_path(cfg, li)

        def walk(s, c, r, where):
            assert set(s) == set(c) == set(r), where
            for k in c:
                if isinstance(c[k], dict):
                    walk(s[k], c[k], r[k], f"{where}.{k}")
                    continue
                want = tuple(r[k])[1:] if stacked else tuple(r[k])
                assert s[k] == want, f"{where}.{k}"
                assert len(s[k]) == c[k].dim(), f"{where}.{k}"
        walk(s, c, ref[section][key], f"layer {li}")


def test_sanitize_non_divisible_falls_back():
    mesh = {"data": 2, "model": 16}
    # 15 heads on a 16-way model axis -> replicated
    assert sh.sanitize((None, "model", None), (960, 15, 64), mesh) == \
        (None, None, None)
    assert sh.sanitize(("data", "model"), (64, 32), mesh) == ("data", "model")
    assert sh.sanitize(("model", "model"), (32, 32), mesh) == ("model", None)
    assert sh.sanitize((("pod", "data"), None), (8, 4), mesh) == ("data", None)


def test_batch_specs_cover_all_modalities():
    rules, jrules = _rules(("pod",), "data")
    for arch in ("gemma_7b", "pixtral_12b", "hubert_xlarge"):
        cfg = get_arch(arch)
        specs = sh.batch_specs(cfg, rules)
        if cfg.frontend == "patch":
            assert set(specs) == {"patches", "tokens", "labels"}
        elif cfg.frontend == "frame":
            assert set(specs) == {"frames", "labels"}
        else:
            assert set(specs) == {"tokens", "labels"}
        ref = jsh.batch_specs(jax_get_arch(arch), jrules)
        assert specs == {k: tuple(v) for k, v in ref.items()}
    assert sh.opt_specs({"w": ("data",)}) == {"m": {"w": ("data",)},
                                              "v": {"w": ("data",)},
                                              "count": ()}


def test_bytes_per_device():
    mesh = {"data": 16, "model": 16}
    t = {"a": torch.empty(32, 64, dtype=torch.bfloat16, device="meta"),
         "b": [torch.empty(15, 64, device="meta"),
               torch.empty((), dtype=torch.int32, device="meta")]}
    specs = {"a": ("data", "model"), "b": [("model", None), ()]}
    # a: 4 096 B over 256 devices; b[0]: 15 rows do not split 16 ways
    assert sh.bytes_per_device(specs, t, mesh) == 4096 // 256 + 15 * 64 * 4 + 4
    with pytest.raises(KeyError):
        sh.bytes_per_device({"a": ("data",)}, t, mesh)
