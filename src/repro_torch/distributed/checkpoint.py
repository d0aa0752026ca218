"""Atomic, step-numbered checkpoints of nested dicts and lists of arrays.

Layout:   ``<dir>/step_00000123/arrays.npz`` + ``manifest.json``, written
to a ``.tmp_`` directory and published by one rename, so a crash mid-save
never corrupts the latest checkpoint.  Leaves are torch tensors or numpy
arrays; each is saved gathered to the host under its path key
(``"fact/text"``, ``"dims/0/vol"``, …: dict keys in sorted order, list
items by index), the layout the JAX package's checkpoints use.  npz cannot
hold bfloat16, so bf16 leaves are widened losslessly to float32 and cast
back to the template's dtype on restore.  Restore places every leaf on its
template leaf's device.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import tempfile
from typing import Any, Iterator, Optional, Tuple

import numpy as np
import torch


def _leaves(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """(path key, leaf) pairs in flattening order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    elif tree is not None:          # None is an empty subtree
        yield "/".join(prefix), tree


def _structure(tree) -> str:
    """The tree's shape with ``*`` for each leaf, written as the JAX
    package's manifests write it."""
    if isinstance(tree, dict):
        body = ", ".join(f"{k!r}: {_structure(tree[k])}" for k in sorted(tree))
        return "{" + body + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_structure(v) for v in tree) + "]"
    if isinstance(tree, tuple):
        inner = [_structure(v) for v in tree]
        return "(" + ", ".join(inner) + ("," if len(inner) == 1 else "") + ")"
    return "None" if tree is None else "*"


def _host_array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()              # lossless widening
        return leaf.detach().cpu().numpy()
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return arr


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    keep: int = 3) -> str:
    """Write ``tree`` as step ``step`` under ``ckpt_dir`` and keep the
    newest ``keep`` steps.  Returns the step directory."""
    base = pathlib.Path(ckpt_dir)
    base.mkdir(parents=True, exist_ok=True)
    final = base / f"step_{step:08d}"
    tmp = pathlib.Path(tempfile.mkdtemp(dir=base, prefix=".tmp_"))
    arrays = {k: _host_array(v) for k, v in _leaves(tree)}
    np.savez(tmp / "arrays.npz", **arrays)
    (tmp / "manifest.json").write_text(json.dumps({
        "step": step,
        "treedef": f"PyTreeDef({_structure(tree)})",
        "keys": sorted(arrays.keys()),
        "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
    }))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)                     # atomic publish
    _prune(base, keep)
    return str(final)


def _prune(base: pathlib.Path, keep: int) -> None:
    steps = sorted(p for p in base.iterdir() if p.name.startswith("step_"))
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest published step under ``ckpt_dir``, or None."""
    base = pathlib.Path(ckpt_dir)
    if not base.exists():
        return None
    steps = sorted(p.name for p in base.iterdir()
                   if p.name.startswith("step_")
                   and (p / "manifest.json").exists())
    return int(steps[-1].split("_")[1]) if steps else None


def _rebuild(template, data, prefix: Tuple[str, ...] = ()):
    if isinstance(template, dict):
        return {k: _rebuild(v, data, prefix + (str(k),))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        out = [_rebuild(v, data, prefix + (str(i),))
               for i, v in enumerate(template)]
        return out if isinstance(template, list) else tuple(out)
    if template is None:
        return None
    arr = data["/".join(prefix)]
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(arr).to(device=template.device,
                                        dtype=template.dtype)
    if hasattr(template, "dtype"):
        return arr.astype(template.dtype)
    return arr


def restore_checkpoint(ckpt_dir: str, template: Any,
                       step: Optional[int] = None) -> Tuple[int, Any]:
    """Restore step ``step`` (default: the newest) into ``template``'s
    structure, each leaf in its template leaf's dtype and on its device.
    Returns ``(step, tree)``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    with np.load(d / "arrays.npz") as data:
        return step, _rebuild(template, data)
