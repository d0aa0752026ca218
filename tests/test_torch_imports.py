"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, every module imports on a
machine without CUDA, Triton or nvcc, and the entry points refuse to carry on
without a card unless the caller asks for the CPU."""
import ast
import importlib
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.api import FCTSession
from repro_torch.data.tpch import TpchConfig, generate
from repro_torch.kernels import _build
from repro_torch.launch.mesh import make_worker_mesh

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    assert len(files) > 20
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_or_reference_imports():
    bad = [(str(p.relative_to(ROOT)), root) for p in _sources()
           for root in _imported_roots(p) if root in FORBIDDEN]
    assert not bad, f"the port imports the JAX side: {bad}"


def test_every_module_imports_without_a_card():
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")]
    for kernel_module in ("fct_count", "flash_attention", "lru_scan"):
        assert f"repro_torch.kernels.{kernel_module}.kernel" in names
    assert "repro_torch.launch.serve" in names
    assert "repro_torch.launch.fct_serve" in names
    assert "repro_torch.serve.gateway" in names
    assert "repro_torch.distributed.checkpoint" in names
    for module in ("train.step", "train.optimizer", "train.loop",
                   "train.dp_trainer", "distributed.compression",
                   "launch.train", "models.convert"):
        assert f"repro_torch.{module}" in names
    for name in names:
        importlib.import_module(name)


def test_cuda_is_the_default_device():
    schema = generate(TpchConfig(fact_rows=64, part_rows=8, supp_rows=8,
                                 order_rows=8, text_len=4, vocab_size=32))
    if torch.cuda.is_available():
        assert FCTSession(schema).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        FCTSession(schema)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        make_worker_mesh(2, "cuda")
    assert FCTSession(schema, device="cpu").device.type == "cpu"


def test_lm_entry_points_default_to_cuda():
    from repro_torch.configs.base import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    cfg = get_arch("recurrentgemma-2b").reduced()
    if torch.cuda.is_available():
        assert M.init_params(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        M.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        M.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        serve.main(["--arch", "recurrentgemma-2b"])
    assert M.init_params(cfg, "cpu").device.type == "cpu"


def test_training_entry_points_default_to_cuda():
    from repro_torch.configs.base import get_arch
    from repro_torch.launch import train as launcher
    from repro_torch.train.loop import LoopConfig, data_stream, train
    from repro_torch.train.step import init_train_state
    cfg = get_arch("recurrentgemma-2b").reduced()
    if torch.cuda.is_available():
        assert next(data_stream(cfg, 1, 4))["tokens"].is_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        init_train_state(cfg)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        next(data_stream(cfg, 1, 4))
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        train(cfg, LoopConfig(steps=1))
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        launcher.main(["--arch", "recurrentgemma-2b", "--steps", "1"])


def test_fct_serve_refuses_without_a_card(capsys):
    from repro_torch.launch import fct_serve
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the launcher would serve")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        fct_serve.main(["--smoke"])
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        fct_serve.main(["--smoke", "--device", "cuda"])
    assert "SMOKE OK" not in capsys.readouterr().out


def test_fct_run_on_cpu(capsys):
    from repro_torch.launch import fct_run
    fct_run.main(["--device", "cpu", "--workers", "2", "--repeat", "2",
                  "--scale", "0.5"])
    out = capsys.readouterr().out
    assert "run 1 (warm)" in out and "builds=0 uploads=0" in out


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the smoke would run")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, shutil.copy(ROOT / "chip_smoke.py",
                                               tmp_path))):
        res = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout


def test_ignore_lists_the_kernel_build_directory():
    # the CUDA library is built into build/repro_torch/ and never tracked
    assert "build/" in (ROOT / ".gitignore").read_text().split()
    assert _build.BUILD_DIR.relative_to(ROOT).parts[0] == "build"
