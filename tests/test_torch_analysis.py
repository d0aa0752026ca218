"""The port's invariant checks (``repro_torch.analysis``), case for case
with ``tests/test_analysis.py``: per-rule must-flag/must-pass fixtures in
torch spellings, the waiver grammar, ``src/repro_torch`` lint-clean, the
exclusion list, and the runtime contract checker — clean on the real
engine at P = 1 and P = 8 under both policies, failing on injected
corruptions — held against the JAX package's checker for the number of
programs it checks; and the CLI's exit codes and JSON."""
import dataclasses
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.analysis import lint_paths
from repro_torch.analysis.config import EXCLUDED_DIRS
from repro_torch.analysis.lint import lint_file

_REPO = Path(__file__).resolve().parent.parent


def run_rules(tmp_path, rel, source):
    """Lint a fixture as if it lived at ``src/repro_torch/<rel>``."""
    path = tmp_path / Path(rel).name
    path.write_text(textwrap.dedent(source))
    return lint_file(path, rel, rel)


def rule_ids(violations):
    return [v.rule for v in violations]


# -- R1: trace containment ----------------------------------------------------

R1_SOURCE = """\
    import torch

    def build(fn):
        return torch.compile(fn)
    """


def test_r1_flags_compile_outside_runtime(tmp_path):
    violations, _ = run_rules(tmp_path, "core/foo.py", R1_SOURCE)
    assert rule_ids(violations) == ["R1"]
    assert "program cache" in violations[0].message
    assert violations[0].render().startswith("core/foo.py:4 R1 ")


@pytest.mark.parametrize("rel", ["runtime/foo.py", "kernels/foo.py"])
def test_r1_allows_compile_in_runtime_and_kernels(tmp_path, rel):
    violations, _ = run_rules(tmp_path, rel, R1_SOURCE)
    assert violations == []


@pytest.mark.parametrize("source,n", [
    ("""\
        import torch
        from torch import jit

        @torch.compile
        def f(x):
            return x

        def g(fn, x):
            with torch.cuda.graph(torch.cuda.CUDAGraph()):
                return jit.trace(fn, x)
        """, 3),
    ("""\
        import ctypes
        from ctypes import CDLL
        from repro_torch.kernels import _build
        from repro_torch.kernels._build import Library as Lib

        a = ctypes.CDLL("x.so")
        b = CDLL("y.so")
        c = _build.Library("k", "k.cu", {})
        d = Lib("k", "k.cu", {})
        """, 4),
    # names that only look alike: the builtin compile, a local graph(),
    # re.compile
    ("""\
        import re

        def graph(x):
            return compile(x, "<s>", "eval"), re.compile(x)
        """, 0),
])
def test_r1_flags_decorator_graph_capture_and_library_loads(tmp_path, source,
                                                            n):
    violations, _ = run_rules(tmp_path, "api/foo.py", source)
    assert rule_ids(violations) == ["R1"] * n


# -- R2: accumulation discipline ----------------------------------------------

def test_r2_flags_dtype_free_sum_and_uncast_psum(tmp_path):
    violations, _ = run_rules(tmp_path, "core/fct.py", """\
        import torch
        from repro_torch.launch.mesh import psum

        def histogram(w, hist, out):
            total = torch.sum(w) + w.sum(dim=0)
            out.index_add_(0, w, w)
            return total + psum(hist)
        """)
    assert rule_ids(violations) == ["R2", "R2", "R2", "R2"]
    assert "dtype" in violations[0].message
    assert "index_add_" in violations[2].message


def test_r2_passes_explicit_policy_dtype(tmp_path):
    violations, _ = run_rules(tmp_path, "core/fct.py", """\
        import torch
        from repro_torch.launch import mesh

        def histogram(w, hist, sig, idx):
            acc = sig.accum.dtype
            total = torch.sum(w, dtype=acc) + w.sum(0, dtype=acc)
            out = torch.zeros(8, dtype=acc)
            out.index_add_(0, idx, w)
            return total + mesh.psum(hist.to(acc))

        def padded(hists, sig, reduce_cns, p):
            acc = sig.accum.dtype
            h = hists.sum(dim=0, dtype=acc) if reduce_cns else hists.to(acc)
            h = torch.nn.functional.pad(h, (0, 3))
            return mesh.psum_scatter(h[0].reshape(-1), p)
        """)
    assert violations == []


def test_r2_unblesses_reassigned_operand(tmp_path):
    # the cast is overwritten before the reduction, and a scatter target
    # re-bound after its allocation -> both flagged again
    violations, _ = run_rules(tmp_path, "core/fct.py", """\
        import torch
        from repro_torch.launch.mesh import psum

        def histogram(w, hist, dt, idx):
            h = hist.to(dt)
            h = hist * 2
            out = torch.zeros(8, dtype=dt)
            out = w
            out.scatter_add_(0, idx, w)
            return psum(h)
        """)
    assert rule_ids(violations) == ["R2", "R2"]


def test_r2_scoped_to_accum_modules(tmp_path):
    violations, _ = run_rules(tmp_path, "core/star.py", """\
        import torch

        def f(w):
            return torch.sum(w)
        """)
    assert violations == []


# -- R3: lock discipline ------------------------------------------------------

def test_r3_flags_unlocked_counter_and_field(tmp_path):
    violations, _ = run_rules(tmp_path, "serve/gateway.py", """\
        class Gateway:
            def submit(self, key, fut):
                self.submitted += 1
                self._pending[key] = fut
        """)
    assert rule_ids(violations) == ["R3", "R3"]
    assert "self._lock" in violations[0].message


def test_r3_passes_locked_and_constructor_writes(tmp_path):
    violations, _ = run_rules(tmp_path, "serve/gateway.py", """\
        import threading

        class Gateway:
            def __init__(self):
                self._lock = threading.Lock()
                self.submitted = 0
                self._pending = {}

            def submit(self, key, fut):
                with self._lock:
                    self.submitted += 1
                    self._pending[key] = fut
        """)
    assert violations == []


@pytest.mark.parametrize("rel,lock", [("serve/gateway.py", "_other"),
                                      ("serve/batcher.py", "_lock")])
def test_r3_requires_the_configured_lock(tmp_path, rel, lock):
    # a with-block on some other attribute does not count (the port's
    # batcher guards its state with _cv only)
    violations, _ = run_rules(tmp_path, rel, f"""\
        class Gateway:
            def submit(self):
                with self.{lock}:
                    self.submitted += 1
        """)
    assert rule_ids(violations) == ["R3"]


@pytest.mark.parametrize("rel", ["serve/batcher.py", "runtime/engine.py"])
def test_r3_flags_unguarded_metric_bump(tmp_path, rel):
    # growing a raw counter instead of routing it through the metrics
    # registry (the blessed lock owner) is flagged — in the engine, which
    # owns no lock, even outside any with-block
    violations, _ = run_rules(tmp_path, rel, """\
        class Component:
            def __init__(self):
                self.windows_flushed = 0

            def _flush(self, batch):
                self.windows_flushed += 1
        """)
    assert rule_ids(violations) == ["R3"]
    if rel == "runtime/engine.py":
        assert "owns no lock" in violations[0].message


def test_r3_covers_obs_metrics_instruments(tmp_path):
    violations, _ = run_rules(tmp_path, "obs/metrics.py", """\
        class Counter:
            def inc(self, n=1):
                with self._lock:
                    self._value += n

            def inc_unlocked(self, n=1):
                self._value += n
        """)
    assert rule_ids(violations) == ["R3"]


# -- R4: no host sync in dispatch paths ---------------------------------------

@pytest.mark.parametrize("call", [
    "out.cpu()", "out.item()", "out.tolist()", "out.numpy()",
    'out.to("cpu")', 'out.to(device=torch.device("cpu"))',
    "torch.cuda.synchronize()", "np.asarray(out)"])
def test_r4_flags_host_sync_in_dispatch(tmp_path, call):
    violations, _ = run_rules(tmp_path, "runtime/engine.py", f"""\
        import numpy as np
        import torch

        def run_batch(self, out):
            x = out.to(torch.int64).to("cuda")
            y = {call}
            return out
        """)
    assert rule_ids(violations) == ["R4"]
    assert "run_batch" in violations[0].message


def test_r4_allows_sync_in_collect_functions(tmp_path):
    violations, _ = run_rules(tmp_path, "runtime/engine.py", """\
        def _collect(self, out):
            return out.cpu().numpy()

        def collect_topk(self, tp):
            return tp.counts.cpu().numpy(), int(tp.wrapped.item())
        """)
    assert violations == []


# -- R5: epoch fencing --------------------------------------------------------

def test_r5_flags_unfenced_cache_put(tmp_path):
    violations, _ = run_rules(tmp_path, "serve/result_cache.py", """\
        class ResultCache:
            def store(self, key, value):
                self._entries.put(key, value)
        """)
    assert rule_ids(violations) == ["R5"]
    assert "generation" in violations[0].message


def test_r5_passes_fenced_puts(tmp_path):
    violations, _ = run_rules(tmp_path, "serve/result_cache.py", """\
        class ResultCache:
            def store_kw(self, key, value, gen):
                self._entries.put(key, value, generation=gen)

            def store_checked(self, key, value, gen):
                if gen != self.generation:
                    return
                self._entries.put(key, value)
        """)
    assert violations == []


def test_r5_flags_unfenced_subscript_assign(tmp_path):
    violations, _ = run_rules(tmp_path, "api/session.py", """\
        class FCTSession:
            def patch(self, kws, ts):
                with self._plan_lock:
                    self._tuple_sets[kws] = ts
        """)
    assert rule_ids(violations) == ["R5"]
    assert "_tuple_sets" in violations[0].message


def test_r5_passes_fenced_subscript_assign(tmp_path):
    violations, _ = run_rules(tmp_path, "api/session.py", """\
        class FCTSession:
            def patch(self, kws, ts, epoch):
                with self._plan_lock:
                    assert self._data_epoch == epoch
                    self._tuple_sets[kws] = ts

            def untracked(self, kws):
                with self._plan_lock:
                    self._scratch[kws] = 1   # not a configured cache
        """)
    assert violations == []


# -- waivers ------------------------------------------------------------------

def test_waiver_on_line_or_line_above(tmp_path):
    violations, waived = run_rules(tmp_path, "core/foo.py", """\
        import torch

        f = torch.compile(abs)  # fct-lint: waive[R1] -- fixture same-line reason
        # fct-lint: waive[R1] -- fixture line-above reason
        g = torch.compile(abs)
        """)
    assert violations == []
    assert sorted(w.justification for w in waived) == [
        "fixture line-above reason", "fixture same-line reason"]


def test_waiver_without_justification_is_a_violation(tmp_path):
    violations, waived = run_rules(tmp_path, "core/foo.py", """\
        import torch

        f = torch.compile(abs)  # fct-lint: waive[R1]
        """)
    assert sorted(rule_ids(violations)) == ["R1", "WAIVER"]
    assert waived == []


def test_waiver_must_name_the_right_rule(tmp_path):
    violations, waived = run_rules(tmp_path, "core/foo.py", """\
        import torch

        f = torch.compile(abs)  # fct-lint: waive[R4] -- wrong rule id
        """)
    assert rule_ids(violations) == ["R1"]
    assert waived == []


# -- the port itself ----------------------------------------------------------

def test_port_is_lint_clean():
    report = lint_paths(_REPO / "src" / "repro_torch")
    assert report.files_checked > 40
    assert report.ok, "\n".join(v.render() for v in report.violations)
    assert all(w.justification for w in report.waived)
    assert {w.rule for w in report.waived} <= {"R2", "R3", "R4"}


def test_excluded_dirs_are_the_reference_list_and_not_in_pyproject():
    """The port excludes the same directories as the JAX package, and ruff's
    exclusion list stays the JAX package's alone."""
    from repro.analysis.config import EXCLUDED_DIRS as JAX_EXCLUDED
    assert EXCLUDED_DIRS == JAX_EXCLUDED
    text = (_REPO / "pyproject.toml").read_text()
    block = re.search(r"extend-exclude\s*=\s*\[(.*?)\]", text, re.S)
    assert "repro_torch" not in block.group(1)
    # importing the lint never imports torch
    proc = subprocess.run(
        [sys.executable, "-c", "import sys, repro_torch.analysis.rules; "
                               "print('torch' in sys.modules)"],
        env={**os.environ, "PYTHONPATH": "src"}, capture_output=True,
        text=True, timeout=120, cwd=_REPO)
    assert proc.stdout.strip() == "False", proc.stderr


# -- layer 2: runtime contracts -----------------------------------------------

def _mesh(P=1):
    from repro_torch.launch.mesh import make_worker_mesh
    return make_worker_mesh(P, "cpu")


def _one_sig():
    from repro_torch.analysis.contracts import representative_signatures
    from repro_torch.core.accum import INT32_CHECKED
    return representative_signatures(1, [INT32_CHECKED])[0]


@pytest.mark.parametrize("P", [1, 8])
def test_contracts_clean_on_real_engine(P):
    from repro_torch.analysis.contracts import check_all_contracts
    failures, checked = check_all_contracts(mesh=_mesh(P))
    # 2 families x 2 signature buckets + 2 top-k buckets, per policy
    assert checked == 12
    assert failures == []


def test_contract_counts_match_the_reference_checker(monkeypatch):
    """The same signatures yield the same number of checked programs in the
    JAX package's checker, restricted to the families the port has
    (``fct_store``, ``fct_store_percn``, ``fct_topk``), and in the
    port's."""
    from repro.analysis import contracts as jax_contracts
    from repro.analysis.contracts import check_all_contracts as jax_check
    from repro.analysis.contracts import \
        representative_signatures as jax_sigs
    from repro.core.accum import INT32_CHECKED as JAX_INT32
    from repro.launch.mesh import make_worker_mesh as jax_mesh
    from repro_torch.analysis.contracts import (KINDS, check_all_contracts,
                                                representative_signatures)
    from repro_torch.core.accum import INT32_CHECKED
    def shapes(sigs):
        return [dataclasses.asdict(dataclasses.replace(s, accum=None))
                for s in sigs]

    assert shapes(representative_signatures(8, [INT32_CHECKED])) == shapes(
        jax_sigs(8, [JAX_INT32]))
    assert set(KINDS) < set(jax_contracts.KINDS)
    monkeypatch.setattr(jax_contracts, "KINDS", KINDS)
    jf, jchecked = jax_check(mesh=jax_mesh(1), policies=[JAX_INT32])
    pf, pchecked = check_all_contracts(mesh=_mesh(1), policies=[INT32_CHECKED])
    assert jf == [] and pf == []
    assert pchecked == jchecked == 6


def test_contract_c4_rejects_unbucketed_signature():
    from repro_torch.analysis.contracts import check_contract
    sig = _one_sig()
    bad = dataclasses.replace(
        sig, fact=dataclasses.replace(sig.fact, rows=12))
    failures = check_contract("fct_store", bad, 2, _mesh())
    assert failures and "C4" in failures[0] and "rows=12" in failures[0]


def test_contract_c4_rejects_unbucketed_cn_stack():
    from repro_torch.analysis.contracts import check_contract
    failures = check_contract("fct_store_percn", _one_sig(), 3, _mesh())
    assert failures and "C4" in failures[0] and "n_stack=3" in failures[0]


@pytest.mark.parametrize("kind", ["fct_store", "fct_store_percn"])
def test_contract_c2_catches_float_accumulator(monkeypatch, kind):
    from repro_torch.analysis.contracts import check_contract
    from repro_torch.core import accum
    monkeypatch.setattr(accum.AccumPolicy, "dtype",
                        property(lambda self: torch.float32))
    failures = check_contract(kind, _one_sig(), 4, _mesh())
    assert failures and any("C2" in f and "floating-point" in f
                            for f in failures)


@pytest.mark.parametrize("P", [1, 8])
def test_contract_c1_catches_double_reduction(monkeypatch, P):
    import repro_torch.runtime.engine as engine_mod
    from repro_torch.analysis.contracts import check_contract
    from repro_torch.launch import mesh as mesh_mod
    orig = engine_mod._aggregate

    def doubled(*args, **kwargs):
        return mesh_mod.psum(orig(*args, **kwargs))

    monkeypatch.setattr(engine_mod, "_aggregate", doubled)
    sig = dataclasses.replace(_one_sig(), n_devices=P)
    failures = check_contract("fct_store", sig, 2, _mesh(P))
    assert failures and any("C1" in f and "2 reductions" in f
                            for f in failures)


def test_contract_c3_catches_vocab_sized_topk_output(monkeypatch):
    import repro_torch.runtime.engine as engine_mod
    from repro_torch.analysis.contracts import check_topk_contract
    from repro_torch.core.accum import INT32_CHECKED
    orig = engine_mod._build_topk_fn

    def leaky(sig, mesh, rs):
        program = orig(sig, mesh, rs)

        def run(hist, kw, excl):
            counts, ids, wrapped = program(hist, kw, excl)
            return hist, ids, wrapped       # the whole histogram leaks out
        return run

    tsig = engine_mod.topk_signature(100, 8, INT32_CHECKED, k=10)
    assert check_topk_contract(tsig, _mesh(8)) == []
    monkeypatch.setattr(engine_mod, "_build_topk_fn", leaky)
    failures = check_topk_contract(tsig, _mesh(8))
    assert failures and any("C3" in f and "(104,)" in f for f in failures)


# -- CLI ----------------------------------------------------------------------

def _cli(*args, cwd=_REPO):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(_REPO / "src")
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                           *args], env=env, capture_output=True, text=True,
                          timeout=300, cwd=cwd)


def test_cli_exits_zero_and_emits_json():
    proc = _cli("--json", "--contracts", "--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    payload = json.loads(proc.stdout)
    assert payload["ok"] and payload["lint"]["violations"] == []
    assert payload["lint"]["files_checked"] > 40
    assert payload["contracts"] == {"checked": 24, "failures": []}


def test_cli_exits_nonzero_on_violation(tmp_path):
    pkg = tmp_path / "repro_torch"
    (pkg / "core").mkdir(parents=True)
    (pkg / "core" / "bad.py").write_text(
        "import torch\nf = torch.compile(abs)\n")
    proc = _cli(str(pkg))
    assert proc.returncode == 1
    assert re.search(r"bad\.py:2 R1 ", proc.stdout)
    if not torch.cuda.is_available():
        # the contracts run on the card unless asked otherwise: no card is
        # a setup error, not a pass
        proc = _cli("--contracts", "--no-lint")
        assert proc.returncode == 2
        assert "CUDA device requested" in proc.stderr
    assert _cli("--no-lint").returncode == 2
