"""The port's dry-run layer on the CPU (``launch/{dryrun,op_analysis,
roofline,sweep,report}.py``) against the JAX package's ``launch/dryrun.py``
and ``launch/hlo_analysis.py``.

  - ``count_params``, ``model_flops`` and ``input_specs`` equal the
    reference's for all ten architectures (the reference's dry-run module
    sets a 512-device ``XLA_FLAGS`` when it is imported; the flag is
    restored at once, before JAX starts a backend, so it never reaches
    this worker);
  - trip counts: the counter's FLOPs and bytes with the plain versions'
    loops trip-counted equal a full walk on meta, exactly, for flash
    attention (ragged S too), lru_scan at S 1 / 17 / 300 and both WKV
    loops, forward and backward; for whole reduced models, prefill and
    train step: FLOPs exact, prefill bytes and peak exact, the train
    step's bytes above the full walk's by exactly the zero-filled
    gradients of the layers the trips skip;
  - a model of 2n layers counts the FLOPs of n layers plus n units (the
    counterpart of ``test_scan_flops_match_unrolled``);
  - the counter's FLOPs equal ``FlopCounterMode``'s without trips, and the
    reference's ``analyze_text`` FLOPs of the same reduced SmolLM-360M
    forward compiled on the CPU;
  - bytes positive and bounded, the virtual mesh's collectives counted,
    none in an LM cell;
  - the CLI gives ok or skip records, a ``--device meta`` sweep writes
    ``all.jsonl`` and ``report`` renders both tables, and ``--device cpu``
    holds a measured cell to its meta record.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from _torch_fixtures import one_torch_thread  # noqa: F401
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import get_arch as jax_get_arch
from repro.launch.hlo_analysis import analyze_text
from repro.models import model as JM
from repro_torch.configs.base import ARCH_IDS, SHAPES, get_arch
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.lru_scan import ref as lru_ref
from repro_torch.launch import dryrun, mesh, op_analysis, report, roofline, sweep
from repro_torch.models import model as M
from repro_torch.models import rwkv6


def _import_reference_dryrun():
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as jdry
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jdry


jdry = _import_reference_dryrun()
META = torch.device("meta")
JAX_DTYPES = {np.dtype("int32"): torch.int32, np.dtype("float32"): torch.float32}

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_reference_flag_does_not_reach_this_worker():
    assert "512" not in os.environ.get("XLA_FLAGS", "")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_count_params_matches_reference(arch):
    assert dryrun.count_params(get_arch(arch)) == \
        jdry.count_params(jax_get_arch(arch))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_input_specs_match_reference(arch):
    cfg, jcfg = get_arch(arch), jax_get_arch(arch)
    matmul = dryrun.count_params(cfg)[2]
    for name in SHAPES:
        assert dryrun.model_flops(cfg, SHAPES[name], matmul) == \
            jdry.model_flops(jcfg, JSHAPES[name], matmul)
        got, want = dryrun.input_specs(cfg, name), jdry.input_specs(jcfg, name)
        assert set(got) == set(want)
        for k, spec in want.items():
            assert got[k].is_meta
            assert tuple(got[k].shape) == tuple(spec.shape), (name, k)
            assert got[k].dtype == JAX_DTYPES[spec.dtype], (name, k)


def _walks(fn, make, train=False):
    """(trip-counted counts, full-walk counts) of fn(*make()) on meta,
    with a backward of its first output's sum when ``train``."""
    res = []
    for full in (False, True):
        args = make()

        def run():
            out = fn(*args)
            if train:
                (out[0] if isinstance(out, tuple) else out).float().sum() \
                    .backward()
        if full:
            with op_analysis.full_walk():
                res.append(op_analysis.count(run)[1])
        else:
            res.append(op_analysis.count(run)[1])
    return res


def _exact(trip, full):
    assert trip.flops == full.flops
    assert trip.bytes == full.bytes
    assert trip.flops > 0 or trip.bytes > 0


@pytest.mark.parametrize("train", [False, True], ids=["fwd", "fwd_bwd"])
@pytest.mark.parametrize("s,block", [(1100, 512), (2048, 512), (700, 128)])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 300)],
                         ids=["causal", "full", "window"])
def test_flash_trip_counts_equal_full_walk(s, block, causal, window, train):
    def make():
        return (torch.empty(2, s, 4, 32, device=META, requires_grad=train),
                torch.empty(2, s, 2, 32, device=META, requires_grad=train),
                torch.empty(2, s, 2, 16, device=META, requires_grad=train))

    def fn(q, k, v):
        return flash_ref.flash_attention(q, k, v, causal=causal,
                                         window=window, block_q=block,
                                         block_k=block)
    trip, full = _walks(fn, make, train)
    _exact(trip, full)
    assert trip.flops_by_loop == full.flops_by_loop == \
        {"flash_attention": full.flops}


@pytest.mark.parametrize("train", [False, True], ids=["fwd", "fwd_bwd"])
@pytest.mark.parametrize("s", [1, 17, 300])
def test_lru_scan_trip_counts_equal_full_walk(s, train):
    def make():
        return (torch.empty(2, s, 8, device=META, requires_grad=train),
                torch.empty(2, s, 8, device=META, requires_grad=train))
    trip, full = _walks(lru_ref.lru_scan, make, train)
    _exact(trip, full)
    out = lru_ref.lru_scan(*make())
    assert out.shape == (2, s, 8) and out.is_meta


@pytest.mark.parametrize("train", [False, True], ids=["fwd", "fwd_bwd"])
@pytest.mark.parametrize("chunked", [False, True], ids=["scan", "chunked"])
@pytest.mark.parametrize("s", [48, 64])
def test_wkv_trip_counts_equal_full_walk(s, chunked, train):
    def make():
        r, k, v, w = (torch.empty(2, s, 2, 8, device=META,
                                  requires_grad=train) for _ in range(4))
        return (r, k, v, w,
                torch.empty(2, 8, device=META, requires_grad=train),
                torch.zeros(2, 2, 8, 8, device=META))
    fn = rwkv6._wkv_chunked if chunked else rwkv6._wkv_scan
    trip, full = _walks(fn, make, train)
    _exact(trip, full)
    assert fn(*make())[0].shape == (2, s, 2, 8)


def _deep(arch, units):
    cfg = get_arch(arch).reduced()
    unit = len(M.decompose(cfg.blocks()).unit)
    first = cfg.first_k_dense if cfg.n_experts else 0
    return dataclasses.replace(cfg, n_layers=first + unit * units,
                               remat="full")


def _cell_counts(cfg, kind, full=False, s=64):
    shape = dataclasses.replace(SHAPES[kind], global_batch=2, seq_len=s)
    cell = dryrun.build_cell(cfg, shape, "meta")
    if full:
        with op_analysis.full_walk():
            return op_analysis.count(cell.call)[1], cell
    return op_analysis.count(cell.call)[1], cell


@pytest.mark.parametrize("arch", ["smollm_360m", "recurrentgemma_2b",
                                  "rwkv6_1b6", "deepseek_moe_16b"])
def test_model_trip_counts_equal_full_walk(arch):
    cfg = _deep(arch, 6)
    trip, _ = _cell_counts(cfg, "prefill_32k")
    full, _ = _cell_counts(cfg, "prefill_32k", full=True)
    _exact(trip, full)
    assert trip.peak_bytes == full.peak_bytes
    trip, cell = _cell_counts(cfg, "train_4k")
    full, _ = _cell_counts(cfg, "train_4k", full=True)
    assert trip.flops == full.flops
    # the trips run repetitions 0, 1, reps - 2 and reps - 1; the other
    # layers' parameters get no gradient, and ``param_grads`` zero-fills
    # one for each (a read and a write of its bytes)
    layout = M.decompose(cfg.blocks())
    n_pre, n_unit = len(layout.prefix), len(layout.unit)
    skipped = {n_pre + r * n_unit + i for r in range(2, layout.reps - 2)
               for i in range(n_unit)}
    zero_filled = sum(2 * p.numel() * p.element_size() for li in skipped
                      for p in cell.args["params"].blocks[li].parameters())
    assert skipped and trip.bytes == full.bytes + zero_filled


@pytest.mark.parametrize("kind", ["prefill_32k", "train_4k"])
@pytest.mark.parametrize("arch", ["smollm_360m", "recurrentgemma_2b"])
def test_2n_layers_count_n_layers_plus_n_units(arch, kind):
    n = 4
    f = {u: _cell_counts(_deep(arch, u), kind, s=64)[0].flops
         for u in (n, n + 1, 2 * n)}
    assert f[2 * n] == f[n] + n * (f[n + 1] - f[n])
    assert f[n + 1] > f[n]


def test_scan_flops_match_unrolled():
    """The counterpart of the reference's test: a loop of 8 matmul+tanh
    trips counts 8 trips, trip-counted or walked in full."""
    w = torch.empty(8, 64, 64, device=META)
    x = torch.empty(4, 64, device=META)

    def scanned(x, w):
        for i in op_analysis.trips(8, x, "scan"):
            x = torch.tanh(x @ w[i])
        return x
    trip, full = _walks(scanned, lambda: (x, w))
    assert trip.flops == full.flops == 8 * 2 * 4 * 64 * 64
    low = 8 * (64 * 64 * 4)          # weight reads
    assert low <= trip.bytes <= 100 * low


def test_flops_equal_flop_counter_mode_without_trips():
    cfg = _deep("smollm_360m", 2)      # flash's plain version at S 1 100
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=1,
                                seq_len=1100)
    cell = dryrun.build_cell(cfg, shape, "meta")
    with op_analysis.full_walk():
        counts = op_analysis.count(cell.call)[1]
    cell = dryrun.build_cell(cfg, shape, "meta")
    with op_analysis.full_walk(), FlopCounterMode(display=False) as fc:
        cell.call()
    assert counts.flops == fc.get_total_flops() > 0


def test_flops_equal_reference_analyze_text():
    """Reduced SmolLM-360M, B 2 x S 64: the port's forward on meta against
    the reference's forward compiled on the CPU.  Every dot of both is a
    projection, the attention products or the logits; nothing differs."""
    jcfg = jax_get_arch("smollm_360m").reduced()
    cfg = get_arch("smollm_360m").reduced()
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    batch = {"tokens": jnp.zeros((2, 64), jnp.int32)}
    text = jax.jit(lambda p, b: JM.forward(p, b, jcfg)[0]).lower(
        params, batch).compile().as_text()
    want = analyze_text(text).flops
    shape = dataclasses.replace(SHAPES["prefill_32k"], global_batch=2,
                                seq_len=64)
    got = op_analysis.count(dryrun.build_cell(cfg, shape, "meta").call)[1]
    assert got.flops == want > 0


def test_census_counts_the_virtual_mesh():
    def moves():
        t = torch.zeros(3, 2, 2, 4)
        mesh.all_to_all(t)
        mesh.psum(t)
        mesh.psum_scatter(t, 3)
        mesh.all_gather(t[:, 0, 0])
    _, counts = op_analysis.count(moves)
    assert counts.collectives == {"all_to_all": 1, "psum": 1,
                                  "psum_scatter": 1, "all_gather": 1}


def test_meta_records_of_lm_cells():
    rec = dryrun.run_cell("olmo-1b", "decode_32k", "meta", verbose=False)
    assert rec["status"] == "ok"
    assert rec["counts"]["collectives"] == dict.fromkeys(mesh.COLLECTIVES, 0)
    assert rec["roofline"]["collective_s"] == 0.0
    rf = rec["roofline"]
    assert rf["bottleneck"] == "memory"
    assert rf["memory_s"] == rf["hbm_bytes"] / roofline.HBM_BYTES_PER_S
    assert rec["roofline_fraction"] == pytest.approx(
        rec["model_flops"] / roofline.PEAK_BF16_FLOPS / rf["memory_s"])
    assert rec["arg_bytes"] == sum(rec["arg_bytes_by_part"].values())
    per = rec["arg_bytes_per_dev"]
    assert per["2x16x16"] <= per["16x16"] < rec["arg_bytes"]
    for arch, shape, reason in (("hubert-xlarge", "decode_32k", "encoder-only"),
                                ("gemma-7b", "long_500k", "sub-quadratic")):
        rec = dryrun.run_cell(arch, shape, "meta", verbose=False)
        assert rec["status"] == "skip" and reason in rec["reason"]


def test_cli_record_and_cut(tmp_path, capsys):
    out = tmp_path / "cell.json"
    assert dryrun.main(["--arch", "recurrentgemma-2b", "--shape",
                        "prefill_32k", "--batch", "1", "--seq", "2048",
                        "--device", "meta", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["status"] == "ok" and rec["device"] == "meta"
    assert rec["reduced"] == ["B 1 (from 32)", "S 2048 (from 32768)"]
    assert rec["fits_one_card"] and "measured" not in rec
    assert set(rec["counts"]["flops_by_loop"]) == {"layers",
                                                   "flash_attention"}
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["status"] \
        == "ok"
    assert dryrun.main(["--arch", "hubert-xlarge", "--shape", "long_500k",
                        "--device", "meta"]) == 0


def test_measured_cell_on_cpu_holds_to_its_meta_record():
    cfg = get_arch("recurrentgemma-2b").reduced()
    for kind, s in (("prefill_32k", 1100), ("decode_32k", 40)):
        shape = dataclasses.replace(SHAPES[kind], global_batch=2, seq_len=s)
        rec = dryrun.meta_record(cfg, shape)
        got = dryrun.measure(cfg, shape, rec, "cpu")
        assert got["arg_bytes_equal"] and got["arg_bytes"] == rec["arg_bytes"]
        assert got["flops_equal"] and got["flops"] > 0
        assert got["launches"] == {}


def test_sweep_and_report(tmp_path, capsys):
    out_dir = sweep.main(["--device", "meta", "--out-root", str(tmp_path),
                          "--only", "olmo", "--shapes",
                          "decode_32k,long_500k"])
    assert out_dir == tmp_path / "meta"
    capsys.readouterr()
    recs = report.load(out_dir / "all.jsonl")
    assert [(r["arch"], r["shape"], r["status"]) for r in recs] == [
        ("olmo-1b", "decode_32k", "ok"), ("olmo-1b", "long_500k", "skip")]
    for which in ("roofline", "dryrun"):
        report.main([str(out_dir / "all.jsonl"), which])
        table = capsys.readouterr().out.splitlines()
        assert len(table) == 4
        assert table[2].startswith("| olmo-1b | decode_32k | ")
        assert "skip" in table[3]
    report.main([str(out_dir / "all.jsonl"), "summary"])
    table = capsys.readouterr().out.splitlines()
    assert table[0] == "| arch | decode_32k | long_500k |"
    assert len(table) == 3 and table[2].startswith("| olmo-1b | ")
    assert table[2].endswith(" s | skip |")
    # a second run resumes: nothing left to do
    sweep.main(["--device", "meta", "--out-root", str(tmp_path), "--only",
                "olmo", "--shapes", "decode_32k,long_500k"])
    assert len((out_dir / "all.jsonl").read_text().splitlines()) == 2
