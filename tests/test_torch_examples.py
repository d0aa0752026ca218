"""The port's examples on the CPU against the JAX package's, run in the
same process: the FCT examples (``examples/quickstart_torch.py``,
``examples/fct_query_expansion_torch.py``) on ``build_db(seed=0)`` (the
same database, the same printed answer, bit-equal term ids and
frequencies, the same expansion result counts), and
``examples/serve_lm_torch.py`` on the JAX example's own parameters and
prompts (``params_from_reference``; reduced configurations in float32):
every greedy token equal, and the same printed requests — and each on the
card by default."""
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.api import FCTRequest as JaxRequest
from repro.api import FCTSession as JaxSession
from repro.configs.base import get_arch as jax_get_arch
from repro.models import model as JM
from repro.train.step import make_serve_step as jax_make_serve_step
from repro_torch.configs.base import get_arch
from repro_torch.data import demo
from repro_torch.models.convert import params_from_reference

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_example_{name}",
                                                  EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _answer_lines(out):
    """Printed lines, without the timing line and the port's id line."""
    return [ln for ln in out.splitlines()
            if not ln.startswith(("latency:", "term ids "))]


def _ids_line(res):
    return (f"term ids {[int(t) for t in res.term_ids]} "
            f"freqs {[int(f) for f in res.freqs]} on cpu")


def test_demo_database_is_the_reference_examples():
    ref = _load("quickstart")
    want, got = ref.build_db(seed=0), demo.build_db(seed=0)
    assert demo.VOCAB == ref.VOCAB and got.vocab_size == want.vocab_size
    for a, b in zip([got.fact] + list(got.dims), [want.fact] + list(want.dims)):
        assert a.name == b.name
        np.testing.assert_array_equal(a.text, b.text)
        assert sorted(a.keys) == sorted(b.keys)
        for k in a.keys:
            np.testing.assert_array_equal(a.keys[k], b.keys[k])


def test_quickstart_matches_the_reference(capsys):
    ref, port = _load("quickstart"), _load("quickstart_torch")
    ref.main()
    want_out = capsys.readouterr().out
    res = port.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert _answer_lines(out) == _answer_lines(want_out)
    assert _ids_line(res) in out.splitlines()
    want = JaxSession(ref.build_db(seed=0), tokenizer=ref.TOK).query(
        JaxRequest(keywords=tuple(port.QUERY), top_k=port.TOP_K,
                   r_max=port.R_MAX))
    np.testing.assert_array_equal(res.term_ids, want.term_ids)
    np.testing.assert_array_equal(res.freqs, want.freqs)
    assert res.freqs[0] > 0


def test_query_expansion_matches_the_reference(capsys):
    ref, port = _load("fct_query_expansion"), _load("fct_query_expansion_torch")
    ref.main()
    want_out = capsys.readouterr().out
    got = port.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert _answer_lines(out) == _answer_lines(want_out)
    schema = _load("quickstart").build_db(seed=0)
    kws = [int(t) for t in demo.TOK.encode_batch(port.QUERY, 1)[:, 0]]
    assert got["results"] == ref.result_count(schema, kws) > 0
    assert len(got["expanded"]) == 3
    for word, n1 in got["expanded"]:
        extra = int(demo.TOK.encode_batch([word], 1)[0, 0])
        assert n1 == ref.result_count(schema, kws + [extra])
    res = got["response"]
    assert _ids_line(res) in out.splitlines()
    want = JaxSession(schema, tokenizer=demo.TOK).query(JaxRequest(
        keywords=tuple(port.QUERY), top_k=port.TOP_K, r_max=port.R_MAX))
    np.testing.assert_array_equal(res.term_ids, want.term_ids)
    np.testing.assert_array_equal(res.freqs, want.freqs)


@pytest.mark.parametrize("arch", ["smollm-360m", "recurrentgemma-2b"])
def test_serve_lm_matches_the_reference(arch, capsys, monkeypatch):
    ref, port = _load("serve_lm"), _load("serve_lm_torch")
    monkeypatch.setattr("sys.argv", ["serve_lm.py", "--arch", arch])
    ref.main()
    want_out = capsys.readouterr().out.splitlines()
    # the JAX example's parameters, prompts and loop, as it builds them
    jcfg = jax_get_arch(arch).reduced()
    key = jax.random.PRNGKey(0)
    jp = JM.init_params(jcfg, key)
    b, prompt_len, gen_len = 4, 12, 20
    prompts = np.asarray(jax.random.randint(key, (b, prompt_len), 0,
                                            jcfg.vocab_size))
    cache = JM.init_cache(jcfg, b, prompt_len + gen_len)
    step = jax.jit(jax_make_serve_step(jcfg))
    for t in range(prompt_len):
        tok, cache = step(jp, cache, prompts[:, t:t + 1], t)
    want = [np.asarray(tok)]
    for t in range(prompt_len, prompt_len + gen_len - 1):
        tok, cache = step(jp, cache, tok[:, None], t)
        want.append(np.asarray(tok))
    want = np.stack(want, axis=1)
    cfg = get_arch(arch).reduced()
    params = params_from_reference(jax.tree.map(np.asarray, jp), cfg, "cpu")
    got = port.serve(params, cfg, torch.from_numpy(np.array(prompts)).long(),
                      gen_len)
    np.testing.assert_array_equal(got.numpy(), want)
    lines = [f"  req{i}: prompt={list(map(int, prompts[i]))[:6]}... "
             f"-> {got[i].tolist()[:10]}..." for i in range(b)]
    assert lines == [ln for ln in want_out if ln.startswith("  req")]
    prompts_out, gen = port.main(["--arch", arch, "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == want_out[0]          # the same shape line
    assert out[-1].endswith("end to end on cpu")
    assert gen.shape == (b, gen_len) and prompts_out.shape == (b, prompt_len)


@pytest.mark.parametrize("name", ["quickstart_torch",
                                  "fct_query_expansion_torch",
                                  "serve_lm_torch"])
def test_examples_run_on_the_card_by_default(name):
    port = _load(name)
    if torch.cuda.is_available():
        assert port.main([]) is not None
        return
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        port.main([])
