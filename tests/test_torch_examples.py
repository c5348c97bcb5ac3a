"""The port's example twins against their JAX originals, on the CPU:
``examples/figure1_dsl_torch.py`` prints the JAX script's two reports
(the valid Figure-1 program's and the mis-lowered GQA head mapping's
counterexample) text for text, and ``examples/serve_demo_torch.py``
completes the same 12 requests with the same prompts and token budgets
as ``examples/serve_demo.py`` (the tokens differ: each package draws its
own random weights).  Both twins take ``--device`` (default ``cuda``)
and run here with ``--device cpu``; without a card the default raises."""
import importlib.util
from pathlib import Path

import pytest
import torch

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_figure1_dsl_twin_prints_the_jax_reports(capsys):
    jax_demo, twin = _load("figure1_dsl"), _load("figure1_dsl_torch")
    for bad in (False, True):
        want = jax_demo.check(jax_demo.build(wrong_kv_head=bad))
        got = twin.check(twin.build(wrong_kv_head=bad))
        assert got.ok == want.ok == (not bad)
        assert got.render() == want.render()
    jax_demo.main()
    want = capsys.readouterr().out
    twin.main(["--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want and got.rstrip().endswith("FIGURE-1 DSL DEMO OK")


def test_serve_demo_twin_completes_the_same_requests(capsys):
    jax_demo, twin = _load("serve_demo"), _load("serve_demo_torch")
    jax_demo.main()
    want = capsys.readouterr().out.splitlines()
    done = twin.main(["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert len(done) == 12 and got[-1] == want[-1] == "SERVE DEMO OK"
    # the same prompts' lengths and token budgets, request by request
    strip = [ln.split(":")[0] + ln.split(":")[1] for ln in want[:-1]]
    assert [ln.split(":")[0] + ln.split(":")[1] for ln in got[:-1]] == strip
    assert all(len(r.output) == r.max_new_tokens for r in done)


@pytest.mark.skipif(torch.cuda.is_available(), reason="has a CUDA card")
def test_the_twins_default_to_the_card():
    for name in ("figure1_dsl_torch", "serve_demo_torch"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _load(name).main([])
