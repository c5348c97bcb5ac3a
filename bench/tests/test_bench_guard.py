"""bench/run.py refuses to report where it must: JAX or the JAX package
loaded (top-level names compared whole), no card, no port."""
import json
import shutil
import subprocess
import sys

import pytest

import tiny
from bench import run


@pytest.mark.parametrize("names, bad", [
    (["repro_torch", "repro_torch.serve", "torch", "numpy"], []),
    (["repro_torch", "repro.core"], ["repro.core"]),
    (["repro"], ["repro"]),
    (["jax", "jax.numpy"], ["jax", "jax.numpy"]),
    (["jaxlib.xla_client", "flax.linen"], ["flax.linen", "jaxlib.xla_client"]),
    (["jaxtyping", "reprox", "repro_torchx", "flaxen"], []),
])
def test_forbidden_modules_compare_top_level_names_whole(names, bad):
    assert run.forbidden_modules(names) == bad


def test_no_card_no_result(capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "path", list(sys.path))
    rc = run.main(["--workload", "stablelm-3b.batch-decode", "--seed", "1",
                   "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_only_the_benchmark_files_no_result(tmp_path):
    shutil.copytree(tiny.ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(tiny.ROOT / "BENCHMARK.json", tmp_path)
    cmd = json.loads((tmp_path / "BENCHMARK.json").read_text())["command"]
    p = subprocess.run(
        [sys.executable, *cmd[1:], "--workload", "stablelm-3b.batch-decode",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout == ""
