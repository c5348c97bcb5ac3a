"""Guards of the port's boundaries: ``repro_torch`` and ``chip_smoke.py``
import nothing of JAX or of the JAX package, ``chip_smoke.py`` refuses
to report on a host without a CUDA card, and every entry point of the
port raises without a CUDA device unless it is asked for the CPU."""
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)(\s|\.|,|$)|from\s+(jax|repro)(\s|\.))",
    re.MULTILINE)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return env


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = ("import sys, repro_torch, repro_torch.serve, "
            "repro_torch.models, repro_torch.kernels, repro_torch.configs, "
            "repro_torch.obs.export, repro_torch.launch.serve, "
            "repro_torch.core, repro_torch.core.harness, "
            "repro_torch.kernels.gemm, repro_torch.kernels.flash_attention, "
            "repro_torch.kernels.quant_gemm, repro_torch.kernels.ssd, "
            "repro_torch.models.ssm, repro_torch.configs.mamba2_780m, "
            "repro_torch.core.tuning, repro_torch.core.tuning.pool, "
            "repro_torch.core.tuning.lessons, repro_torch.launch.tune\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), timeout=120)
    assert out.returncode == 0, out.stderr + out.stdout


def test_source_scan_finds_no_jax_or_repro_import():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        hits = FORBIDDEN.findall(f.read_text())
        assert not hits, f"{f.relative_to(REPO)} imports {hits}"
    # the pattern does catch what it is meant to catch
    for bad in ("import jax\n", "from jax import numpy\n",
                "import repro.serve\n", "from repro.models import x\n",
                "  from repro import obs\n"):
        assert FORBIDDEN.search(bad), bad
    for ok in ("import repro_torch\n", "from repro_torch.x import y\n",
               "import jaxlike\n"):
        assert not FORBIDDEN.search(ok), ok


# rates and sizes of the TPU model the JAX package's cost model uses
TPU_CONSTANTS = re.compile(r"197e12|819e9|v5e|VMEM_BYTES|16 MiB")


def test_source_scan_finds_no_tpu_constant():
    files = sorted(PORT.rglob("*.py")) + sorted(PORT.rglob("*.cu"))
    assert any(f.name == "costs.py" for f in files)
    for f in files:
        hits = TPU_CONSTANTS.findall(f.read_text())
        assert not hits, f"{f.relative_to(REPO)} names {hits}"
    for bad in ("PEAK_FLOPS = 197e12\n", "HBM_BW = 819e9\n",
                "# v5e model\n", "VMEM_BYTES = 1\n", "a 16 MiB budget\n"):
        assert TPU_CONSTANTS.search(bad), bad


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         capture_output=True, text=True, cwd=REPO,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(lone)], capture_output=True,
                         text=True, cwd=tmp_path, timeout=300,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def _entry_points():
    from repro_torch import configs, resolve_device
    from repro_torch.core.families import get_family
    from repro_torch.core.families.gemm import GemmConfig, GemmProblem
    from repro_torch.core.harness import Validator
    from repro_torch.core.tuning import make_job, run_fleet
    from repro_torch.launch import serve as launch
    from repro_torch.launch import tune
    from repro_torch.models import build, from_jax_numpy
    from repro_torch.serve import (KVPool, PagedServingEngine,
                                   ServingEngine)
    cfg = configs.get_reduced("qwen3-1.7b")
    model = build(cfg)
    ssm = build(configs.get_reduced("mamba2-780m"))
    tree = {"w": np.zeros((2, 2), np.float32)}
    job = make_job("gemm", GemmProblem(64, 64, 128, "f32"))
    out = str(Path(tempfile.gettempdir()) / "repro_torch_guard_fleet")
    return {
        "resolve_device": lambda **kw: resolve_device(**kw),
        "init": lambda **kw: model.init(0, **kw),
        "from_jax_numpy": lambda **kw: from_jax_numpy(tree, **kw),
        "init_cache": lambda **kw: model.init_cache(2, 16, **kw),
        "KVPool": lambda **kw: KVPool(model, 4, 8, **kw),
        "ServingEngine": lambda **kw: ServingEngine(
            model, {}, n_slots=1, max_len=16, **kw),
        "PagedServingEngine": lambda **kw: PagedServingEngine(
            model, {}, pool_pages=4, page_size=8, max_len=16, **kw),
        "Validator": lambda **kw: Validator(run_kernels=True, **kw),
        "reference_check": lambda **kw: get_family("gemm").reference_check(
            GemmConfig(bm=8, bn=8, bk=8), GemmProblem(8, 8, 8, "f32"),
            **kw),
        "flash_reference_check": lambda **kw: get_family(
            "flash_attention").reference_check(
            *get_family("flash_attention").example(), **kw),
        "flash_decode_reference_check": lambda **kw: get_family(
            "flash_decode").reference_check(
            *get_family("flash_decode").example(), **kw),
        "moe_reference_check": lambda **kw: get_family(
            "moe").reference_check(*get_family("moe").example(), **kw),
        "quant_gemm_reference_check": lambda **kw: get_family(
            "quant_gemm").reference_check(
            *get_family("quant_gemm").example(), **kw),
        "ssd_reference_check": lambda **kw: get_family(
            "ssd").reference_check(*get_family("ssd").example(), **kw),
        "SSMLM.init": lambda **kw: ssm.init(0, **kw),
        "SSMLM.init_cache": lambda **kw: ssm.init_cache(2, 16, **kw),
        "SSM ServingEngine": lambda **kw: ServingEngine(
            ssm, {}, n_slots=1, max_len=16, **kw),
        "launch.serve mamba2": lambda **kw: launch.main(
            ["--arch", "mamba2-780m", "--reduced", "--engine", "dense",
             "--requests", "1", "--max-new-tokens", "1", "--max-len",
             "32"] + (["--device", kw["device"]] if kw else [])),
        "launch.serve": lambda **kw: launch.main(
            ["--arch", "qwen3-1.7b", "--reduced", "--requests", "1",
             "--max-new-tokens", "1", "--max-len", "32", "--page-size",
             "8"] + (["--device", kw["device"]] if kw else [])),
        "run_fleet": lambda **kw: run_fleet(
            [job], out_dir=out, base_budget=1, max_budget=1,
            run_kernels=True, fresh=True, **kw),
        "launch.tune": lambda **kw: tune.main(
            ["--family", "gemm", "--base-budget", "1", "--max-budget", "1",
             "--out-dir", out, "--fresh"]
            + (["--device", kw["device"]] if kw else [])),
    }


@pytest.mark.parametrize("name", ["resolve_device", "init",
                                  "from_jax_numpy", "init_cache", "KVPool",
                                  "ServingEngine", "PagedServingEngine",
                                  "Validator", "reference_check",
                                  "flash_reference_check",
                                  "flash_decode_reference_check",
                                  "moe_reference_check",
                                  "quant_gemm_reference_check",
                                  "ssd_reference_check", "SSMLM.init",
                                  "SSMLM.init_cache", "SSM ServingEngine",
                                  "launch.serve", "launch.serve mamba2",
                                  "run_fleet", "launch.tune"])
def test_entry_points_need_a_card_unless_asked_for_the_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    fn = _entry_points()[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()
    fn(device="cpu")


def test_launcher_refuses_what_is_not_ported():
    """``--ckpt-dir`` (checkpoint restore) is not ported and raises;
    ``--dispatch-table`` is (``test_torch_tuning_fleet.py`` serves with
    one), and a path that holds no table fails as a missing file."""
    from repro_torch.launch import serve as launch
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        launch.main(["--arch", "qwen3-1.7b", "--reduced", "--device",
                     "cpu", "--ckpt-dir", "x"])
    with pytest.raises(FileNotFoundError):
        launch.main(["--arch", "qwen3-1.7b", "--reduced", "--device",
                     "cpu", "--dispatch-table", "no/such/table.json"])


def test_resolve_device_pins_tf32_off():
    from repro_torch import resolve_device
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    assert resolve_device("cpu").type == "cpu"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_a_failed_launch_raises_and_is_not_counted():
    """The C entry point returns cudaGetLastError(); anything but 0
    raises, and only a launch that succeeded moves the counter."""
    from repro_torch.kernels._build import CudaKernel
    k = CudaKernel("fake", REPO / "missing.cu", "fake_launch", [])
    k._fn = lambda *args: 0
    k.launch()
    assert k.launches == 1
    k._fn = lambda *args: 98          # cudaErrorInvalidDeviceFunction
    with pytest.raises(RuntimeError, match="failed to launch"):
        k.launch()
    assert k.launches == 1


def test_an_edited_header_rebuilds_the_kernels_that_include_it(
        tmp_path, monkeypatch):
    """The library's name hashes the repository headers a source
    includes (``kernels/csrc/hopper.cuh``), so editing one rebuilds; the
    compiler is given their directory.  Edits a copy of a kernel and of
    its header in tmp_path, never the repository's."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import DECODE_KERNEL
    src = tmp_path / "flash_decode.cu"
    hdr = tmp_path / "hopper.cuh"
    shutil.copy(DECODE_KERNEL.source, src)
    shutil.copy(_build.INCLUDE_DIR / "hopper.cuh", hdr)
    assert _build.included_headers(src) == [hdr.resolve()]
    assert _build.included_headers(DECODE_KERNEL.source) == \
        [(_build.INCLUDE_DIR / "hopper.cuh").resolve()]
    k = _build.CudaKernel("copy", src, "flash_decode_launch", [])
    before = k._lib_path()
    assert k._lib_path() == before                # deterministic
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    assert k._lib_path() != before
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    cmd = k._nvcc_cmd(tmp_path / "out.so")
    assert cmd[cmd.index("-I") + 1] == str(_build.INCLUDE_DIR)


def test_a_failed_build_stops_the_other_builds(tmp_path):
    """``build_all`` starts one compiler per source; when one fails it
    raises, and no other compiler process is left running."""
    from repro_torch.kernels._build import CudaKernel, build_all

    class Fake(CudaKernel):
        def __init__(self, name, code):
            super().__init__(name, tmp_path / f"{name}.cu", "f", [])
            self.code = code

        def start_build(self):
            self.proc = subprocess.Popen([sys.executable, "-c", self.code])
            return self.proc

        def finish_build(self, proc):
            if proc.wait(timeout=60) != 0:
                raise RuntimeError(f"build of {self.name} failed")

    bad = Fake("bad", "import sys; sys.exit(1)")
    slow = Fake("slow", "import time; time.sleep(120)")
    with pytest.raises(RuntimeError, match="build of bad failed"):
        build_all([bad, slow])
    assert slow.proc.poll() is not None
