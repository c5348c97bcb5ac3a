"""The training launcher under ``torch.distributed.run`` on gloo ranks
(``--device cpu``): its checkpoint resumes in one process."""
import os
import subprocess
import sys

from dist_cases import REPO


def test_launcher_under_torch_distributed_run_resumes_in_one_process(
        tmp_path):
    """``launch.train`` on 2 gloo ranks writes a checkpoint that one
    process resumes from: the chain's losses follow an uninterrupted
    single-process run (bf16 weights, whose one-ulp flips the ranks' sum
    order may cause: within 1e-3 of each loss)."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "qwen3-1.7b", "--reduced", "--device", "cpu", "--batch", "4",
            "--seq", "16", "--log-every", "1", "--ckpt-every", "2"]
    # --standalone: a local rendezvous on a free port
    dist_run = [sys.executable, "-m", "torch.distributed.run",
                "--standalone", "--nproc-per-node", "2"]

    def losses(cmd):
        out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                             timeout=240)
        assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
        return [float(line.split()[3]) for line in out.stdout.splitlines()
                if line.startswith("step ")]
    ck = str(tmp_path / "chain")
    a = losses(dist_run + base[1:] + ["--steps", "2", "--ckpt-dir", ck])
    b = losses(base + ["--steps", "4", "--ckpt-dir", ck, "--resume"])
    ref = losses(base + ["--steps", "4", "--ckpt-dir",
                         str(tmp_path / "ref")])
    chain = a + b
    assert len(a) == len(b) == 2 and len(ref) == 4
    for x, y in zip(chain, ref):
        assert abs(x - y) <= 1e-3 * abs(y), (chain, ref)
