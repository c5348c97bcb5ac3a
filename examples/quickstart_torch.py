"""Quickstart on the PyTorch port: train a small qwen3-family model end to
end, on a CUDA card by default.

    PYTHONPATH=src python examples/quickstart_torch.py [--steps 200] \\
        [--device cuda]

The twin of ``examples/quickstart.py``: the same flags plus ``--device``
(``cpu`` runs on the CPU), driving ``repro_torch.launch.train`` — AdamW,
the cosine schedule, the deterministic data pipeline, checkpointing,
preemption handling and the straggler monitor.  Asserts the loss
actually drops.
"""
import argparse
import sys

sys.path.insert(0, "src")

from repro_torch.launch import train as train_mod  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    losses = train_mod.main([
        "--arch", args.arch, "--reduced",
        "--steps", str(args.steps),
        "--batch", "8", "--seq", "128",
        "--ckpt-dir", "checkpoints/quickstart_torch",
        "--ckpt-every", "100",
        "--device", args.device,
    ])
    drop = losses[0] - losses[-1]
    print(f"loss drop over {args.steps} steps: {drop:.3f}")
    assert drop > 0.3, "training failed to reduce loss"
    print("QUICKSTART OK")


if __name__ == "__main__":
    main()
