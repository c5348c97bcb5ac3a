"""Batched serving demo on the PyTorch port: continuous batching over a
mixed request stream, on a CUDA card by default.

    PYTHONPATH=src python examples/serve_demo_torch.py [--device cuda]

The twin of ``examples/serve_demo.py``: the same output, plus
``--device`` (``cpu`` runs the kernels' plain versions on the CPU).
Builds a reduced model, submits 12 requests of varying prompt/output
lengths to ``repro_torch.serve.ServingEngine`` (4 decode slots), and
verifies every request completes with the requested token budget.
"""
import argparse
import sys

sys.path.insert(0, "src")

import numpy as np  # noqa: E402

from repro_torch import configs, resolve_device  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.serve import Request, ServingEngine  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = configs.get_reduced("qwen3-1.7b")
    model = build(cfg)
    params = model.init(0, device=device)
    eng = ServingEngine(model, params, n_slots=4, max_len=96, eos_id=-1,
                        device=device)

    rng = np.random.default_rng(0)
    for rid in range(12):
        plen = int(rng.integers(4, 24))
        prompt = rng.integers(2, cfg.vocab, size=plen).tolist()
        eng.submit(Request(rid, prompt,
                           max_new_tokens=int(rng.integers(4, 16))))

    done = eng.run()
    assert len(done) == 12, f"only {len(done)} of 12 completed"
    for r in sorted(done, key=lambda r: r.rid):
        print(f"req {r.rid:2d}: prompt {len(r.prompt):2d} toks -> "
              f"{len(r.output):2d} new toks: {r.output[:8]}...")
    print("SERVE DEMO OK")
    return done


if __name__ == "__main__":
    main()
