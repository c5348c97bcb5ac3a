"""The readings a cell's correctness limit is set from, on the card.

    python3 bench/calibrate.py --workload <name> --seconds <s> \\
        --seeds <n> ... [--control-seeds <n> ...]

In one process, for each seed: one run of the cell (set-up, a window of
``--seconds`` at the cell's own load, the check), printing the numbers
of :func:`bench.check.gap_stats` that the program's sound run gives and
its verdict; for each control seed also the control's numbers on the
same sample of requests (the reference in float8 put in the program's
place, :func:`bench.check.control_stats`) and the verdict that
:func:`bench.check.verdict` gives them, which has to be not correct.  A
limit in the configuration file lies between the program's largest
reading and the control's smallest (PERF.md gives both).  One JSON line
per seed.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    if sys.path and Path(sys.path[0]).resolve() == ROOT / "bench":
        sys.path.pop(0)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from bench import check, harness, spec
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload, ROOT)
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = harness.run_cell(cell, seed, args.seconds, False, "cuda")
        line = {"seed": seed, "correct": out["correct"],
                "program": out["stats"],
                "served_tokens": out["checks"]["served_tokens_checked"]
                ["value"], "requests": len(out["sample"])}
        if seed in args.control_seeds:
            stats = check.control_stats(
                cell, out["params"], out["sample"],
                int(cell.config["check"]["tokens_per_request"]))
            line["control"] = stats
            line["control_correct"] = check.verdict(
                cell, stats, out["sample"], 0)["correct"]
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del out
    return 0


if __name__ == "__main__":
    sys.exit(main())
