"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine that holds the card(s) the
cell asks for.  The last line on standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared beside its limit, which also end standard error.

Exits 2 without a result where no CUDA card, or fewer than the cell
asks for, is present, or the checkout lacks the port; 3 where, once
the window has closed, a module of JAX or of the JAX package is loaded.
Every cache of a build goes under ``build/`` in the checkout.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# top-level module names that may not be loaded: JAX and the JAX package
# (compared whole: "repro_torch" is the port, "repro" the JAX package)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names) -> list:
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    # one process driving the card from one thread: no spinning pool of
    # host threads beside the engine's loop
    os.environ["OMP_NUM_THREADS"] = "1"
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("bench: the checkout holds no src/repro_torch", file=sys.stderr)
        return 2
    # the script's own directory would shadow top-level modules
    if sys.path and Path(sys.path[0]).resolve() == ROOT / "bench":
        sys.path.pop(0)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch
    torch.set_num_threads(1)
    from bench import spec
    cell = spec.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"bench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    from bench import harness, report
    dev = torch.device("cuda", 0)
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           dev, t_process=T_PROCESS)
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"bench: loaded in the process once the window closed: {bad}",
              file=sys.stderr)
        return 3
    res = report.line(cell, out, bool(args.trace), dev)
    for s in report.check_lines(res["checks"]):
        print(s, file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
