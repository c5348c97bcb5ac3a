"""Serving launcher: a continuous-batching engine over a seeded model, on
a CUDA card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        [--reduced] [--engine paged] [--requests 16] [--slots 4] \\
        [--pool-pages N] [--dispatch-table dispatch_table.json] \\
        [--device cuda]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \\
        --engine dense [--reduced] [--device cuda]

``--arch`` takes the decoder-only architectures of
``repro_torch.configs``: qwen3-1.7b, codeqwen1.5-7b, stablelm-3b,
gemma-7b, chameleon-34b, granite-moe-3b-a800m, deepseek-v2-lite-16b,
mamba2-780m and recurrentgemma-2b.  The encoder-decoder
seamless-m4t-large-v2 is refused: the engines prefill token prompts,
and its prefill takes frame embeddings and returns a cache only.

The port of the JAX package's ``launch/serve.py``.  It builds the model,
initialises its weights from ``--seed`` with ``torch.Generator``s,
spins the chosen engine — ``--engine paged`` (default) runs the
block-table KV-pool engine with chunked prefill and headroom admission
on its kernel paths (the CUDA ragged-prefill and paged-decode kernels);
``--engine dense`` the per-slot slab baseline — and reports completion,
throughput and the engine's metrics snapshot.  ``--device cpu`` runs
the kernels' plain versions on the CPU.  An MLA cache
(deepseek-v2-lite-16b) holds a latent a position, with no heads axis:
the paged engine serves it on its gather paths, as in the JAX package.
The SSM family (mamba2-780m) and the hybrid family (recurrentgemma-2b)
have no growing KV cache to page: they serve through ``--engine dense``
only, as in the JAX package, whose paged engine refuses them too, and
decode from the zeroed state that their ``prefill`` returns, as there
(ROADMAP section C).

``--dispatch-table FILE`` loads a fleet tuner's ``dispatch_table.json``
(``python -m repro_torch.launch.tune`` writes one), prints its summary
and hands it to the engine, which installs it: every validated kernel
entry point then takes the table's config for its problem's shape
bucket, verified at the exact problem, before its default.

``--ckpt-dir DIR`` (default ``checkpoints/<config name>``): when the
directory holds a checkpoint, the latest one's params are served in place
of the seeded init, as in the JAX package — one that
``python -m repro_torch.launch.train`` or the JAX package's trainer
wrote (the two share the format).

Observability: ``--metrics-port N`` serves the live metrics snapshot in
Prometheus text format at ``http://127.0.0.1:N/metrics`` (port 0 picks a
free one); ``--trace-out FILE`` enables span tracing and dumps the
Perfetto-loadable Chrome trace on shutdown; while it is on, a
``torch.profiler`` that records also gets the program's spans (the
engine's ``serve.*``, the model's ``model.*``) as ranges on its
timeline, so they label the device trace.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import configs, obs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.device import resolve_device
from repro_torch.models import build
from repro_torch.serve import PagedServingEngine, Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore the latest checkpoint's params from "
                         "here (default checkpoints/<config name>, read "
                         "when present)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--engine", choices=("paged", "dense"),
                    default="paged")
    ap.add_argument("--slots", type=int, default=4,
                    help="dense: cache slots; paged: decode batch width")
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="physical KV pages (default: 3/4 of the dense "
                         "slot reservation)")
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dispatch-table", default=None,
                    help="fleet tuner dispatch_table.json with tuned "
                         "kernel configs (python -m "
                         "repro_torch.launch.tune)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus text metrics on this port "
                         "(0 = pick a free one)")
    ap.add_argument("--trace-out", default=None,
                    help="enable span tracing; dump the Perfetto trace "
                         "file here on shutdown")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get_config(args.arch))
    if cfg.family in ("encdec", "audio"):
        raise NotImplementedError(
            f"{cfg.name}: the serving engines prefill token prompts, but an "
            "encoder-decoder model prefills from the encoder's frame "
            "embeddings and returns a cache only (EncDecLM.prefill); the "
            "JAX package's engines fail on it too")
    if args.engine == "paged" and cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"--engine paged: {cfg.name} keeps recurrent state (and, for "
            "the hybrid family, fixed-size attention rings), not a KV cache "
            "to page, and the JAX package's paged engine refuses it as "
            "well; use --engine dense, which decodes from the zeroed state "
            "their prefill returns (ROADMAP section C)")
    model = build(cfg)
    params = model.init(args.seed, device=device)
    ckpt_dir = Path(args.ckpt_dir or f"checkpoints/{cfg.name}")
    if ckpt_dir.is_dir():
        mgr = CheckpointManager(ckpt_dir)
        if mgr.latest_step() is not None:
            state = mgr.restore({"params": params}, device=device)
            params = state["params"]
            print(f"restored step {state['meta']['step']} from {ckpt_dir}")
    table = None
    if args.dispatch_table:
        from repro_torch.core.tuning import load_dispatch_table
        table = load_dispatch_table(args.dispatch_table)
        print(f"dispatch table: {table.summary()}")

    if args.engine == "paged":
        pool_pages = args.pool_pages or max(
            2, args.slots * args.max_len * 3 // (4 * args.page_size))
        eng = PagedServingEngine(
            model, params, pool_pages=pool_pages,
            page_size=args.page_size, max_batch=args.slots,
            max_len=args.max_len, prefill_chunk=args.prefill_chunk,
            eos_id=-1, dispatch_table=table, decode_path="kernel",
            prefill_path="kernel", device=device)
    else:
        eng = ServingEngine(model, params, n_slots=args.slots,
                            max_len=args.max_len, eos_id=-1,
                            dispatch_table=table, device=device)
    if args.trace_out:
        obs.enable()
    server = None
    if args.metrics_port is not None:
        from repro_torch.obs.export import MetricsServer, prometheus_text
        server = MetricsServer(
            lambda: prometheus_text(eng.metrics.snapshot()),
            port=args.metrics_port)
        print(f"metrics: http://127.0.0.1:{server.port}/metrics")

    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        plen = int(rng.integers(4, args.max_len // 4))
        eng.submit(Request(
            rid, rng.integers(2, cfg.vocab, size=plen).tolist(),
            max_new_tokens=args.max_new_tokens))

    t0 = time.perf_counter()
    try:
        done = eng.run()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    finally:
        if server is not None:
            server.close()
        if args.trace_out:
            obs.tracer().save(args.trace_out)
            obs.disable()
            print(f"trace: {args.trace_out} "
                  f"({len(obs.tracer().events())} spans — load in "
                  f"Perfetto / chrome://tracing)")
    dt = time.perf_counter() - t0
    new_tokens = sum(len(r.output) for r in done)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"{len(done)}/{args.requests} requests complete, "
          f"{new_tokens} tokens in {dt:.2f}s "
          f"({new_tokens / dt:.1f} tok/s on {where})")
    q = eng.metrics.latency_quantiles()
    print("latency (ticks; step_time and *_us µs): " + ", ".join(
        f"{k} p50={v['p50']} p95={v['p95']} p99={v['p99']}"
        for k, v in q.items()))
    print("metrics:", json.dumps(eng.metrics.snapshot(), sort_keys=True))
    if len(done) != args.requests:
        raise RuntimeError(f"{len(done)} of {args.requests} requests "
                           "finished")
    return done


if __name__ == "__main__":
    main()
