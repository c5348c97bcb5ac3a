"""Find a cell's pieces by name, from ``BENCHMARK.json`` and data files.

Nothing here knows a cell, a configuration, a mix or a metric by name:

* a cell (an entry of ``workloads``) names its configuration and mix;
* a configuration is the file its ``configs`` entry names: the port's
  architecture and the fields it overrides (``port``), the model as it
  runs under Hugging Face's keys (``model``, which the reference reads),
  and what was cut or assumed;
* a mix is ``bench/traffic/<mix>.json`` (see :mod:`bench.traffic`);
* a metric, end-to-end or per layer, is read by ``read(run)`` in
  ``bench/metrics/<metric>.py``.

A cell reports an end-to-end metric that lists it under ``workloads``
or lists none, and a per-layer metric that lists it, or that lists none
and moves an end-to-end metric the cell reports.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

ROOT = Path(__file__).resolve().parent.parent
BENCH_DIR = "bench"


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict          # the configuration file
    traffic: Dict         # the mix file
    end_to_end: List[Dict]
    per_layer: List[Dict]
    root: Path


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"choose from {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / BENCH_DIR / "traffic"
                          / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", ())
                 or ("workloads" not in m and m["moves"] in names)]
    return Cell(workload, int(w["chips"]), config, traffic, e2e, per_layer,
                root)


def reader(root: Path, metric: str) -> Callable:
    """``read`` of ``bench/metrics/<metric>.py`` (a metric's name may
    hold dots, so the file is loaded by its path)."""
    path = Path(root) / BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# -- the port's configuration -------------------------------------------------

def port_config(config: Dict):
    """The port's ModelConfig of a configuration file: its architecture
    with the fields of ``port.overrides`` replaced (a nested spec, such
    as ``moe``, by a dict of its own fields); checked against the
    ``model`` block that the reference runs."""
    from repro_torch.configs import get_config
    port = config["port"]
    cfg = get_config(port["arch"])
    changes = {}
    for k, v in port.get("overrides", {}).items():
        sub = getattr(cfg, k)
        changes[k] = (dataclasses.replace(sub, **v)
                      if dataclasses.is_dataclass(sub) else v)
    cfg = dataclasses.replace(cfg, **changes)
    check_port_matches(config["model"], cfg)
    return cfg


def check_port_matches(m: Dict, cfg) -> None:
    """Raise where the port's config would compute another model than
    the ``model`` block describes.  The port has no multipliers: the
    weights carry them (:func:`bench.weights.published`)."""
    moe = cfg.moe
    layernorm = "layer_norm_eps" in m
    want = {
        "n_layers": m["num_hidden_layers"], "d_model": m["hidden_size"],
        "n_heads": m["num_attention_heads"],
        "n_kv_heads": m["num_key_value_heads"],
        "resolved_head_dim": m.get("head_dim") or (
            m["hidden_size"] // m["num_attention_heads"]),
        "vocab": m["vocab_size"],
        "norm_type": "layernorm" if layernorm else "rmsnorm",
        "norm_eps": m["layer_norm_eps" if layernorm else "rms_norm_eps"],
        "rope_frac": m.get("partial_rotary_factor", 1.0),
        "rope_theta": m.get("rope_theta", 10000.0),
        "tie_embeddings": m.get("tie_word_embeddings", False),
        "qkv_bias": m.get("attention_bias", m.get("use_qkv_bias", False)),
        "ffn_type": "swiglu" if m.get("hidden_act") == "silu" else None,
        "dtype": m.get("torch_dtype", "bfloat16"),
        "scale_embed": False, "qk_norm": False, "attn_type": "gqa",
    }
    have = {k: getattr(cfg, k) for k in want}
    if moe is None:
        want["d_ff"], have["d_ff"] = m["intermediate_size"], cfg.d_ff
    else:
        want.update(n_experts=m["num_local_experts"],
                    top_k=m["num_experts_per_tok"],
                    d_ff_expert=m["intermediate_size"], n_shared=0,
                    first_dense_layers=0)
        have.update(n_experts=moe.n_experts, top_k=moe.top_k,
                    d_ff_expert=moe.d_ff_expert, n_shared=moe.n_shared,
                    first_dense_layers=moe.first_dense_layers)
    bad = {k: (have[k], want[k]) for k in want if have[k] != want[k]}
    if bad:
        raise ValueError("the port's config does not compute the model "
                         f"block's model: {bad} (port, model block)")
