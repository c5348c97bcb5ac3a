"""Find a cell's pieces by name, from ``BENCHMARK.json`` and data files.

Nothing here knows a cell, a configuration, a mix, a metric or an
architecture by name:

* a cell (an entry of ``workloads``) names its configuration and mix;
* a configuration is the file its ``configs`` entry names: the port's
  architecture and the fields it overrides (``port``), the model as it
  runs under Hugging Face's keys (``model``), what was cut or assumed,
  and its family module (``family``, a path under the checkout, such as
  ``bench/families/decoder.py``), the one piece that reads ``model``:
  the port fields it fixes, the weights as published, the reference and
  the work counts (see :mod:`bench.families.decoder`);
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
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
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
    family: ModuleType    # the configuration's family module


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
                root, family(config, root))


def _load(path: Path, name: str) -> ModuleType:
    """The module of the file ``path``, loaded by its path as ``name``
    (registered, as a dataclass in it needs)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(root: Path, metric: str) -> Callable:
    """``read`` of ``bench/metrics/<metric>.py`` (a metric's name may
    hold dots, so the file is loaded by its path)."""
    path = Path(root) / BENCH_DIR / "metrics" / f"{metric}.py"
    return _load(path, f"bench_metric_{metric.replace('.', '_')}").read


def family(config: Dict, root: Path = ROOT) -> ModuleType:
    """The family module a configuration names under ``family``: a path
    under ``root``, loaded by its path.  It exports ``port_fields``,
    ``published``, ``Reference``, ``shape`` and ``KERNELS`` (see
    :mod:`bench.families.decoder`)."""
    if "family" not in config:
        raise ValueError(
            f"configuration {config.get('name')!r} names no family module: "
            "give its path under the key 'family', such as "
            "\"bench/families/decoder.py\"")
    root = Path(root).resolve()
    path = (root / config["family"]).resolve()
    if root not in path.parents or not path.is_file():
        raise ValueError(f"configuration {config.get('name')!r}: family "
                         f"{config['family']!r} is no file under {root}")
    return _load(path, f"bench_family_{path.stem}")


# -- the port's configuration -------------------------------------------------

def port_config(config: Dict, root: Path = ROOT):
    """The port's ModelConfig of a configuration file: its architecture
    with the fields of ``port.overrides`` replaced (a nested spec, such
    as ``moe``, by a dict of its own fields); checked against the fields
    that the configuration's family reads off the ``model`` block."""
    from repro_torch.configs import get_config
    port = config["port"]
    cfg = get_config(port["arch"])
    changes = {}
    for k, v in port.get("overrides", {}).items():
        sub = getattr(cfg, k)
        changes[k] = (dataclasses.replace(sub, **v)
                      if dataclasses.is_dataclass(sub) else v)
    cfg = dataclasses.replace(cfg, **changes)
    check_port_matches(family(config, root).port_fields(config["model"]),
                       cfg)
    return cfg


def _pairs(want: Dict, have, prefix: str = ""):
    """(field, port's value, wanted value) of each field of ``want``; a
    dict is a nested spec, named ``<spec>.<field>``, whose fields read
    None where the port has no such spec."""
    for k, w in want.items():
        h = None if have is None else getattr(have, k)
        if isinstance(w, dict):
            yield from _pairs(w, h, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", h, w


def check_port_matches(fields: Dict, cfg) -> None:
    """Raise where the port's config would compute another model than
    the ``model`` block describes: ``fields`` (a family's
    ``port_fields``) against ``cfg``."""
    bad = {k: (h, w) for k, h, w in _pairs(fields, cfg) if h != w}
    if bad:
        raise ValueError("the port's config does not compute the model "
                         f"block's model: {bad} (port, model block)")
