"""Tree (de)serialization in the JAX package's logical checkpoint format
(its ``checkpoint/serial.py``), so that either package reads what the
other wrote.

Leaves are saved by *path* into a directory of ``.npy`` files plus an
``index.json`` of each leaf's file, shape and dtype.  Trees are nested
dicts, tuples and lists (a ``NamedTuple`` such as ``AdamWState`` keys its
fields by position: ``opt/0``, ``opt/1/...``); leaves are tensors,
numpy arrays or Python numbers.  ``.npy`` has no bfloat16, so a bfloat16
leaf is stored as its uint16 bits under the dtype name ``bfloat16`` and
read back by reinterpreting those bits (no ``ml_dtypes`` needed)."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (str(k),))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + (str(i),))
    else:
        yield prefix, tree


def _to_numpy(leaf):
    """-> (numpy array as stored, dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_pytree(tree: Any, path: Path) -> None:
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    index = {}
    for p, leaf in _flatten(tree):
        key = "/".join(p)
        arr, dtype_name = _to_numpy(leaf)
        fn = key.replace("/", "__") + ".npy"
        np.save(path / fn, arr)
        index[key] = {"file": fn, "shape": list(arr.shape),
                      "dtype": dtype_name}
    (path / "index.json").write_text(json.dumps(index, indent=1))


def load_pytree(template: Any, path: Path,
                device: DeviceLike = "cuda") -> Any:
    """Restore into the structure of ``template`` (values ignored): every
    leaf a tensor on ``device`` with the dtype it was saved in."""
    path = Path(path)
    dev = resolve_device(device)
    index = json.loads((path / "index.json").read_text())

    def build(tree, prefix=()):
        if isinstance(tree, dict):
            return {k: build(v, prefix + (str(k),))
                    for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            vals = [build(v, prefix + (str(i),))
                    for i, v in enumerate(tree)]
            return (type(tree)(*vals) if hasattr(tree, "_fields")
                    else type(tree)(vals))
        key = "/".join(prefix)
        if key not in index:
            raise KeyError(f"checkpoint missing leaf {key}")
        meta = index[key]
        arr = np.load(path / meta["file"])
        if meta["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        return t.to(dev)

    return build(template)
