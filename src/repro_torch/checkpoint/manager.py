"""Checkpoint manager: atomic, async, keep-K, resumable — the port of the
JAX package's ``checkpoint/manager.py``, on the same directory layout.

  * atomic publish — write to ``step_<n>.tmp`` then rename; a crash
    mid-write never corrupts the latest checkpoint;
  * async — serialization happens on a background thread against a host
    snapshot (``.cpu()`` of every tensor, taken before ``save`` returns),
    overlapping the next training steps;
  * keep-K retention + a persistent ``latest`` pointer;
  * the data-iterator state and step counter ride inside the checkpoint,
    so a restart resumes the exact stream;
  * logical format (``checkpoint/serial.py``): ``restore`` rebuilds the
    tensors on the device it is given.
"""
from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from repro_torch.device import DeviceLike

from .serial import load_pytree, save_pytree


def _snapshot(tree):
    """Host copies of every tensor of a tree of dicts, tuples and lists
    (a copy also of a tensor already on the host, which the caller may
    change while the write runs)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        vals = [_snapshot(v) for v in tree]
        return (type(tree)(*vals) if hasattr(tree, "_fields")
                else type(tree)(vals))
    return tree


class CheckpointManager:
    def __init__(self, directory, *, keep: int = 3, async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ------------------------------------------------------------------
    def save(self, step: int, state: Dict[str, Any]) -> None:
        """state: {"params": ..., "opt": ..., "data": dict, "meta": dict}."""
        self.wait()
        # snapshot to host memory synchronously (cheap vs serialization)
        snapshot = _snapshot(state)
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, snapshot), daemon=True)
            self._thread.start()
        else:
            self._write(step, snapshot)

    def _write(self, step: int, snapshot: Dict) -> None:
        try:
            tmp = self.dir / f"step_{step:010d}.tmp"
            final = self.dir / f"step_{step:010d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            meta = {"step": step, "time": time.time()}
            meta.update(snapshot.get("meta", {}))
            save_pytree({k: v for k, v in snapshot.items() if k != "meta"},
                        tmp)
            (tmp / "meta.json").write_text(json.dumps(meta))
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)                       # atomic publish
            (self.dir / "latest").write_text(final.name)
            self._gc()
        except BaseException as e:  # surfaced on next wait()
            self._error = e

    def _gc(self) -> None:
        ckpts = sorted(self.dir.glob("step_*"))
        ckpts = [c for c in ckpts if c.is_dir()
                 and not c.name.endswith(".tmp")]
        for old in ckpts[:-self.keep]:
            shutil.rmtree(old, ignore_errors=True)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from e

    # -- restore ---------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        ptr = self.dir / "latest"
        if not ptr.exists():
            return None
        name = ptr.read_text().strip()
        if not (self.dir / name).exists():
            return None
        return int(name.split("_")[1])

    def restore(self, template: Dict[str, Any], step: Optional[int] = None,
                device: DeviceLike = "cuda") -> Dict[str, Any]:
        """The checkpoint at ``step`` (default: the latest) in the
        structure of ``template``, every tensor on ``device``, and its
        "meta" dict."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        path = self.dir / f"step_{step:010d}"
        state = load_pytree({k: v for k, v in template.items()
                             if k != "meta"}, path, device=device)
        state["meta"] = json.loads((path / "meta.json").read_text())
        return state
