"""Deterministic, resumable data pipeline — a copy of the JAX package's
``data/pipeline.py`` (numpy only), so that both packages draw the same
batch for every (seed, step).

The iterator's full position is a small state dict carried inside every
checkpoint, so restarts resume the exact token stream: the stream is
indexed by global step, never by wall-clock or host id.

The offline corpus is synthetic (a seeded Zipf-ish token source with
document structure) — the interface (``__next__`` -> batch dict,
``state()``/``restore()``) is what the trainer depends on.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # synthetic-corpus shape
    mean_doc_len: int = 512
    zipf_a: float = 1.3
    eos_id: int = 1
    pad_id: int = 0
    frontend: str = "none"           # audio_frames adds enc_embeds
    d_model: int = 0


class SyntheticLMDataset:
    """Seeded synthetic LM stream.  Deterministic in (seed, step): batch i
    is always identical, independent of how many times we stop/resume."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        self.cfg = cfg
        self._step = int(start_step)

    # -- checkpointable state ------------------------------------------------
    def state(self) -> Dict:
        return {"step": self._step, "seed": self.cfg.seed}

    def restore(self, state: Dict) -> None:
        if state.get("seed") != self.cfg.seed:
            raise ValueError("data seed mismatch on restore")
        self._step = int(state["step"])

    # -- iteration ------------------------------------------------------------
    def __iter__(self) -> Iterator[Dict]:
        return self

    def _batch_rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step]))

    def __next__(self) -> Dict:
        cfg = self.cfg
        rng = self._batch_rng(self._step)
        B, S = cfg.global_batch, cfg.seq_len
        # documents: zipf tokens with EOS boundaries (structure matters for
        # loss masking / packing tests)
        toks = rng.zipf(cfg.zipf_a, size=(B, S)).astype(np.int64)
        toks = np.clip(toks + 1, 2, cfg.vocab - 1).astype(np.int32)
        doc_len = np.maximum(
            8, rng.poisson(cfg.mean_doc_len, size=(B,))).astype(np.int32)
        pos = np.arange(S)[None, :]
        eos_mask = (pos % doc_len[:, None]) == (doc_len[:, None] - 1)
        toks = np.where(eos_mask, cfg.eos_id, toks)
        batch: Dict = {"tokens": toks}
        if cfg.frontend == "audio_frames":
            batch["enc_embeds"] = rng.standard_normal(
                (B, S, cfg.d_model)).astype(np.float32) * 0.02
        self._step += 1
        return batch


def make_dataset(model_cfg, *, seq_len: int, global_batch: int,
                 seed: int = 0) -> SyntheticLMDataset:
    return SyntheticLMDataset(DataConfig(
        vocab=model_cfg.vocab, seq_len=seq_len, global_batch=global_batch,
        seed=seed, frontend=model_cfg.frontend, d_model=model_cfg.d_model))
