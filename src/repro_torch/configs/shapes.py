"""The dry-run's input-shape sets and ``input_specs`` — the port of the
JAX package's ``configs/shapes.py``.

Every LM arch pairs with four cells:
    train_4k     seq 4,096   global_batch 256   -> train_step
    prefill_32k  seq 32,768  global_batch 32    -> serve prefill
    decode_32k   seq 32,768  global_batch 128   -> serve_step (1 new token,
                                                  KV cache of 32k)
    long_500k    seq 524,288 global_batch 1     -> serve_step; SSM/hybrid
                                                  only (O(1) state) — pure
                                                  full-attention archs skip

``input_specs`` returns :class:`~repro_torch.models.params.ShapeDtype`
stand-ins only (``jax.ShapeDtypeStruct``'s counterpart): no allocation.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from repro_torch.models.components import dtype_of
from repro_torch.models.params import ShapeDtype


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    mode: str                    # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

# archs whose decode state is O(1) in context — the only long_500k runners
LONG_CONTEXT_ARCHS = ("recurrentgemma-2b", "mamba2-780m")


def supports_cell(arch_name: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch_name in LONG_CONTEXT_ARCHS
    return True


def input_specs(model, cell: ShapeCell, *, frontend: str = "none") -> Dict:
    """ShapeDtype inputs for (model, cell), keyed as the train, prefill
    and serve steps take them."""
    cfg = model.cfg
    B, S = cell.global_batch, cell.seq_len
    i32 = torch.int32
    dt = dtype_of(cfg.dtype)
    tok = lambda b, s: ShapeDtype((b, s), i32)

    if cell.mode == "train":
        specs: Dict = {"tokens": tok(B, S)}
        if frontend == "audio_frames":
            specs["enc_embeds"] = ShapeDtype((B, S, cfg.d_model), dt)
        return specs

    if cell.mode == "prefill":
        specs = {"tokens": tok(B, S)}
        if frontend == "audio_frames":
            specs = {"enc_embeds": ShapeDtype((B, S, cfg.d_model), dt)}
        return specs

    # decode: one new token against a length-S cache
    if frontend == "audio_frames":
        cache = model.cache_shape(B, S, S)
    else:
        cache = model.cache_shape(B, S)
    return {
        "tokens": tok(B, 1),
        "cache": cache,
        "pos": ShapeDtype((), i32),
    }
