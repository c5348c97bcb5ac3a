"""Peaks of the chip and the work a serving tick needs.

The peaks are NVIDIA's H100 SXM data sheet (dense, no sparsity), as
``chip_smoke.py`` has them.  The counts are of the work the tokens
*need*, from the configuration and the tokens alone, whatever computes
it: each weight read once a tick in the configuration's type, each
row's keys and values read once at its length, only the top-k experts
of a token multiplied, and the unembedding only for the rows whose
logits the engine reads.  A padded, capacity-dispatched or repeated
computation therefore counts no more than a tight one.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Sequence

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def bound_s(flops: float, n_bytes: float, dtype: str = "bfloat16") -> float:
    """The least time the chip could take: the larger of the operations
    over the peak rate and the bytes over HBM's bandwidth."""
    return max(flops / PEAK_FLOPS[dtype], n_bytes / HBM_BYTES_PER_S)


@dataclass(frozen=True)
class Shape:
    """The sizes of a decoder that the counts read (Hugging Face keys of
    a configuration file's ``model`` block)."""
    layers: int
    d_model: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    experts: int = 0
    top_k: int = 0
    dtype: str = "bfloat16"

    @classmethod
    def of(cls, m: Dict) -> "Shape":
        heads = int(m["num_attention_heads"])
        return cls(layers=int(m["num_hidden_layers"]),
                   d_model=int(m["hidden_size"]), heads=heads,
                   kv_heads=int(m["num_key_value_heads"]),
                   head_dim=int(m.get("head_dim")
                                or int(m["hidden_size"]) // heads),
                   d_ff=int(m["intermediate_size"]),
                   vocab=int(m["vocab_size"]),
                   experts=int(m.get("num_local_experts", 0)),
                   top_k=int(m.get("num_experts_per_tok", 0)),
                   dtype=m.get("torch_dtype", "bfloat16"))

    @property
    def elt(self) -> int:
        return DTYPE_BYTES[self.dtype]

    @property
    def attn_params(self) -> int:
        """q, k, v and o projections of one layer."""
        return self.d_model * self.head_dim * (2 * self.heads
                                               + 2 * self.kv_heads)

    @property
    def expert_params(self) -> int:
        """One gated FFN (gate, up, down): an expert's, or the dense
        FFN's."""
        return 3 * self.d_model * self.d_ff

    @property
    def router_params(self) -> int:
        return self.d_model * self.experts

    @property
    def kv_bytes(self) -> int:
        """Key and value bytes of one token in one layer."""
        return 2 * self.kv_heads * self.head_dim * self.elt

    def ffn_per_token(self) -> int:
        """FFN parameters one token multiplies in one layer."""
        if self.experts:
            return self.top_k * self.expert_params + self.router_params
        return self.expert_params

    def ffn_read(self, tokens: int) -> int:
        """FFN parameters a tick reads in one layer for ``tokens``
        tokens: an expert only where some token can be routed to it."""
        if self.experts:
            used = min(self.experts, self.top_k * tokens)
            return used * self.expert_params + self.router_params
        return self.expert_params


def tick_work(shape: Shape, *, decode_lengths: Sequence[int] = (),
              prefill_spans: Iterable = (), logits_rows: int = 0):
    """(FLOPs, bytes) one tick needs.

    ``decode_lengths``: each decode row's length, the token it writes
    included; ``prefill_spans``: (prefix, chunk) token counts of each
    prompt chunk; ``logits_rows``: rows whose logits the engine reads."""
    s = shape
    spans = list(prefill_spans)
    n_dec = len(decode_lengths)
    n_pre = sum(n for _, n in spans)
    tokens = n_dec + n_pre
    if tokens == 0:
        return 0.0, 0.0
    # attention pairs: a decode row's query against each of its keys; a
    # chunk's query at position q against the q + 1 keys up to it
    pairs = sum(decode_lengths) + sum(
        (p + 1 + p + n) * n // 2 for p, n in spans)
    per_token = s.attn_params + s.ffn_per_token()
    flops = s.layers * (2 * per_token * tokens
                        + 4 * s.heads * s.head_dim * pairs)
    flops += 2 * s.d_model * s.vocab * logits_rows
    weights = s.layers * (s.attn_params + s.ffn_read(tokens))
    weights += s.d_model * s.vocab * (logits_rows > 0)
    kv_read = sum(decode_lengths) + sum(p + n for p, n in spans)
    n_bytes = (weights * s.elt + tokens * s.d_model * s.elt
               + s.layers * s.kv_bytes * (kv_read + tokens)
               + logits_rows * s.vocab * 4)
    return float(flops), float(n_bytes)


def paged_decode_work(shape: Shape, lengths: Sequence[int]):
    """(FLOPs, bytes) of one ``paged_decode`` call (one layer): each
    row's keys and values at its length read once, its queries read and
    its output written once."""
    s = shape
    total = sum(lengths)
    flops = 4 * s.heads * s.head_dim * total
    n_bytes = (total * s.kv_bytes
               + 2 * len(lengths) * s.heads * s.head_dim * s.elt)
    return float(flops), float(n_bytes)


def ragged_prefill_work(shape: Shape, spans: Iterable):
    """(FLOPs, bytes) of one ``ragged_prefill`` call (one layer): the
    admitted (query, key) pairs times the heads times 4 · head_dim, and
    the packed queries, keys, values and output each moved once."""
    s = shape
    spans = list(spans)
    pairs = sum((p + 1 + p + n) * n // 2 for p, n in spans)
    tq = sum(n for _, n in spans)
    tk = sum(p + n for p, n in spans)
    flops = 4 * s.heads * s.head_dim * pairs
    n_bytes = (tk * s.kv_bytes + 2 * tq * s.heads * s.head_dim * s.elt)
    return float(flops), float(n_bytes)
