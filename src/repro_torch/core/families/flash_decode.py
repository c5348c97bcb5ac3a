"""Flash-decode kernel family (split-KV serving attention) — the
extension of the flash-attention family to one query token.

The port of the JAX package's ``core/families/flash_decode.py``.  The
tile program (:func:`build_flash_decode_program`: steps ``(bh, s)``, each
reducing its KV span to a partial (m, l, o) that a combine merges), the
skills, the injectable bugs and their signatures are copied unchanged,
so the port's gate gives the JAX gate's verdicts, findings and
counterexamples.  Invariants: GQA head mapping, KV-range partition (the
spans read across splits tile the cache exactly once), and partial-output
honesty (each split's partial carries its own KV-span tag).

The structural, cost and speed-of-light hooks are a Hopper model of the
CUDA kernel (``repro_torch/kernels/flash_attention/csrc/
flash_decode.cu``): one CTA per (span, KV head, batch row) runs the G
program steps (bh, s) of the query heads that share that KV head
together, reading the span once instead of G times, in 16 KB tiles.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .. import dsl
from ..costs import (CostEstimate, HBM_BW, PEAK_FLOPS, sol_estimate,
                     stream_eff, wave_eff)
from ..kernelspec import (DTYPE_BYTES, N_SMS, StructuralIssue, cdiv,
                          check_vector_alignment, ctas_per_sm)
from ..tags import Expr, make_tag
from .base import (BugSignature, KernelFamily, generic_skill,
                   reference_setup, register)

@dataclass(frozen=True)
class FlashDecodeProblem:
    batch: int
    q_heads: int
    kv_heads: int
    seq_kv: int            # cache length
    head_dim: int
    dtype: str = "bf16"

    @property
    def group(self) -> int:
        return self.q_heads // self.kv_heads


@dataclass(frozen=True)
class FlashDecodeConfig:
    kv_splits: int = 8     # parallel KV partitions (occupancy for Sq=1)

    def name(self) -> str:
        return f"fdec[s={self.kv_splits}]"


def build_flash_decode_program(cfg: FlashDecodeConfig,
                               prob: FlashDecodeProblem,
                               *, inject_bug: Optional[str] = None
                               ) -> dsl.TileProgram:
    """Split-KV decode: each grid step (bh, s) reduces its KV span to a
    partial (m, l, o); the XLA epilogue merges partials.

    Invariants: GQA head mapping (as in the prefill family), **KV-range
    partition** — the spans read across splits must tile the cache exactly
    once (modeled by staging each span into a read-marker tensor and
    reusing the coverage/disjointness machinery), and partial-output
    honesty (each split's partial carries its own KV-span tag).
    Injectable bugs: "wrong_kv_head", "split_overlap" (half-stride spans
    double-read the head of the cache), "partial_mislabel" (partial stored
    at a different split index)."""
    p = dsl.TileProgram(cfg.name())
    B, H, HK = prob.batch, prob.q_heads, prob.kv_heads
    S, D = prob.seq_kv, prob.head_dim
    G = prob.group
    ns = cfg.kv_splits
    span = cdiv(S, ns)

    bh = p.add_grid("bh", B * H, "parallel")
    s = p.add_grid("s", ns, "parallel")

    p.tensor("Q", (B, H, 1, D), prob.dtype,
             tag_fn=lambda b, h, r, c: make_tag(b, h // G, r, c))
    p.tensor("K", (B, HK, S, D), prob.dtype)
    p.tensor("V", (B, HK, S, D), prob.dtype)
    # read-marker: records which cache rows each split consumed
    p.tensor("KV_READ", (B * H, S, D), prob.dtype, kind="output")
    p.tensor("O_PART", (B * H, ns, D), "f32", kind="output")

    b = bh // H
    h = bh % H
    hk = (bh % H) if inject_bug == "wrong_kv_head" else (bh % H) // G
    if inject_bug == "wrong_kv_head" and H == HK:
        raise ValueError("wrong_kv_head requires GQA")

    k0 = s * (span // 2) if inject_bug == "split_overlap" else s * span

    q = p.squeeze(p.load("Q", (b, h, 0, 0), (1, 1, 1, D)), keep=(2,))
    k = p.squeeze(p.load("K", (b, hk, k0, 0), (1, 1, span, D)))
    v = p.squeeze(p.load("V", (b, hk, k0, 0), (1, 1, span, D)))

    # GQA pairing (components: batch, kv-group, head-dim coordinate)
    p.assert_conform(q, k, bind=((1, 1),), components=((0, 1, 3),
                                                       (0, 1, 3)))
    # KV-range partition: the spans must tile the cache exactly once
    p.store("KV_READ", k, (bh, k0, 0))
    p.assert_disjoint_writes("KV_READ", axes=("bh", "s"))
    p.assert_coverage("KV_READ")

    st = p.matmul(q, p.transpose(k),
                  retag=lambda i, j: make_tag(b, hk, k0 + j))
    pt = p.elementwise("exp_sub_m", st,
                       retag=lambda i, j: make_tag(b, hk, k0 + j))
    p.assert_conform(pt, v, bind=((1, 0),), components=((0, 1, 2),
                                                        (0, 1, 2)))
    o_tag = lambda i, c: make_tag(bh, Expr.of(s), c)
    o = p.matmul(pt, v, retag=o_tag)
    s_out = ((s + 1) % ns) if inject_bug == "partial_mislabel" else s
    p.store("O_PART", o, (bh, s_out, 0))
    # store-slot honesty: a permuted slot assignment is still disjoint AND
    # covering, so coverage alone cannot catch it — the value's split tag
    # must equal the slot it lands in (the combine reads slot s expecting
    # split s's statistics)
    slot = p.elementwise("slot_id", o,
                         retag=lambda i, c: make_tag(bh, Expr.of(s_out), c))
    p.assert_conform(o, slot, bind=((0, 0), (1, 1)),
                     components=((0, 1), (0, 1)))
    p.assert_disjoint_writes("O_PART", axes=("bh", "s"))
    p.assert_coverage("O_PART")
    return p


# -- the CUDA kernel's decomposition -----------------------------------------

MAX_GROUP = 8            # query heads per KV head one CTA serves
HEAD_DIMS = (64, 128)    # head dims the kernel is compiled for
KERNEL_THREADS = 128


def tile_tokens(head_dim: int, itemsize: int) -> int:
    """Positions of K (and of V) one step stages: 16 KB, at most 64."""
    return min(64, 16384 // (head_dim * itemsize))


def structural_flash_decode(cfg: FlashDecodeConfig,
                            prob: FlashDecodeProblem):
    """Hopper model of ``flash_decode.cu``: splits that do not tile the
    cache, a geometry it is not compiled for, rows that are not 16-byte
    aligned (it reads the cache in 16-byte vectors)."""
    span = cdiv(prob.seq_kv, cfg.kv_splits)
    issues = []
    if span * cfg.kv_splits != prob.seq_kv:
        issues.append(StructuralIssue(
            "masking", f"kv_splits {cfg.kv_splits} does not tile the "
                       f"cache ({prob.seq_kv}) — tail span must be masked"))
    if prob.head_dim not in HEAD_DIMS or prob.group > MAX_GROUP:
        issues.append(StructuralIssue(
            "unsupported", f"the kernel takes head_dim in {HEAD_DIMS} and "
                           f"at most {MAX_GROUP} query heads per KV head; "
                           f"got head_dim {prob.head_dim}, group "
                           f"{prob.group}"))
    issues += check_vector_alignment("K/V rows",
                                     (("head_dim", prob.head_dim),),
                                     prob.dtype)
    return issues


def flash_decode_cost(cfg: FlashDecodeConfig,
                      prob: FlashDecodeProblem) -> CostEstimate:
    """H100 model of ``flash_decode.cu``: memory-bound cache streaming,
    one CTA per (span, KV head, row) with one step's K and V tiles in
    flight per round trip, so splits buy bandwidth (more CTAs in flight)
    at the cost of the partials' write and read — the kv_splits knob the
    harness tunes.  The products are FMAs on the CUDA cores."""
    sz = DTYPE_BYTES.get(prob.dtype, 2)
    B, H, HK = prob.batch, prob.q_heads, prob.kv_heads
    S, D = prob.seq_kv, prob.head_dim
    ns = cfg.kv_splits
    flops = 4.0 * B * H * S * D
    kv_bytes = 2 * B * HK * S * D * sz
    part_bytes = B * H * ns * (D + 2) * 4 * 2     # partials write+read
    n_ctas = B * HK * ns
    tt = tile_tokens(D, sz)
    smem = 2 * tt * D * sz + MAX_GROUP * (D + tt) * 4
    per_sm = ctas_per_sm(KERNEL_THREADS, 64, smem)
    eff = stream_eff(min(n_ctas, N_SMS * per_sm), 2 * tt * D * sz)
    return CostEstimate(
        compute_s=flops / (PEAK_FLOPS["f32"] * wave_eff(n_ctas, per_sm)),
        memory_s=(kv_bytes + part_bytes) / (HBM_BW * eff),
        flops=flops, hbm_bytes=kv_bytes + part_bytes)


def flash_decode_sol(prob: FlashDecodeProblem) -> CostEstimate:
    """Speed of light: one pass over the KV cache plus the (tiny)
    query/output vectors — the partial-combine traffic is a config
    artifact and does not appear in the floor."""
    sz = DTYPE_BYTES.get(prob.dtype, 2)
    B, H, HK = prob.batch, prob.q_heads, prob.kv_heads
    S, D = prob.seq_kv, prob.head_dim
    flops = 4.0 * B * H * S * D
    traffic = 2 * B * HK * S * D * sz + 2 * B * H * D * sz
    return sol_estimate(flops, traffic, prob.dtype)


def _split_steps(cfg: FlashDecodeConfig, prob: FlashDecodeProblem):
    out = []
    for nxt in (cfg.kv_splits * 2, cfg.kv_splits // 2):
        if 1 <= nxt <= 64 and prob.seq_kv % nxt == 0:
            out.append((f"kv_splits={nxt}", FlashDecodeConfig(kv_splits=nxt)))
    return out


SKILLS = (
    generic_skill("retile", "flash_decode", _split_steps),
)


INJECTABLE_BUGS = ("wrong_kv_head", "split_overlap", "partial_mislabel")


def compatible_bugs(cfg: FlashDecodeConfig, prob: FlashDecodeProblem):
    menu = list(INJECTABLE_BUGS)
    if prob.q_heads == prob.kv_heads:
        menu.remove("wrong_kv_head")
    return menu


# Ground truth (tests/test_families.py checks it against live feedback).
BUG_SIGNATURES = (
    BugSignature("wrong_kv_head", ("solver",),
                 ("assert_conform(sq_1,sq_3)",)),
    BugSignature("split_overlap", ("solver",),
                 ("assert_disjoint(KV_READ)", "assert_coverage(KV_READ)")),
    BugSignature("partial_mislabel", ("solver",),
                 ("assert_conform(mm_9,e_10)",)),
)


# -- reference execution (the kernel against its plain version) ------------

def reference_check(cfg: FlashDecodeConfig,
                    prob: FlashDecodeProblem, device="cuda") -> bool:
    """Run the port's validated ``mha_decode`` with ``cfg`` on ``device``
    (the CUDA kernel on the card, the plain version on the CPU) against
    ``mha_ref(..., causal=False)``, at the JAX check's small shapes (2
    query heads on 1 KV head, a cache of min(seq_kv, 512) positions
    rounded up to a multiple of kv_splits, ``d = min(head_dim, 64)``) in
    the problem's dtype, within ``REF_TOL``.  Precondition errors
    propagate to the validator."""
    import torch
    from repro_torch.kernels.flash_attention import mha_decode, mha_ref
    make, _, tol = reference_setup("flash_decode", prob.dtype, device)
    S = min(prob.seq_kv, 512)
    while S % cfg.kv_splits:
        S += 1
    d = min(prob.head_dim, 64)
    q, k, v = make((1, 2, 1, d)), make((1, 1, S, d)), make((1, 1, S, d))
    o = mha_decode(q, k, v, S, cfg=cfg)
    w = mha_ref(q, k, v, causal=False)
    return bool(torch.allclose(o.float(), w.float(), rtol=tol, atol=tol))


def _lower():
    from repro_torch.kernels import flash_attention
    return flash_attention


def _example():
    return (FlashDecodeConfig(kv_splits=8),
            FlashDecodeProblem(32, 8, 1, 8192, 128, "bf16"))


def _sweep():
    # pow2 bucket grid: the 8k-cache serving batch plus a large-batch /
    # short-cache point and a small-batch / long-cache point
    return [FlashDecodeProblem(32, 8, 1, 8192, 128, "bf16"),
            FlashDecodeProblem(128, 8, 1, 2048, 128, "bf16"),
            FlashDecodeProblem(8, 8, 1, 32768, 128, "bf16")]


FAMILY = register(KernelFamily(
    name="flash_decode",
    config_cls=FlashDecodeConfig,
    problem_cls=FlashDecodeProblem,
    build_program=build_flash_decode_program,
    structural=structural_flash_decode,
    cost=flash_decode_cost,
    skills=SKILLS,
    injectable_bugs=INJECTABLE_BUGS,
    bug_signatures=BUG_SIGNATURES,
    compatible_bugs=compatible_bugs,
    reference_check=reference_check,
    kernel="flash_decode",
    lower=_lower,
    example=_example,
    sweep_problems=_sweep,
    sol_bound=flash_decode_sol,
))


def verify_flash_decode(cfg: FlashDecodeConfig, prob: FlashDecodeProblem,
                        *, inject_bug: Optional[str] = None):
    return FAMILY.verify(cfg, prob, inject_bug=inject_bug)

