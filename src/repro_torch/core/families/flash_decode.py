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
together, reading the span once instead of G times.  In bf16 its
products run on tensor cores with the operands swapped (K · Qᵀ, G heads
padded to the n = 8 of ``mma.sync``), and a producer warp streams the
span through a three-stage TMA ring of 16 KB K and V tiles; f32 runs
CUDA-core FMAs over one 16 KB tile at a time.  A second kernel of the
same call merges the spans' partials on the card.  A head_dim off the
16-byte grain or above 256 runs on the panel route (64-position tiles on
``mma.sync`` in bf16, 32 on the CUDA cores in f32, one CTA per output
panel of 64 or 256 columns, :func:`~repro_torch.core.kernelspec.
panel_issues`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .. import dsl
from ..costs import (CostEstimate, HBM_BW, L2_BW, PEAK_FLOPS, sol_estimate,
                     stream_eff, wave_eff)
from ..kernelspec import (DECODE_PANEL_TOKENS, DTYPE_BYTES, GROUP_BLOCK,
                          N_SMS, StructuralIssue, cdiv, ctas_per_sm,
                          decode_panel_smem, head_blocks, n_panels, on_grain,
                          panel_issues, panel_width, tile_width)
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

TILE_BYTES = 16384       # one K (or V) tile
STAGES = {"bf16": 3, "f32": 1}        # K/V tiles of a CTA in flight
KERNEL_THREADS = {"bf16": 160, "f32": 128}   # bf16: 4 consumer warps (two
#                                              at width 256) and a producer


PANEL_THREADS = 128


def instance_name(head_dim: int, itemsize: int) -> str:
    """The instance that runs: "tensor cores W=128" (bf16 at head_dim
    65..128), "cuda cores W=64" (float32 up to 64); on the panel route
    its panels, "panel tensor cores 2x256" (bf16 at 300 or 512)."""
    kind = "tensor cores" if itemsize == 2 else "cuda cores"
    if not on_grain(head_dim, itemsize):
        return f"panel {kind} {n_panels(head_dim)}x{panel_width(head_dim)}"
    return f"{kind} W={tile_width(head_dim)}"


def tile_tokens(head_dim: int, itemsize: int) -> int:
    """Positions of K (and of V) one step stages: 16 KB of the instance's
    width, at most 64 in f32; in bf16 16 KB exactly (128 positions at
    width 64, 64 at 128, 32 at 256: 32 or 16 for each of the four
    consumer warps, 16 for each of two at 256); on the panel route 64 in
    bf16 (16 a warp), 32 in f32."""
    if not on_grain(head_dim, itemsize):
        return DECODE_PANEL_TOKENS.get(itemsize, 64)
    w = tile_width(head_dim)
    if itemsize == 2:
        return TILE_BYTES // (w * 2)
    return min(64, TILE_BYTES // (w * itemsize))


def smem_bytes(head_dim: int, dtype: str) -> int:
    """Shared memory of one CTA: bf16 — 1024 bytes of alignment slack,
    the ring of K and V tiles and its mbarriers; f32 — one K and V tile
    at the width, Q and the weights of a head block in float32.  The panel
    route: a 64-column chunk of the block's queries and of K, and the
    tile's V rows at the panel's width (rows padded by 16 bytes), and in
    f32 the weights and the running statistics."""
    sz = DTYPE_BYTES.get(dtype, 2)
    if not on_grain(head_dim, sz):
        return decode_panel_smem(head_dim, sz)
    tt, w = tile_tokens(head_dim, sz), tile_width(head_dim)
    if dtype == "f32":
        return 2 * tt * w * sz + GROUP_BLOCK * (w + tt + 3) * 4
    return 1024 + STAGES["bf16"] * 2 * TILE_BYTES + 16 * STAGES["bf16"]


def structural_flash_decode(cfg: FlashDecodeConfig,
                            prob: FlashDecodeProblem):
    """Hopper model of ``flash_decode.cu``: splits that do not tile the
    cache, rows that are not 16-byte aligned (the on-grain instances copy
    the cache in 16-byte units), and on the panel route its narrow copies
    and output panels (:func:`~repro_torch.core.kernelspec.panel_issues`)."""
    span = cdiv(prob.seq_kv, cfg.kv_splits)
    issues = []
    if span * cfg.kv_splits != prob.seq_kv:
        issues.append(StructuralIssue(
            "masking", f"kv_splits {cfg.kv_splits} does not tile the "
                       f"cache ({prob.seq_kv}) — tail span must be masked"))
    issues += panel_issues("K/V", prob.head_dim, prob.dtype)
    return issues


def flash_decode_cost(cfg: FlashDecodeConfig,
                      prob: FlashDecodeProblem) -> CostEstimate:
    """H100 model of ``flash_decode.cu``: memory-bound cache streaming,
    one CTA per (span, KV head, head block, row) keeping its ring's K and
    V tiles in flight per round trip, the bandwidth shared by the SMs
    that hold a CTA, so splits buy bandwidth (more CTAs, on more SMs) at
    the cost of the partials, which the split kernel writes and the
    combine kernel reads before writing the output — the kv_splits knob
    the harness tunes.  A group above 8 reads the cache once from HBM
    and again from L2 for each further head block.  The products run on
    the tensor cores in bf16 (8 heads a tile per head block) and on the
    CUDA cores in f32."""
    sz = DTYPE_BYTES.get(prob.dtype, 2)
    B, H, HK = prob.batch, prob.q_heads, prob.kv_heads
    S, D = prob.seq_kv, prob.head_dim
    ns = cfg.kv_splits
    nhb = head_blocks(prob.group)
    flops = 4.0 * B * H * S * D
    kv_bytes = 2 * B * HK * S * D * sz
    # partials written and read once, the output written once
    part_bytes = B * H * ns * (D + 2) * 4 * 2 + B * H * D * sz
    # the panel route: one CTA a panel, each re-reading K (from L2)
    panels = 1 if on_grain(D, sz) else n_panels(D)
    n_ctas = B * HK * nhb * ns * panels
    dt = "f32" if prob.dtype == "f32" else "bf16"
    threads = KERNEL_THREADS[dt] if panels == 1 and on_grain(D, sz) \
        else PANEL_THREADS
    per_sm = ctas_per_sm(threads, 64, smem_bytes(D, prob.dtype))
    in_flight = STAGES[dt] * 2 * TILE_BYTES
    eff = stream_eff(min(n_ctas, N_SMS * per_sm), in_flight) \
        * min(1.0, n_ctas / N_SMS)
    if dt == "f32":
        compute_s = flops / (PEAK_FLOPS["f32"] * wave_eff(n_ctas, per_sm))
    else:   # tensor cores, 8 heads a tile per head block
        compute_s = (4.0 * B * HK * nhb * GROUP_BLOCK * S * cdiv(D, 16) * 16
                     / (PEAK_FLOPS["bf16"] * wave_eff(n_ctas, per_sm)))
    return CostEstimate(
        compute_s=compute_s,
        memory_s=(kv_bytes + part_bytes) / (HBM_BW * eff)
        + (nhb * panels - 1) * kv_bytes / L2_BW,
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

