"""SSD kernel family (Mamba-2 state-space dual) — beyond-paper extension.

The port of the JAX package's ``core/families/ssd.py``.  The tile
program (:func:`build_ssd_program`: one ``(bh, c)`` grid step of the SSD
chunk scan), the skills, the injectable bugs and their signatures are
copied unchanged, so the port's gate gives the JAX gate's verdicts,
findings and counterexamples.  Invariants: the dual-attention
contraction pairs C and B rows of the SAME chunk (intra-chunk
conformity over (bh, position, state-dim)); the carried (N, P) state
must be stable across the sequential chunk axis; y coverage.

The structural, cost and speed-of-light hooks are a Hopper model of the
CUDA kernel that runs the family
(``repro_torch/kernels/ssd/csrc/ssd_chunk_scan.cu``): three launches on
one stream, chunk-parallel.  (1) One CTA of 256 threads per (bh, chunk,
64 columns of P) computes the chunk's cumulative decays and its own
state contribution ``Bᵀ·(exp(cs_end − cs) ⊙ x)`` into float32 scratch
(BH, nc, N, P); (2) one thread per (bh, state element) runs the TPU
kernel's recurrence over the chunks in order, leaving in each slot the
state that enters the chunk — the TPU grid's sequential chunk axis
becomes this short pass; (3) one CTA of 256 threads per (bh, chunk,
64-row query block, 64 columns of P) computes ``exp(cs_i)·(C_i·S)`` and,
flash-style over the key blocks at or below it, ``s = (C_i·B_jᵀ) ⊙
exp(cs_i − cs_j)`` then ``y_i += s·x_j``.  A chunk that is no multiple
of 64 leaves rows of its last block masked; a P wider than 64 runs on
several CTAs, each recomputing the scores.  Every product is
``mma.sync`` TF32 with float32 operands split in two (3xTF32: three
products a pair), so the compute term is priced at a third of the TF32
rate, and the states cross HBM four times, so a short chunk pays in
bytes what a long one pays in score work.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .. import dsl
from ..costs import (CostEstimate, HBM_BW, L2_BW, MMA_SYNC_DERATE, peak_flops,
                     sol_estimate, wave_eff)
from ..kernelspec import (DTYPE_BYTES, REG_OVERHEAD, StructuralIssue, cdiv,
                          check_masking, check_smem, ctas_per_sm)
from ..tags import Expr, make_tag
from .base import (BugSignature, KernelFamily, generic_skill,
                   reference_setup, register)


@dataclass(frozen=True)
class SSDProblem:
    batch_heads: int          # B · H
    seq: int
    head_dim: int             # P
    d_state: int              # N
    dtype: str = "f32"


@dataclass(frozen=True)
class SSDConfig:
    chunk: int = 128

    def name(self) -> str:
        return f"ssd[q={self.chunk}]"


def build_ssd_program(cfg: SSDConfig, prob: SSDProblem,
                      *, inject_bug: Optional[str] = None
                      ) -> dsl.TileProgram:
    """One (bh, c) grid step of the SSD chunk scan.

    Invariants: the dual-attention contraction pairs C and B rows of the
    SAME chunk (intra-chunk conformity over (bh, position, state-dim));
    the carried (N, P) state must be stable across the sequential chunk
    axis; y coverage.  Injectable bugs: "b_chunk_offset" (B read from the
    neighboring chunk), "state_depends_c" (carried state tagged with the
    chunk index), "xb_mismatch" (x rows from a different chunk than B).
    """
    p = dsl.TileProgram(cfg.name())
    BH, S, P, N = prob.batch_heads, prob.seq, prob.head_dim, prob.d_state
    q = cfg.chunk
    nc = cdiv(S, q)

    bh = p.add_grid("bh", BH, "parallel")
    c = p.add_grid("c", nc, "arbitrary")

    p.tensor("X", (BH, S, P), prob.dtype)
    p.tensor("DA", (BH, S), prob.dtype)
    p.tensor("B", (BH, S, N), prob.dtype)
    p.tensor("C", (BH, S, N), prob.dtype)
    p.tensor("Y", (BH, S, P), prob.dtype, kind="output")

    c_b = (c + 1) % nc if inject_bug == "b_chunk_offset" else c
    c_x = (c + 1) % nc if inject_bug == "xb_mismatch" else c

    xt = p.squeeze(p.load("X", (bh, c_x * q, 0), (1, q, P)))
    bt = p.squeeze(p.load("B", (bh, c_b * q, 0), (1, q, N)))
    ct = p.squeeze(p.load("C", (bh, c * q, 0), (1, q, N)))

    # dual-attention pairing: scores = C·Bᵀ contracts the state dim; the
    # operands must agree on (bh, state coordinate) — identity tags are
    # (bh, pos, n), bind n, compare components (0, 2)
    p.assert_conform(ct, bt, bind=((1, 1),), components=((0, 2), (0, 2)))
    s_tag = lambda i, j: make_tag(bh, c * q + i, c_b * q + j)
    s = p.matmul(ct, p.transpose(bt), retag=s_tag)
    # retag honesty: declared score columns must be B's actual positions
    p.assert_conform(bt, s, bind=((0, 1),), components=((1,), (2,)))
    # chunk locality: score columns must be the SAME chunk as the x rows
    # they multiply (the SSD intra-chunk contraction)
    p.assert_conform(s, xt, bind=((1, 0),), components=((2,), (1,)))
    y_tag = lambda i, pp: make_tag(bh, c * q + i, pp)
    y = p.matmul(s, xt, retag=y_tag)

    # carried state: (N, P) scratch, stable across the chunk axis
    state = p.alloc((N, P), "f32")
    if inject_bug == "state_depends_c":
        st_tag = lambda n, pp: make_tag(bh, Expr.of(c), n, pp)
    else:
        st_tag = lambda n, pp: make_tag(bh, n, pp)
    p.update(state, fn="decay_accumulate", retag=st_tag)
    p.assert_stable(state, "c")

    p.store("Y", y, (bh, c * q, 0))
    # streaming output: the sequential chunk axis legitimately partitions Y
    # (unlike an accumulated GEMM output) — include it as distinguishing
    p.assert_disjoint_writes("Y", axes=("bh", "c"))
    p.assert_coverage("Y")
    return p


# -- the CUDA kernel's decomposition -----------------------------------------

BLOCK_ROWS = 64        # query and key rows per block inside a chunk
P_TILE = 64            # columns of P per CTA
N_GRAIN = 8            # the state dim is zero-padded to a multiple of this
N_PANEL = 128          # state rows a panel: any d_state is walked in these
THREADS = 256


def padded_state(n: int) -> int:
    return cdiv(n, N_GRAIN) * N_GRAIN


def state_panels(n: int):
    """The padded state dim's panels of at most ``N_PANEL`` rows (130 ->
    136 -> [128, 8]; 256 -> [128, 128])."""
    npad = padded_state(n)
    return [min(N_PANEL, npad - n0) for n0 in range(0, npad, N_PANEL)]


def _stride(n: int, mod: int) -> int:
    """A tile's row stride in floats: n rounded up to 32, plus ``mod``
    (the kernel's bank-conflict-free strides)."""
    return cdiv(n, 32) * 32 + mod


def smem_bytes(chunk: int, d_state: int) -> int:
    """Shared memory of the larger of the two CTAs that stage tiles (the
    kernel's layouts).  The chunk-state CTA: a key block of B (64 rows
    of the padded N) and of ``dte ⊙ x`` (64 x 64), and the chunk's
    cumulative decays and decays to its end.  The scan CTA: the query
    block of C and a key block of B (64 rows of the padded N each; the
    entering state is staged where B goes), a key block of x, the score
    tile, and the chunk's cumulative decays.  Decays padded to whole
    64-row blocks.  The state dim staged is one panel's (at most 128
    rows)."""
    n = min(padded_state(d_state), N_PANEL)
    rows = cdiv(chunk, BLOCK_ROWS) * BLOCK_ROWS
    state = (BLOCK_ROWS * _stride(n, 8) + BLOCK_ROWS * (P_TILE + 8)
             + 2 * rows)
    scan = (2 * BLOCK_ROWS * _stride(n, 4) + BLOCK_ROWS * (P_TILE + 8)
            + BLOCK_ROWS * (BLOCK_ROWS + 4) + rows)
    return 4 * max(state, scan)


def scratch_bytes(cfg: SSDConfig, prob: SSDProblem) -> int:
    """Device scratch the wrapper allocates for one call: a float32 (N,
    P) state per (bh, chunk) and a float32 decay per (bh, chunk)."""
    nc = cdiv(prob.seq, cfg.chunk)
    return 4 * prob.batch_heads * nc * (prob.d_state * prob.head_dim + 1)


def kernel_flops(cfg: SSDConfig, prob: SSDProblem) -> float:
    """Operations of the products the kernel issues (each run as three
    TF32 products: hi·hi, hi·lo, lo·hi), masked rows and padding
    included: per chunk and P tile, the chunk-state product over every
    64-row block (state rows padded to 16), and per query block C·state
    and the score and y products of every key block at or below it (the
    state rows padded to 16 in each panel of 128)."""
    BH, S = prob.batch_heads, prob.seq
    n = padded_state(prob.d_state)
    nb = cdiv(cfg.chunk, BLOCK_ROWS)
    rows = nb * BLOCK_ROWS
    pairs = nb * (nb + 1) // 2
    states = 2 * sum(cdiv(w, 16) * 16 for w in state_panels(prob.d_state)) \
        * rows * P_TILE
    scan = (nb * 2 * BLOCK_ROWS * n * P_TILE
            + pairs * 2 * BLOCK_ROWS * BLOCK_ROWS * (n + P_TILE))
    return float(BH * cdiv(prob.head_dim, P_TILE) * cdiv(S, cfg.chunk)
                 * (states + scan))


def structural_ssd(cfg: SSDConfig, prob: SSDProblem):
    """Hopper model of ``ssd_chunk_scan.cu``: shared memory of its CTAs,
    the grain of its 64-row blocks and 64-column P tile and of the state
    dim padded to the TF32 product's k of 8 (masked rows, columns and
    padding computed all the same), a P on several CTAs (each recomputing
    the scores), a d_state above 128 in state panels (the chunk-state
    launch on a CTA a panel, each reading x again), scratch
    states that outweigh the operands (a chunk too short: each state
    crosses HBM four times), and the JAX family's masking check."""
    q, P, N = cfg.chunk, prob.head_dim, prob.d_state
    issues = []
    issues += check_smem("CTA", smem_bytes(q, N))
    if q % BLOCK_ROWS:
        issues.append(StructuralIssue(
            "grain", f"chunk {q} is not a multiple of the {BLOCK_ROWS}-row "
                     f"block: masked rows in every chunk"))
    if P % P_TILE:
        issues.append(StructuralIssue(
            "grain", f"head_dim {P} is not a multiple of the {P_TILE}-column "
                     f"P tile: masked columns"))
    if N % N_GRAIN:
        issues.append(StructuralIssue(
            "grain", f"d_state {N} is zero-padded to {padded_state(N)}"))
    if P > P_TILE:
        issues.append(StructuralIssue(
            "cta_split", f"head_dim {P} runs on {cdiv(P, P_TILE)} CTAs per "
                         f"(batch, head), each recomputing the scores"))
    panels = len(state_panels(N))
    if panels > 1:
        issues.append(StructuralIssue(
            "cta_split", f"d_state {N} runs in {panels} state panels of at "
                         f"most {N_PANEL} rows: the chunk states on "
                         f"{panels} CTAs a chunk, each reading x again"))
    scratch = scratch_bytes(cfg, prob)
    operands = _io_bytes(prob)
    if scratch > operands:
        issues.append(StructuralIssue(
            "scratch", f"chunk {q}: {scratch} bytes of scratch states "
                       f"outweigh the {operands} of the operands, and "
                       f"cross HBM four times"))
    issues += check_masking("S", (prob.seq,), (cfg.chunk,),
                            masked_dims=(0,))
    return issues


def _io_bytes(prob: SSDProblem) -> int:
    """x, B, C, da in and y out once."""
    sz = DTYPE_BYTES.get(prob.dtype, 4)
    BH, S, P, N = prob.batch_heads, prob.seq, prob.head_dim, prob.d_state
    return BH * S * (P + 2 * N + 1 + P) * sz


def ssd_cost(cfg: SSDConfig, prob: SSDProblem) -> CostEstimate:
    """H100 model of ``ssd_chunk_scan.cu``: the products it issues
    (:func:`kernel_flops`) at a third of the TF32 rate (3xTF32,
    ``peak_flops("tf32x3")``) on
    ``mma.sync`` (``MMA_SYNC_DERATE``), quantised in waves of the scan's
    CTAs over the 132 SMs; in bytes, the chunk-state launch reads x, B
    and da and writes the states, the pass reads and writes them, and
    the scan reads C, B, x, da and the states and writes y — so the
    states cross HBM four times, and a short chunk costs in bytes what
    a long one costs in score work — and each key block below the
    diagonal is re-read through L2 by every query block above it."""
    sz = DTYPE_BYTES.get(prob.dtype, 4)
    BH, S, P, N = prob.batch_heads, prob.seq, prob.head_dim, prob.d_state
    q = cfg.chunk
    nb = cdiv(q, BLOCK_ROWS)
    nc = cdiv(S, q)
    n_ctas = BH * nc * nb * cdiv(P, P_TILE)
    per_sm = ctas_per_sm(THREADS, 64 + REG_OVERHEAD, smem_bytes(q, N))
    issued = kernel_flops(cfg, prob)
    rate = peak_flops("tf32x3") * MMA_SYNC_DERATE
    states = 4 * BH * nc * N * P * 4
    io = (BH * S * (P + N + 1) * sz              # (1): x, B, da
          + BH * S * (2 * P + 2 * N + 1) * sz    # (3): x, B, C, da, y
          + states + 3 * BH * nc * 4)            # states, cs_end
    pairs = nb * (nb + 1) // 2
    l2 = (BH * nc * cdiv(P, P_TILE) * (pairs - nb) * BLOCK_ROWS
          * (padded_state(N) + P_TILE) * sz)
    return CostEstimate(
        compute_s=issued / (rate * wave_eff(n_ctas, per_sm)),
        memory_s=io / HBM_BW + l2 / L2_BW,
        flops=issued, hbm_bytes=io)


def ssd_sol(prob: SSDProblem) -> CostEstimate:
    """Speed of light: the algorithmic flop count at the *best* reachable
    chunk size (the intra/inter trade-off minimized over the tunable
    chunk grid) at the rate of float32-accurate tensor-core products
    (3xTF32: a third of the dense TF32 rate, ``peak_flops("tf32x3")``),
    vs the operand streams crossing HBM once — the carried-state spill
    is a config artifact and is excluded.  Within a chunk the score and
    y products need only the causal triangle, q(q+1)/2 (query, key)
    pairs of N + P multiply-adds each."""
    BH, S, P, N = prob.batch_heads, prob.seq, prob.head_dim, prob.d_state

    def chunk_flops(q: int) -> float:
        nc = cdiv(S, q)
        intra = BH * S * (q + 1) * (N + P)
        inter = BH * S * (4 * N * P) + BH * nc * 2 * N * P
        return float(intra + inter)

    grid = [q for q in (32, 64, 128, 256, 512) if S % q == 0]
    flops = min(chunk_flops(q) for q in grid) if grid \
        else chunk_flops(min(S, 128))
    return sol_estimate(flops, _io_bytes(prob), dtype="tf32x3")


# -- skills -----------------------------------------------------------------

def _chunk_steps(cfg: SSDConfig, prob: SSDProblem):
    out = []
    for nxt in (cfg.chunk * 2, cfg.chunk // 2):
        if 32 <= nxt <= 512 and prob.seq % nxt == 0:
            out.append((f"chunk={nxt}", SSDConfig(chunk=nxt)))
    return out


SKILLS = (
    generic_skill("retile", "ssd", _chunk_steps),
    generic_skill("software_pipelining", "ssd"),
    generic_skill("vectorized_io", "ssd"),
    generic_skill("f32_vmem_accumulate", "ssd"),
    generic_skill("oob_guarded_loads", "ssd"),
)


# -- fault model ------------------------------------------------------------

INJECTABLE_BUGS = ("b_chunk_offset", "state_depends_c", "xb_mismatch")


# Ground truth (tests/test_families.py checks it against live feedback).
# Both index-map bugs land on the same state-update pairing assertion —
# the counterexample narrows repair to that candidate pair.
BUG_SIGNATURES = (
    BugSignature("b_chunk_offset", ("solver",),
                 ("assert_conform(mm_7,sq_1)",)),
    BugSignature("xb_mismatch", ("solver",),
                 ("assert_conform(mm_7,sq_1)",)),
    BugSignature("state_depends_c", ("analysis",), ("assert_stable(",)),
)


# -- reference execution (the kernel against its plain version) ------------

def reference_check(cfg: SSDConfig, prob: SSDProblem,
                    device="cuda") -> bool:
    """Run the port's validated ``ssd`` with ``cfg`` on ``device`` (the
    CUDA kernel on the card, the plain version on the CPU) against the
    plain version ``ssd_ref``, at the JAX check's small shapes (2 heads,
    ``q = min(chunk, 64)``, four chunks, P 32, N 16, da = −|N(0,1)|·0.1,
    B and C scaled by 0.3) in the problem's dtype (x, B and C; da in
    float32), within ``ssd_error``'s tolerance.  Precondition errors of
    the config (``ValueError``, ``InvariantViolation``) propagate to the
    validator, which counts them as a failed test; so do build and
    launch errors, which it does not catch."""
    from repro_torch.kernels.ssd import ssd, ssd_error, ssd_ref
    make, _, _ = reference_setup("ssd", prob.dtype, device)
    q = min(cfg.chunk, 64)
    S = 4 * q
    x = make((2, S, 32))
    da = -make((2, S)).float().abs() * .1
    Bm = make((2, S, 16)) * .3
    Cm = make((2, S, 16)) * .3
    o = ssd(x, da, Bm, Cm, cfg=SSDConfig(chunk=q))
    w, _ = ssd_ref(x, da, Bm, Cm, q)
    return ssd_error(o, w)[2]


def _lower():
    from repro_torch.kernels import ssd
    return ssd


def _example():
    return SSDConfig(chunk=64), SSDProblem(64, 8192, 64, 128, "f32")


def _sweep():
    # pow2 bucket grid: the training-shape scan plus a short-sequence
    # and a long-sequence point, same head/state widths
    return [SSDProblem(64, 8192, 64, 128, "f32"),
            SSDProblem(64, 2048, 64, 128, "f32"),
            SSDProblem(64, 32768, 64, 128, "f32")]


FAMILY = register(KernelFamily(
    name="ssd",
    config_cls=SSDConfig,
    problem_cls=SSDProblem,
    build_program=build_ssd_program,
    structural=structural_ssd,
    cost=ssd_cost,
    skills=SKILLS,
    injectable_bugs=INJECTABLE_BUGS,
    bug_signatures=BUG_SIGNATURES,
    reference_check=reference_check,
    kernel="ssd_chunk_scan",
    lower=_lower,
    example=_example,
    sweep_problems=_sweep,
    sol_bound=ssd_sol,
))


def verify_ssd(cfg: SSDConfig, prob: SSDProblem,
               *, inject_bug: Optional[str] = None):
    return FAMILY.verify(cfg, prob, inject_bug=inject_bug)
