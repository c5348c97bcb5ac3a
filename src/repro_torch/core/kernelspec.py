"""Bridge between kernel configurations and ARGUS tile programs, with a
structural model of what a hand-written Hopper kernel does with a config.

Each kernel family exposes a *config* (tile shapes, reduction order,
split policy — the knobs the agentic harness mutates) and a *problem*
(operand shapes/dtypes).  This module turns (config, problem) into:

* a :class:`repro_torch.core.dsl.TileProgram` carrying the family's
  data-flow invariants (built by the family module), validated by
  :func:`repro_torch.core.analysis.check`;
* *structural* checks of the CUDA kernel that runs the config on an
  H100 (one CTA of :data:`CTA_THREADS` threads per CTA tile):
    - shared memory staged per CTA against the 227 KB a block may use,
    - accumulator registers per thread against the 255-register limit,
    - the tensor-core grain of the CTA tile (``mma.sync`` m16n8k16, and
      the 32-deep shared-memory K chunk): a tile off the grain computes
      masked rows, columns or depth,
    - 16-byte alignment of operand rows, below which the kernel takes a
      masked scalar load path instead of 16-byte ``cp.async`` copies,
    - a config tile larger than one CTA holds (covered by several CTAs),
    - out-of-bounds masking obligations for non-divisible dims.

Structural issues are warnings the cost model prices; they never reject
a config (:attr:`VerifyResult.hard_ok` reads the data-flow invariants
only).  ``verify()`` is the single entry point: zero runtime overhead,
pure compile-time reasoning, concrete counterexamples on failure.

Every constant below is a model parameter of an H100 SXM (from NVIDIA's
data sheet and the Hopper tuning guide), not a measurement.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from .analysis import CheckReport, check

# --- H100 SXM model constants (model parameters, not measurements) --------
SMEM_PER_CTA = 232_448        # bytes a block may use (227 KB, opt-in)
SMEM_PER_SM = 233_472         # bytes of shared memory on one SM (228 KB)
REGS_PER_SM = 65_536          # 32-bit registers on one SM
MAX_REGS_PER_THREAD = 255
MAX_THREADS_PER_SM = 2048
N_SMS = 132
CTA_THREADS = 128             # four warps per CTA in the port's kernels
MMA_M, MMA_N = 16, 8          # output grain of mma.sync.m16n8k16
K_CHUNK = 32                  # K depth of one shared-memory stage
STAGES = 2                    # cp.async double buffering
VECTOR_BYTES = 16             # one cp.async / one 128-bit load
REG_OVERHEAD = 40             # registers beside the accumulator (model)
DTYPE_BYTES = {"f32": 4, "bf16": 2, "i8": 1, "fp8": 1, "i32": 4}


# The attention kernels' geometry (paged_decode, ragged_prefill,
# flash_attention, flash_decode): a head_dim of whole 16-byte rows up to
# MAX_HEAD_DIM, read at run time in tiles of the least of TILE_WIDTHS
# columns at or above it; above GROUP_BLOCK query heads a KV head, one CTA
# for each block of them (mma.sync's n = 8 in the decode kernels)
MAX_HEAD_DIM = 256
TILE_WIDTHS = (64, 128, 256)
GROUP_BLOCK = 8


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def head_dim_ok(head_dim: int, itemsize: int) -> bool:
    """A head_dim the attention kernels take: rows of whole 16-byte
    vectors (a multiple of 8 in bf16, of 4 in float32), at most 256."""
    return (0 < head_dim <= MAX_HEAD_DIM
            and (head_dim * itemsize) % VECTOR_BYTES == 0)


def tile_width(head_dim: int) -> int:
    """Columns of a row in the attention kernels' tiles: the least of
    64, 128 and 256 at or above head_dim (zeros past it)."""
    return next((w for w in TILE_WIDTHS if head_dim <= w), TILE_WIDTHS[-1])


def head_blocks(group: int) -> int:
    """CTAs of a decode kernel for one (span, KV head, row): one per block
    of up to GROUP_BLOCK query heads, each reading the span's K and V."""
    return cdiv(max(group, 1), GROUP_BLOCK)


@dataclass
class StructuralIssue:
    kind: str
    message: str


def check_smem(name: str, staged_bytes: int) -> List[StructuralIssue]:
    """Shared memory staged per CTA (all pipeline stages) against the
    227 KB a block may use."""
    if staged_bytes <= SMEM_PER_CTA:
        return []
    return [StructuralIssue(
        "smem", f"{name}: {staged_bytes} bytes of shared memory staged per "
                f"CTA exceed the {SMEM_PER_CTA} a block may use")]


def check_registers(name: str, acc_per_thread: int
                    ) -> List[StructuralIssue]:
    """f32 accumulator registers per thread, plus the model's overhead for
    fragments and addresses, against the 255-register limit (beyond it
    the accumulator spills to local memory)."""
    if acc_per_thread + REG_OVERHEAD <= MAX_REGS_PER_THREAD:
        return []
    return [StructuralIssue(
        "registers", f"{name}: {acc_per_thread} accumulator registers per "
                     f"thread (+{REG_OVERHEAD}) exceed "
                     f"{MAX_REGS_PER_THREAD}: the accumulator spills")]


def check_grain(name: str, tile: Sequence[int], cta: Sequence[int]
                ) -> List[StructuralIssue]:
    """Tensor-core grain: a config tile (rows, cols, depth) that is not a
    multiple of the CTA tile (rows, cols; itself a multiple of the
    m16n8 grain) and of the K chunk leaves masked lanes in every MMA."""
    rows, cols, depth = tile
    tm, tn = cta
    issues = []
    if tm % MMA_M or tn % MMA_N:
        issues.append(StructuralIssue(
            "grain", f"{name}: CTA tile {tm}x{tn} is off the "
                     f"m{MMA_M}n{MMA_N} MMA grain"))
    if rows % tm or cols % tn:
        issues.append(StructuralIssue(
            "grain", f"{name}: tile {rows}x{cols} is not a multiple of the "
                     f"{tm}x{tn} CTA tile: masked rows/columns in every MMA"))
    if depth % K_CHUNK:
        issues.append(StructuralIssue(
            "grain", f"{name}: K block {depth} is not a multiple of the "
                     f"{K_CHUNK}-deep chunk: zero-filled depth in every MMA"))
    return issues


def check_vector_alignment(name: str, row_elems: Sequence[Tuple[str, int]],
                           dtype: str) -> List[StructuralIssue]:
    """16-byte alignment of every operand row and block start: below it
    the kernel loads element by element, masked, instead of by 16-byte
    ``cp.async`` copies."""
    sz = DTYPE_BYTES.get(dtype, 2)
    bad = [f"{what}={n}" for what, n in row_elems if (n * sz) % VECTOR_BYTES]
    if not bad:
        return []
    return [StructuralIssue(
        "alignment", f"{name}: {', '.join(bad)} elements of {dtype} are not "
                     f"a multiple of {VECTOR_BYTES} bytes: masked scalar "
                     f"load path")]


def check_cta_split(name: str, tile: Sequence[int], cta: Sequence[int]
                    ) -> List[StructuralIssue]:
    """A config tile larger than one CTA holds is covered by several CTAs,
    launched one after another so they share the tile's operand panels
    in L2."""
    rows, cols = tile
    tm, tn = cta
    n = cdiv(rows, tm) * cdiv(cols, tn)
    if n <= 1:
        return []
    return [StructuralIssue(
        "cta_split", f"{name}: tile {rows}x{cols} is covered by {n} CTAs of "
                     f"{tm}x{tn}")]


def check_masking(name: str, dim_sizes: Sequence[int],
                  block_shape: Sequence[int],
                  masked_dims: Sequence[int]) -> List[StructuralIssue]:
    """Non-divisible dims must be declared masked (OOB-guard obligation)."""
    issues: List[StructuralIssue] = []
    for d, (n, b) in enumerate(zip(dim_sizes, block_shape)):
        if n % b != 0 and d not in masked_dims:
            issues.append(StructuralIssue(
                "masking",
                f"{name}: dim {d} ({n}) not divisible by block {b} and not "
                f"declared masked — OOB elements reach compute"))
    return issues


def work_ctas(size: int, block: int, cta: int) -> int:
    """CTAs along one dim that hold data when config blocks of ``block``
    run on CTAs of ``cta`` (a kernel launches cdiv(size, block) *
    cdiv(block, cta); those past the edge exit)."""
    nb = cdiv(size, block)
    return (nb - 1) * cdiv(block, cta) + cdiv(size - (nb - 1) * block, cta)


def ctas_per_sm(threads: int, regs_per_thread: int, smem_bytes: int) -> int:
    """Resident CTAs per SM, limited by registers, shared memory and
    threads (model: no allocation granularity)."""
    by_regs = REGS_PER_SM // max(1, threads * regs_per_thread)
    by_smem = SMEM_PER_SM // max(1, smem_bytes)
    by_threads = MAX_THREADS_PER_SM // threads
    return max(1, min(by_regs, by_smem, by_threads, 32))


@dataclass
class VerifyResult:
    """Combined invariant + structural verdict for one kernel config."""

    report: Optional[CheckReport]
    structural: List[StructuralIssue] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return (self.report is None or self.report.ok) and not self.structural

    @property
    def hard_ok(self) -> bool:
        """Data-flow invariants only (structural issues are perf warnings in
        some contexts, e.g. alignment on edge blocks)."""
        return self.report is None or self.report.ok

    def render(self) -> str:
        lines = []
        if self.report is not None:
            lines.append(self.report.render())
        for s in self.structural:
            lines.append(f"  STRUCT[{s.kind}] {s.message}")
        if self.ok:
            lines.append("  VERDICT: ok")
        else:
            lines.append("  VERDICT: REJECTED")
        return "\n".join(lines)


def verify_program(prog, structural: List[StructuralIssue]) -> VerifyResult:
    return VerifyResult(check(prog), structural)
