"""Kernel-family registry — the uniform per-family interface.

Every kernel family registers one :class:`KernelFamily` describing
everything the rest of the system needs to drive it:

* ``config_cls`` / ``problem_cls`` — the harness' action space and the
  operand shapes/semantics;
* ``build_program`` — the ARGUS tile program instantiating the family's tag
  functions + tag assertions for a (config, problem);
* ``structural`` — Hopper structural obligations (shared memory, registers,
  tensor-core grain, vector alignment, masking;
  :mod:`repro_torch.core.kernelspec`);
* ``cost`` — the analytic H100 estimate (:mod:`repro_torch.core.costs`);
* ``skills`` — the knowledge-base entries (config rewrites + the invariant
  templates that must hold after each, paper §6);
* ``injectable_bugs`` / ``compatible_bugs`` — the fault model's latent-bug
  menu (every entry must be caught by the family's invariants);
* ``reference_check`` — the family's CUDA kernel run on the validator's
  device against its plain PyTorch version;
* ``kernel`` — the name of that CUDA kernel, whose launch counter the
  validator's unit tests move;
* ``lower`` — the validated public entry points (resolved lazily so family
  modules never import :mod:`repro_torch.kernels` at module scope);
* ``example`` — the family's production tuning problem;
* ``sweep_problems`` — the shape-bucket sweep grid beyond the single
  ``example()``.

This registry is the port's own: it holds the families whose kernels are
ported — all eight of the JAX package's (``gemm``, ``flash_attention``,
``flash_decode``, ``moe``, ``ssd``, ``quant_gemm``, ``paged_attention``,
``ragged_prefill``) — and :func:`get_family` of any other family raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from ..kernelspec import VerifyResult, verify_program

# ---------------------------------------------------------------------------
# Skills (knowledge-base entries, paper §6 / Table 1)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Skill:
    """One knowledge-base entry: the transformation (a concrete config
    rewrite in the family config space), the data-flow invariants that must
    hold afterwards, its Table-1 tier, and a context enumerator
    ``contexts(cfg, prob) -> [(context_label, new_cfg), ...]``."""

    name: str
    tier: str                      # "global" | "local" | "isa"  (Table 1)
    families: Tuple[str, ...]
    description: str
    invariants: str                # which invariant templates guard it
    contexts: Callable


# Shared metadata for skills that appear in several families (one source of
# truth for Table 1; each family binds its own context enumerator).
GENERIC_SKILLS: Dict[str, Tuple[str, str, str]] = {
    "retile": (
        "global",
        "Change the config tile: trades operand re-streaming (HBM "
        "revisits) against CTA count, shared memory and tensor-core "
        "grain.",
        "operand pairing + coverage + accumulator stability re-proven per "
        "retile"),
    "software_pipelining": (
        "global",
        "HBM->shared-memory double buffering inside each CTA (always on: "
        "cp.async stages of the K walk; block shapes set the stage depth).",
        "carried-scratch stability across 'arbitrary' axes"),
    "vectorized_io": (
        "local",
        "Keep operand rows 16-byte aligned so copies go as 16-byte "
        "cp.async (structural alignment check enforces).",
        "alignment structural invariant"),
    "f32_vmem_accumulate": (
        "isa",
        "Accumulate in f32 registers across the K walk (mma.sync f32 "
        "accumulator fragments).",
        "accumulator ⊤-freedom + init-at-first-step"),
    "oob_guarded_loads": (
        "isa",
        "Masked tile loads that zero-fill out-of-range elements (cp.async "
        "zero-fill on the ragged edge).",
        "masking obligation for non-divisible dims"),
}


def _no_contexts(cfg, prob):
    return []


def generic_skill(name: str, family: str,
                  contexts: Optional[Callable] = None) -> Skill:
    """Instantiate one of the shared skills for a single family."""
    tier, desc, inv = GENERIC_SKILLS[name]
    return Skill(name, tier, (family,), desc, inv,
                 contexts or _no_contexts)


# ---------------------------------------------------------------------------
# Bug signatures (the fault model's ground-truth map, paper §9.4)
# ---------------------------------------------------------------------------

# match specificity levels returned by BugSignature.specificity
MATCH_NONE = 0       # the feedback says nothing about this bug
MATCH_STAGE = 1      # right verification stage, unfamiliar assertion
MATCH_EXACT = 2      # the bug's own assertion fired at its own stage


def assertion_key(assertion_id: str) -> str:
    """Strip the config-dependent ``<program>[<op index>]:`` prefix from an
    assertion id, leaving the stable per-family assertion label (e.g.
    ``assert_conform(t_A_0,t_B_1)``).  Signatures and planner strike
    accounting key on this."""
    _, sep, tail = assertion_id.partition("]:")
    return tail if sep else assertion_id


@dataclass(frozen=True)
class BugSignature:
    """Which verification findings an injectable bug produces.

    ``stages`` are engine stages ("structural" | "build" | "analysis" |
    "solver") the bug surfaces at; ``assertions`` are substring patterns
    matched against the *stable* assertion label (see :func:`assertion_key`
    — tile numbering can shift with config structure, so patterns should
    name the least config-sensitive fragment that identifies the
    assertion).  This is the harness' ground-truth map from counterexample
    back to candidate latent fault: the lowering agent matches a
    :class:`repro_torch.core.verify_engine.Feedback` against every compatible
    bug's signature and repairs the best-matching bug first (targeted
    repair, paper §9.4).  ``tests/test_families.py`` checks every declared
    signature against the actually-emitted feedback.
    """

    bug: str
    stages: Tuple[str, ...]
    assertions: Tuple[str, ...]

    def specificity(self, stage: str, assertion_id: str) -> int:
        """How strongly one (stage, assertion id) finding implicates this
        bug: MATCH_EXACT ≫ MATCH_STAGE ≫ MATCH_NONE."""
        if stage not in self.stages:
            return MATCH_NONE
        label = assertion_key(assertion_id)
        if any(pat in label for pat in self.assertions):
            return MATCH_EXACT
        return MATCH_STAGE


# ---------------------------------------------------------------------------
# The family protocol
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class KernelFamily:
    """Uniform per-family interface (see module docstring)."""

    name: str
    config_cls: type
    problem_cls: type
    # (cfg, prob, *, inject_bug=None) -> dsl.TileProgram
    build_program: Callable
    # (cfg, prob) -> List[StructuralIssue]
    structural: Callable
    # (cfg, prob) -> costs.CostEstimate
    cost: Callable
    skills: Tuple[Skill, ...] = ()
    injectable_bugs: Tuple[str, ...] = ()
    # ground-truth (stage, assertion) fingerprint per injectable bug —
    # what targeted repair matches counterexamples against
    bug_signatures: Tuple[BugSignature, ...] = ()
    # (cfg, prob) -> List[str]; defaults to the full injectable menu
    compatible_bugs: Optional[Callable] = None
    # (cfg, prob, device) -> bool — the kernel on ``device`` against the
    # plain PyTorch version
    reference_check: Optional[Callable] = None
    # the name (``CudaKernel.name``) of the CUDA kernel that
    # reference_check launches on the card
    kernel: Optional[str] = None
    # () -> module with the family's validated public entry points
    lower: Optional[Callable] = None
    # () -> (cfg, prob): the family's production tuning problem
    example: Optional[Callable] = None
    # () -> [prob, ...]: the family's shape-bucket sweep grid — a small
    # set of production problem shapes in distinct shape regimes, tuned
    # with the example() config as the start point (the example problem
    # is always swept too, so the grid only needs the neighbors).
    sweep_problems: Optional[Callable] = None
    # config fields the traced TileProgram actually depends on (ops,
    # extents, Exprs).  When set, the verify engine keys its program
    # memo on this projection of the config instead of the full config:
    # re-binding a config that differs only in trace-irrelevant knobs
    # (e.g. gemm's accumulator ``precision``, which enters the alloc dtype and
    # the structural stage — both read the exact config — but never an
    # analyzed Expr) reuses the traced program outright, skipping the
    # Python trace.  None (default) keys on the full config.  Declaring
    # a field that *does* shape the trace here is unsound — the family
    # owns the claim, tests/test_verify_engine.py spot-checks it.
    trace_fields: Optional[Tuple[str, ...]] = None
    # (prob) -> costs.CostEstimate: the analytic speed-of-light bound —
    # ideal flops over peak_flops(dtype) vs minimal one-pass HBM traffic
    # over HBM_BW (repro_torch.core.costs.sol_estimate), independent of any
    # config.  A genuine lower bound on the family ``cost`` hook.
    sol_bound: Optional[Callable] = None

    def verify(self, cfg, prob, *, inject_bug: Optional[str] = None
               ) -> VerifyResult:
        """Build + analyze + structural checks in one (uncached) call —
        the legacy ``verify_<family>`` entry point.  The staged, caching
        path is :class:`repro_torch.core.verify_engine.VerificationEngine`."""
        prog = self.build_program(cfg, prob, inject_bug=inject_bug)
        return verify_program(prog, self.structural(cfg, prob))

    def bugs_for(self, cfg, prob) -> List[str]:
        if self.compatible_bugs is not None:
            return list(self.compatible_bugs(cfg, prob))
        return list(self.injectable_bugs)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, KernelFamily] = {}


def register(family: KernelFamily) -> KernelFamily:
    if family.name in _REGISTRY:
        raise ValueError(f"kernel family {family.name!r} already registered")
    _REGISTRY[family.name] = family
    return family


# Tolerance of a kernel against its plain version in a family's
# reference_check, as both rtol and atol: f32 — the same products summed
# in another order; bf16 — more than one bf16 step (2^-7 relative) of
# any value, each side rounding its f32 result (and the attention
# kernels their bf16 p) once.
REF_TOL = {"f32": 1e-4, "bf16": 1e-2}


def reference_setup(family: str, dtype: str, device):
    """For a family's ``reference_check``: a maker of seeded standard-
    normal tensors of ``dtype`` on ``device`` (resolved: the card, or
    the CPU when asked), and the tolerance.  Raises ``ValueError`` for a
    dtype the kernels do not take."""
    import numpy as np
    import torch
    from repro_torch.device import resolve_device
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}.get(dtype)
    if dt is None:
        raise ValueError(f"{family} takes bf16 or f32, not {dtype}")
    dev = resolve_device(device)
    rng = np.random.default_rng(0)

    def make(shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(dev, dt)
    return make, dev, REF_TOL[dtype]


def get_family(name: str) -> KernelFamily:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown kernel family {name!r}; registered: "
            f"{sorted(_REGISTRY)}") from None


def family_names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def all_families() -> Tuple[KernelFamily, ...]:
    return tuple(_REGISTRY.values())


def family_for_config(cfg) -> KernelFamily:
    """Resolve a family from a config instance (replaces isinstance
    dispatch chains)."""
    for fam in _REGISTRY.values():
        if isinstance(cfg, fam.config_cls):
            return fam
    raise KeyError(f"no registered family for config {type(cfg).__name__}")
