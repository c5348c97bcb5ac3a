"""ARGUS core of the port: the paper's contribution as a library.

Layers (the JAX package's ``repro.core``, copied; only the hardware
model differs):
  layout       — CuTe-style layout algebra (shapes/strides, nesting, division)
  tags         — symbolic tags + quasi-affine expression engine (⊥ < t < ⊤)
  dsl          — the tile IR: grids, loads/stores, compute ops, tag assertions
  analysis     — flow-sensitive, path-insensitive tag propagation
  solver       — decision layer with concrete counterexamples
  families     — the kernel-family registry (``gemm`` in this slice)
  verify_engine— staged verification (structural → tags → solver) with a
                 normalized-constraint memo cache + structured Feedback
  kernelspec   — Hopper structural checks (shared memory, registers,
                 tensor-core grain, 16-byte alignment, CTA split, masking)
  costs        — H100 cost-model constants and shared helpers
  harness      — the agentic optimization loop (knowledge base, planner,
                 selector, lowering, validator, ICRL)
"""
from .analysis import CheckReport, check
from .dsl import TileProgram
from .families import (KernelFamily, all_families, family_names,
                       get_family)
from .families.gemm import (GemmConfig, GemmProblem, build_gemm_program,
                            verify_gemm)
from .kernelspec import VerifyResult
from .solver import ProofResult, Status
from .tags import BOT, TOP, Expr, Var, app, make_tag
from .verify_engine import Feedback, VerificationEngine, default_engine

__all__ = [
    "CheckReport", "check", "TileProgram",
    "KernelFamily", "get_family", "family_names", "all_families",
    "VerificationEngine", "Feedback", "default_engine",
    "GemmConfig", "GemmProblem", "build_gemm_program", "verify_gemm",
    "VerifyResult", "ProofResult", "Status",
    "BOT", "TOP", "Expr", "Var", "app", "make_tag",
]
