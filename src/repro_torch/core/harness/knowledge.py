"""Persistent knowledge base of optimization skills (paper §6).

Each entry records: the transformation (as a concrete config rewrite in the
kernel-family config space — the config-space analogue of the paper's DSL
rewrites),
the data-flow invariants that must hold afterwards, its Table-1 tier, and a
context enumerator.  The KB is expert-curated and fixed; the ICRL loop
learns to *bind* entries to kernels, never to invent new ones (paper §8).

The entries themselves now live with their families in
:mod:`repro_torch.core.families` (each family registers its own skill list, with
shared Table-1 metadata in ``families.base.GENERIC_SKILLS``), so adding a
family — or a skill to one family — touches only that family's module.
This module is the aggregation point: ``skills_for`` resolves through the
registry, and ``KNOWLEDGE_BASE`` is the merged, Table-1-ordered view the
benchmarks print.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from ..families import (Skill, all_families, family_for_config,
                        get_family)

__all__ = ["Skill", "KNOWLEDGE_BASE", "skills_for"]


def _poly_contexts(skill_name: str):
    """Config-polymorphic context enumerator for merged KB entries: the
    config's own family supplies the rewrite steps (so a KNOWLEDGE_BASE
    'retile' row works for any family's config, as the old
    isinstance-dispatch did)."""
    def contexts(cfg, prob):
        for s in family_for_config(cfg).skills:
            if s.name == skill_name:
                return s.contexts(cfg, prob)
        return []
    return contexts


def _merged_knowledge_base() -> Tuple[Skill, ...]:
    """One row per skill name, with the ``families`` tuple unioned across
    the per-family registrations (the Table-1 coverage-matrix view)."""
    merged: Dict[str, Skill] = {}
    for fam in all_families():
        for s in fam.skills:
            prev = merged.get(s.name)
            if prev is None:
                merged[s.name] = Skill(s.name, s.tier, s.families,
                                       s.description, s.invariants,
                                       _poly_contexts(s.name))
            else:
                merged[s.name] = Skill(
                    prev.name, prev.tier,
                    prev.families + tuple(f for f in s.families
                                          if f not in prev.families),
                    prev.description, prev.invariants, prev.contexts)
    tier_rank = {"global": 0, "local": 1, "isa": 2}
    return tuple(sorted(merged.values(),
                        key=lambda s: tier_rank.get(s.tier, 3)))


KNOWLEDGE_BASE: Tuple[Skill, ...] = _merged_knowledge_base()


def skills_for(family: str) -> List[Skill]:
    """The family's skill list, straight from the registry (each entry's
    ``contexts`` enumerator is the family's own)."""
    return list(get_family(family).skills)
