"""Stage 2 — LLM Experiment Designer (paper §3.2).

Port of ``repro.core.designer`` (framework-free; copied with its imports
pointing at this package).

Given the Base code plus assimilated knowledge (the findings document), the
LLM produces 10 optimization *avenues*, then 5 *experiment plans* each with a
description, a rubric, a predicted performance-benefit range ``[lo, hi]`` and
an ``innovation`` score.  Three plans are then chosen **without replacement**
by the paper's fixed rule: (i) most innovative, (ii) highest maximum
performance, (iii) highest minimum performance.
"""
from __future__ import annotations

import json

from . import knowledge, prompts
from .genome import KernelGenome
from .llm import LLMClient
from .population import Population


def _candidate_edits(base_genome: KernelGenome | None) -> list:
    """Machine-readable edit suggestions shipped with the findings document
    (the digested-manual part of the knowledge base).  The LLM may use,
    modify, or ignore them."""
    g = base_genome or KernelGenome(style="library")
    cands = []
    for avenue in knowledge.AVENUES:
        for rubric, new_g in avenue.edits(g):
            base_d = json.loads(g.to_json())
            new_d = json.loads(new_g.to_json())
            edit = {k: v for k, v in new_d.items() if base_d.get(k) != v}
            cands.append({
                "avenue": avenue.name,
                "mi300_origin": avenue.mi300_origin,
                "rubric": rubric,
                "genome_edit": edit,
                "innovation_prior": avenue.innovation_prior,
            })
    return cands


def design(population: Population, basis_id: str, reference_id: str,
           llm: LLMClient, task_text: str = prompts.TASK_TEXT) -> list:
    """Returns the 5 experiment plans (dicts), unpicked."""
    base = population.get(basis_id)
    base_analysis = population.one_step_analysis(basis_id)
    base_analysis["genome"] = base.genome.to_json() if base.genome else None
    reference_analysis = population.one_step_analysis(reference_id)

    avenue_texts = ([a.description for a in knowledge.AVENUES]
                    + list(knowledge.EXTRA_AVENUE_TEXTS))
    # integrity context: genomes whose evaluation killed workers — the
    # designer is told so it stops proposing equivalents of them
    quarantined = [{"id": r.rid,
                    "genome": r.genome.to_json() if r.genome else None,
                    "error": r.error}
                   for r in population.quarantined_records()] or None
    prompt = prompts.designer_prompt(
        base_analysis, reference_analysis, base.source,
        knowledge.FINDINGS_DOCUMENT, avenue_texts,
        _candidate_edits(base.genome), task_text,
        quarantined=quarantined)
    reply = prompts.extract_reply_json(llm.complete(prompt))

    plans = list(reply["experiments"])
    validate_plans(plans)
    return plans[:5]


def validate_plans(plans: list) -> list:
    """Schema-check designer output, raising ``ValueError`` on violations.

    Real exceptions, not asserts: ``assert`` vanishes under ``python -O``,
    which would silently admit malformed plans into the loop.  A raised
    ``ValueError`` is retryable — the scientist re-asks the LLM, then falls
    back to :func:`fallback_design`.
    """
    if len(plans) < 1:
        raise ValueError("designer produced no experiment plans")
    for p in plans:
        missing = {"description", "rubric", "performance",
                   "innovation"} - set(p)
        if missing:
            raise ValueError(f"plan missing fields {sorted(missing)}: {p!r}")
        try:
            lo, hi = p["performance"]
        except (TypeError, ValueError):
            raise ValueError(f"performance must be a [lo, hi] pair: {p!r}")
        if lo > hi:
            raise ValueError(f"performance range inverted ({lo} > {hi}): {p!r}")
        if not 0 <= int(p["innovation"]) <= 100:
            raise ValueError(f"innovation outside [0, 100]: {p!r}")
    return plans


def fallback_design(population: Population, basis_id: str) -> list:
    """Deterministic rule-based plans when the LLM designer stays unusable
    after retries: take the knowledge base's own candidate edits (one per
    avenue first, for diversity), with performance ranges and innovation
    scores from the avenue priors.  Keeps the generation alive instead of
    aborting the campaign."""
    def plan(cand):
        prior = int(cand["innovation_prior"])
        return {
            "description": ("[fallback/" + cand["avenue"] + "] "
                            + cand["rubric"].splitlines()[0]),
            "rubric": cand["rubric"],
            "performance": [0, max(5, prior // 2)],
            "innovation": prior,
            "genome_edit": cand["genome_edit"],
        }

    cands = _candidate_edits(population.get(basis_id).genome)
    plans, seen_avenues = [], set()
    for cand in cands:                        # one plan per avenue first
        if len(plans) < 5 and cand["avenue"] not in seen_avenues:
            seen_avenues.add(cand["avenue"])
            plans.append(plan(cand))
    for cand in cands:                        # backfill to 5 if few avenues
        if len(plans) == 5:
            break
        if all(p["rubric"] != cand["rubric"] for p in plans):
            plans.append(plan(cand))
    return validate_plans(plans)


def pick3(plans: list) -> list:
    """The paper's fixed choose-3-of-5 rule, without replacement:
    (i) most innovative; (ii) highest max performance; (iii) highest min
    performance."""
    remaining = list(plans)
    chosen = []
    for keyfn in (lambda p: p["innovation"],
                  lambda p: p["performance"][1],
                  lambda p: p["performance"][0]):
        if not remaining:
            break
        best = max(remaining, key=keyfn)
        chosen.append(best)
        remaining.remove(best)
    return chosen
