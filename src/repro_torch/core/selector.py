"""Stage 1 — LLM Evolutionary Selector (paper §3.1).

Port of ``repro.core.selector`` (framework-free; copied with its imports
pointing at this package).

From the population (IDs, parent lineage, per-config benchmark timings) the
LLM picks a *Base* for the next experiment and a *Reference* "chosen for its
ability to help in analysing experiments".  There is deliberately no
hand-built selection mechanism beyond this (the paper relies on the LLM's
multi-objective judgement); the stage only validates the reply.
"""
from __future__ import annotations

import dataclasses

from . import prompts
from .llm import LLMClient
from .population import Population


@dataclasses.dataclass(frozen=True)
class Selection:
    basis_code: str
    basis_reference: str
    rationale: str


def select(population: Population, llm: LLMClient,
           task_text: str = prompts.TASK_TEXT) -> Selection:
    rows = population.summary_table()
    prompt = prompts.selector_prompt(rows, task_text)
    reply = prompts.extract_reply_json(llm.complete(prompt))

    basis = str(reply["basis_code"])
    reference = str(reply["basis_reference"])
    known = {r["id"] for r in rows}
    if basis not in known:
        raise ValueError(f"selector returned unknown basis {basis!r}")
    if population.get(basis).status != "ok":
        raise ValueError(f"selector basis {basis!r} has no benchmarks")
    if (reference not in known
            or population.get(reference).status == "quarantined"):
        # tolerate a hallucinated reference — and refuse a quarantined one
        # (a worker-killing kernel has no timings worth comparing against):
        # fall back to the basis' parent
        parents = population.get(basis).parents
        reference = parents[0] if parents else basis
    return Selection(basis, reference, str(reply.get("rationale", "")))


def fallback_select(population: Population) -> Selection:
    """Deterministic rule-based selection when the LLM selector stays
    unusable after retries: best-scoring editable kernel as the Base, its
    direct parent (else the best other member) as the Reference.  Mirrors
    the paper's A.1 rule (ii) so a degraded generation still advances the
    campaign instead of aborting it."""
    ok = population.ok_records()
    if not ok:
        raise RuntimeError(
            "cannot select: no successfully evaluated kernels in the "
            "population (every submission so far failed)")
    editable = [r for r in ok
                if not (r.genome and r.genome.style == "library")]
    basis = min(editable or ok, key=lambda r: (r.score, r.rid))
    others = sorted(r.rid for r in ok if r.rid != basis.rid)
    reference = (basis.parents[0] if basis.parents
                 else (others[0] if others else basis.rid))
    return Selection(
        basis.rid, reference,
        f"(rule-based fallback after LLM failures) Run {basis.rid} has the "
        f"lowest geometric-mean benchmark score among editable kernels; run "
        f"{reference} is its direct parent or the next-best evaluated "
        f"member, giving the designer the closest useful comparison point.")
