"""Stage 3 — LLM Kernel Writer (paper §3.3).

Port of ``repro.core.writer`` (framework-free; copied with its imports
pointing at this package).

"This stage lies at the heart of the GPU Kernel Scientist process": it turns
an experiment rubric plus the Base code (with the Reference in context, and
one-step experiment analyses for both) into a complete new kernel module,
and reports which techniques it actually used — which may deviate from the
rubric.  Three writer instances are launched per generation (paper §3.2);
the EvaluationService still serialises their submissions.
"""
from __future__ import annotations

import dataclasses

from . import prompts
from .llm import LLMClient
from .population import Population


@dataclasses.dataclass(frozen=True)
class WrittenKernel:
    source: str
    genome_json: str | None
    report: str


def write(population: Population, basis_id: str, reference_id: str,
          experiment: dict, llm: LLMClient,
          task_text: str = prompts.TASK_TEXT) -> WrittenKernel:
    base = population.get(basis_id)
    ref = population.get(reference_id)

    base_record = population.one_step_analysis(basis_id)
    base_record["source"] = base.source
    base_record["genome"] = base.genome.to_json() if base.genome else None
    ref_record = population.one_step_analysis(reference_id)
    ref_record["source"] = ref.source

    from . import knowledge
    prompt = prompts.writer_prompt(experiment, base_record, ref_record,
                                   knowledge.FINDINGS_DOCUMENT, task_text)
    reply = prompts.extract_reply_json(llm.complete(prompt))

    source = reply["source"]
    genome = reply.get("genome")
    genome_json = None
    if genome is not None:
        import json

        from .genome import KernelGenome
        if isinstance(genome, str):
            genome = json.loads(genome)
        genome_json = KernelGenome(**genome).to_json()
    return WrittenKernel(source, genome_json, str(reply.get("report", "")))


def fallback_write(population: Population, basis_id: str,
                   experiment: dict) -> WrittenKernel:
    """Deterministic rule-based writer when the LLM stays unusable after
    retries: apply the experiment's machine-readable ``genome_edit`` to the
    Base genome directly (reverting to the Base if the edit is illegal) and
    render the kernel from the template.  A degraded submission beats an
    aborted generation — the evaluation platform remains the judge."""
    from . import codegen
    from .genome import KernelGenome

    base = population.get(basis_id)
    base_genome = base.genome or KernelGenome()
    genome = base_genome
    note = "resubmitting the base genome unchanged"
    edit = experiment.get("genome_edit")
    if edit:
        clean = dict(edit)
        try:
            cand = base_genome.replace(**clean)
            if not cand.validate():
                genome = cand
                note = "applied the rubric's genome_edit mechanically"
            else:
                note = ("genome_edit produced an illegal configuration; "
                        "reverted to the base genome")
        except (TypeError, ValueError):
            note = ("genome_edit did not parse against the design space; "
                    "reverted to the base genome")
    source = codegen.render_source(
        genome, experiment.get("description", "(fallback submission)"))
    return WrittenKernel(
        source, genome.to_json(),
        f"(rule-based fallback after LLM failures) {note}.")
