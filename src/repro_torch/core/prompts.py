"""Prompt builders for the three LLM stages (paper §3.1-3.3).

Port of ``repro.core.prompts`` (framework-free; copied with its imports
pointing at this package).

Each prompt is real natural-language text with the same informational content
the paper describes, plus a fenced machine-readable JSON state block.  A
hosted LLM reads the whole prompt; the offline ScriptedLLM oracle reads only
the state block.  Both reply with a single fenced JSON object, so the stage
parsers are backend-agnostic.
"""
from __future__ import annotations

import json
from typing import Optional

STATE_OPEN = "<<<STATE_JSON"
STATE_CLOSE = "STATE_JSON>>>"


def _state_block(payload: dict) -> str:
    return f"{STATE_OPEN}\n{json.dumps(payload, indent=1)}\n{STATE_CLOSE}"


def extract_state(prompt: str) -> dict:
    start = prompt.index(STATE_OPEN) + len(STATE_OPEN)
    end = prompt.index(STATE_CLOSE)
    return json.loads(prompt[start:end])


def extract_reply_json(reply: str) -> dict:
    """Parse the model's reply: first try the whole string, then the outermost
    fenced/brace-delimited JSON object (robust to prose around it)."""
    reply = reply.strip()
    try:
        return json.loads(reply)
    except json.JSONDecodeError:
        pass
    start = reply.index("{")
    depth = 0
    for i in range(start, len(reply)):
        if reply[i] == "{":
            depth += 1
        elif reply[i] == "}":
            depth -= 1
            if depth == 0:
                return json.loads(reply[start:i + 1])
    raise ValueError("no JSON object in LLM reply")


# ---------------------------------------------------------------- selector
def selector_prompt(summary_rows: list, task_text: str) -> str:
    payload = {"stage": "selector", "population": summary_rows}
    return f"""You are the Evolutionary Selector of a GPU Kernel Scientist
system optimizing one accelerator kernel through iterative experiments.

## Task under optimization
{task_text}

## Population
Each member below is a kernel version: its ID, its parents' IDs, and its
benchmark timings in microseconds over the specified MxKxN input
configurations (lower is better; the leaderboard metric is the geometric
mean).  Failed members show their platform feedback instead of timings.

{_state_block(payload)}

## Instructions
Choose exactly one member as the 'Base' for the next experiment (the code
that will be modified) and one other member as the 'Reference' (chosen for
its ability to help in analysing experiments: e.g. a divergent optimization
path, or a member uniquely strong on one configuration).  Reply with a single
JSON object: {{"basis_code": "<id>", "basis_reference": "<id>",
"rationale": "<2-4 sentences>"}}"""


# ---------------------------------------------------------------- designer
def designer_prompt(base_analysis: dict, reference_analysis: dict,
                    base_source: str, findings: str, avenue_texts: list,
                    candidate_edits: list, task_text: str,
                    quarantined: Optional[list] = None) -> str:
    payload = {
        "stage": "designer",
        "base": base_analysis,
        "reference": reference_analysis,
        "candidate_edits": candidate_edits,
    }
    quarantine_section = ""
    if quarantined:
        payload["quarantined"] = quarantined
        quarantine_section = (
            "\n## Quarantined kernels (do not redesign these)\n"
            "The kernels listed under 'quarantined' in the state block "
            "crashed or wedged evaluation workers repeatedly and are "
            "blacklisted: any plan producing an equivalent kernel will be "
            "rejected without measurement.  Steer your experiment plans "
            "away from those configurations.\n")
    avenues = "\n".join(f"- {t}" for t in avenue_texts)
    return f"""You are the Experiment Designer of a GPU Kernel Scientist
system.  Design the next round of optimization experiments for the kernel
below, using only black-box timing feedback.

## Task under optimization
{task_text}

## Findings document (assimilated hardware knowledge)
{findings}

## Base kernel source
```python
{base_source}
```

## One-step experiment analyses (base, then reference)
{_state_block(payload)}

## Avenue starting points
{avenues}
{quarantine_section}
## Instructions
First produce 10 optimization 'avenues' that might be considered (a longer
list than needed, to increase diversity).  Then produce exactly 5 experiment
plans.  Each plan must have: a description; a multi-line rubric precise
enough for a kernel writer to implement; your estimate of the performance
benefit range in percent as [lo, hi]; and an 'innovation' score 0-100 for
how structurally novel the experiment is.  Where a plan corresponds to one
of the machine-readable candidate_edits in the state block, copy its
'genome_edit' field into the plan.  Reply with a single JSON object:
{{"avenues": [...10 strings...], "experiments": [{{"description": str,
"rubric": str, "performance": [lo, hi], "innovation": int,
"genome_edit": {{...}} | null}}, ... 5 plans ...]}}"""


# ------------------------------------------------------------------ writer
def writer_prompt(experiment: dict, base_record: dict, reference_record: dict,
                  findings: str, task_text: str) -> str:
    payload = {
        "stage": "writer",
        "experiment": experiment,
        "base": base_record,
        "reference": reference_record,
    }
    return f"""You are the Kernel Writer of a GPU Kernel Scientist system.
Implement the experiment below as a modification ('diff') of the Base kernel.
The Reference kernel is provided for contrast only.

## Task under optimization
{task_text}

## Findings document
{findings}

## Experiment to implement
Description: {experiment['description']}
Rubric:
{experiment['rubric']}

## Base kernel (modify this one)
```python
{base_record['source']}
```

## Reference kernel (context only)
```python
{reference_record['source']}
```

## One-step experiment analyses
{_state_block(payload)}

## Instructions
Produce the complete new kernel module (it must define
`run(a, b, a_scale, b_scale)` and a `GENOME` json string describing its
configuration) plus a short report of which techniques you actually used —
note explicitly if you deviated from the rubric and why.  Reply with a
single JSON object: {{"source": "<python module text>",
"genome": {{...}}, "report": "<what was implemented>"}}"""


TASK_TEXT = """Block-scaled FP8 GEMM (AMD Developer Challenge 2025 task,
re-targeted to one NVIDIA H100): C[bf16][M,N] = dequant(A[fp8_e4m3][M,K]) @
dequant(B[fp8_e4m3][K,N]) where a_scale is f32 per (row, 128-K-block) and
b_scale is f32 per (128x128)-block; accumulation in f32.  The evaluation
platform compiles the CUDA C++ kernel embedded in the submitted module with
nvcc for sm_90a, verifies numerical correctness against a reference oracle,
and returns end-to-end execution time per benchmark configuration measured
on the card — no profiler output is available, and submissions run
sequentially."""
