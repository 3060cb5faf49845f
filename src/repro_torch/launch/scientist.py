"""Run the Kernel Scientist campaign on the card, with persisted artifacts.

The twin of ``examples/kernel_scientist_run.py``: population JSON,
generation logbook, JSONL event log, eval cache and every generated kernel
source land in ``--workdir``.

    PYTHONPATH=src python -m repro_torch.launch.scientist --generations 4

Every verdict is a wall-clock time measured on the card (one warm-up, then
the minimum of three, over the 18 challenge shapes at full size).  Without
a CUDA device the campaign raises.  ``--workers N`` evaluates on N services
that share the one card, so their timings disturb each other: keep the
default of 1 for numbers you mean to keep.

The submitted kernels are LLM-written CUDA, so they are evaluated in
worker processes by default (``--transport subprocess``): a kernel that
faults poisons only its worker's CUDA context, gets its ``runtime_error``
verdict, and the worker comes back in a fresh process for the next one.
``--job-timeout-s`` reaps a worker whose kernel never returns.
``--transport inprocess`` evaluates in this process, which then stops at
the first such fault (``evaluator.PoisonedContextError``).
"""
from __future__ import annotations

import argparse
import pathlib

import torch

from ..core import (BENCH_CONFIGS_18, NO_WAIT_POLICY, EvalCache, EvalPool,
                    EvaluationService, KernelScientist, ScriptedLLM)


def run_campaign(generations: int, workdir, *, seed: int = 0,
                 workers: int = 1, noise: float = 0.0, device=None,
                 bench_configs=BENCH_CONFIGS_18, transport="inprocess",
                 job_timeout_s=None) -> KernelScientist:
    """Seed, run ``generations`` generations, write ``kernels/*.py``.

    Returns the scientist with its pool still open (``sci.pool.close()``
    when done).  ``device=None`` is the card; ``"cpu"`` runs the kernels'
    plain versions (for tests at small ``bench_configs``).  ``transport``
    and ``job_timeout_s`` go to the pool (``EvalPool``'s default,
    ``"inprocess"``, as in ``repro``; :func:`main` asks for
    ``"subprocess"``)."""
    wd = pathlib.Path(workdir)
    service = EvaluationService(device=device, bench_configs=bench_configs,
                                noise=noise, seed=seed)
    options = ({"job_timeout_s": job_timeout_s}
               if transport == "subprocess" else None)
    backend = EvalPool.of(service, workers=workers,
                          cache=EvalCache(wd / "eval_cache.jsonl"),
                          retry_policy=NO_WAIT_POLICY, transport=transport,
                          transport_options=options)
    sci = KernelScientist(llm=ScriptedLLM(seed=seed), backend=backend,
                          workdir=wd, retry_policy=NO_WAIT_POLICY)
    sci.run(generations=generations)
    (wd / "kernels").mkdir(exist_ok=True)
    for rec in sci.population:
        (wd / "kernels" / f"{rec.rid}.py").write_text(rec.source)
    return sci


def report(sci: KernelScientist) -> list:
    """Lines describing the campaign: every record, then best vs library."""
    lines = []
    for rec in sci.population:
        score = f"{rec.score:.1f} us" if rec.score != float("inf") else "-"
        what = rec.genome.describe() if rec.genome else "(hand-written)"
        lines.append(f"{rec.rid} gen {rec.generation} {rec.status:13s} "
                     f"geomean {score:>12s} | {what}")
    best = sci.population.best()
    lib = next((r for r in sci.population
                if r.genome and r.genome.style == "library"), None)
    if best is not None and lib is not None and lib.status == "ok":
        lines.append(f"best: {best.rid} {best.score:.1f} us "
                     f"({best.score / lib.score:.3f}x the library seed's "
                     f"{lib.score:.1f} us) | {best.genome.describe()}")
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--generations", type=int, default=4)
    ap.add_argument("--workdir", default="results/torch_scientist_run")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--noise", type=float, default=0.0,
                    help="benchmark jitter sigma on top of the measured time")
    ap.add_argument("--transport", choices=("inprocess", "subprocess"),
                    default="subprocess",
                    help="where submitted kernels run: worker processes "
                         "that a faulting kernel cannot take the campaign "
                         "down with (default), or this process")
    ap.add_argument("--job-timeout-s", type=float, default=600.0,
                    help="subprocess workers: reap one whose evaluation "
                         "outlasts this")
    args = ap.parse_args(argv)
    sci = run_campaign(args.generations, args.workdir, seed=args.seed,
                       workers=args.workers, noise=args.noise,
                       transport=args.transport,
                       job_timeout_s=args.job_timeout_s)
    try:
        print(f"device: {torch.cuda.get_device_name(0)}")
        for line in report(sci):
            print(line)
        stats = sci.pool.stats()
        print(f"{stats['submissions']} platform submissions, "
              f"{stats.get('cache_hits', 0)} cache hits; artifacts in "
              f"{args.workdir}/")
    finally:
        sci.pool.close()


if __name__ == "__main__":
    main()
