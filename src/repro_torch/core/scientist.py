"""The GPU Kernel Scientist closed loop (paper Fig. 1).

Port of ``repro.core.scientist``; the seeds are the port's CUDA kernels.

    seed kernels -> [ Evolutionary Selector -> Experiment Designer (5 plans,
    pick 3) -> 3x Kernel Writer -> pooled Testing & Evaluation ] * G

Everything the paper's loop records is recorded here: population with
lineage, per-config benchmark timings, experiment descriptions/rubrics,
selection rationales, writer reports, and a generation-by-generation logbook
(used by benchmarks/trajectory.py for the §4.4 discovery-process figure).

The loop is built for the paper's operating regime — autonomous multi-day
campaigns against a flaky shared evaluation queue (§3.4):

* **Per-submission persistence.**  ``population.json`` + ``state.json`` are
  rewritten atomically after every individual submission (not just every
  generation), so a crash loses at most the one in-flight kernel.
* **Resume.**  ``KernelScientist.resume(workdir, ...)`` reconstructs the
  population, logbook, and any partially-completed generation from the
  persisted state and continues the campaign.  Backend decision state
  (ScriptedLLM jitter counter, EvaluationService noise counter) is restored
  too, so a killed-and-resumed campaign produces a trajectory identical to
  an uninterrupted same-seed run.
* **Retry + fallback.**  Every LLM stage and every evaluation submission is
  retried with exponential backoff (``core.resilience``); a stage that stays
  broken falls back to a deterministic rule-based decision instead of
  aborting the generation.
* **Event log.**  Stage timings, retries, fallbacks, and evaluation outcomes
  stream to ``events.jsonl`` (``core.events``) for the §4.4 figure.
* **Pooled evaluation.**  Submissions go through the ``EvalBackend``
  protocol (``core.evalpool``) — by default an ``EvalPool`` of in-process
  or subprocess workers (``KernelScientist(backend=...)``):
  each writer output is enqueued as soon as it exists, so the writer stage
  overlaps with in-flight evaluations and a generation costs roughly
  ``max(writes) + max(evals)`` instead of ``3 x (write + eval)``.  Results
  are applied and persisted in record-id order (the pool may complete them
  in any order), and the in-flight checkpoint tracks both completed
  (``submitted``) and enqueued-but-unfinished (``pending``) records, so a
  campaign killed mid-drain resumes trajectory-identically — the pending
  kernels' sources are durable and simply re-enqueued.  A content-addressed
  cache in front of the pool returns persisted verdicts for duplicate
  sources without consuming a platform slot.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import time
import warnings
from typing import Optional

from . import codegen, designer, prompts, resilience, selector, writer
from .evalpool import (PRIORITY_URGENT, EvalBackend, EvalCache, EvalHandle,
                       EvalPool)
from .events import EventLog
from .evaluator import EvaluationService, EvalResult
from .genome import SEED_LIBRARY, SEED_MXU, SEED_NAIVE, KernelGenome
from .integrity import Integrity
from .llm import LLMClient, ScriptedLLM
from .population import KernelRecord, Population, geomean
from .resilience import CircuitOpenError

#: Sentinel distinguishing "not passed" from an explicit None for the
#: deprecated constructor kwargs.
_UNSET = object()

# v2: "service" holds EvalPool worker states; inflight gained "pending"
# (enqueued-but-unfinished record ids).  v1 files load fine: a bare service
# state dict is treated as the first worker's, and "pending" defaults empty.
# v3: adds "integrity" (audit ledger, quarantine set, breaker states, canary
# reference, consumed wall-clock).  v2 files load fine: a missing section
# leaves the Integrity components at their just-constructed state.
_STATE_SCHEMA = 3


def _errtext(e: BaseException) -> str:
    return f"{type(e).__name__}: {e}"


@dataclasses.dataclass
class GenerationLog:
    generation: int
    selection: dict
    plans: list
    picked: list
    submitted: list            # [(rid, status, geomean_us-or-None)]
    best_rid: str              # "" while the population has no ok member
    best_geomean_us: float     # inf while the population has no ok member

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        # JSON has no Infinity; json.dumps would emit the non-standard token
        if d["best_geomean_us"] == float("inf"):
            d["best_geomean_us"] = None
        return d

    @staticmethod
    def from_dict(d: dict) -> "GenerationLog":
        d = dict(d)
        if d.get("best_geomean_us") is None:
            d["best_geomean_us"] = float("inf")
        d["submitted"] = [tuple(s) for s in d.get("submitted", [])]
        return GenerationLog(**d)


class KernelScientist:
    def __init__(self, llm: Optional[LLMClient] = None,
                 backend=None,
                 task_text: str = prompts.TASK_TEXT,
                 workdir: Optional[str] = None,
                 retry_policy: Optional[resilience.RetryPolicy] = None,
                 events: Optional[EventLog] = None,
                 sleep=time.sleep,
                 integrity: Optional[Integrity] = None,
                 service=_UNSET,
                 pool=_UNSET,
                 workers=_UNSET,
                 eval_cache=_UNSET) -> None:
        """``backend`` is the single evaluation parameter: either anything
        satisfying the :class:`EvalBackend` protocol (an ``EvalPool``, a
        remote-queue client, a test double) used as-is, or a bare
        ``EvaluationService``-like object (has ``submit``) that is wrapped
        in a one-worker cached ``EvalPool``.  ``None`` wraps a default
        ``EvaluationService()``.

        ``integrity`` is the verdict-trust layer (``core.integrity``):
        timing audits with quorum re-measurement, poison-kernel quarantine,
        per-worker canaries, circuit breakers, and campaign budgets.  The
        default ``Integrity()`` has every component off, so behaviour is
        bit-for-bit what it was without one.

        ``service=`` / ``pool=`` / ``workers=`` / ``eval_cache=`` are
        deprecated shims for the pre-``EvalBackend`` surface: they still
        behave exactly as before but emit ``DeprecationWarning``; construct
        the pool explicitly instead —
        ``backend=EvalPool.of(svc, workers=3, cache=EvalCache(path))``.
        """
        self.llm = llm or ScriptedLLM()
        self.integrity = integrity or Integrity()
        self.task_text = task_text
        self.population = Population()
        self.logbook: list[GenerationLog] = []
        self.retry_policy = retry_policy or resilience.DEFAULT_POLICY
        self._sleep = sleep
        self._seeded = False
        self._inflight: Optional[dict] = None   # partially-run generation
        self.workdir = pathlib.Path(workdir) if workdir else None
        if self.workdir:
            self.workdir.mkdir(parents=True, exist_ok=True)
        self.events = events or EventLog(
            self.workdir / "events.jsonl" if self.workdir else None)
        self.pool: EvalBackend = self._resolve_backend(
            backend, service=service, pool=pool, workers=workers,
            eval_cache=eval_cache)
        self._wire_quarantine()

    def _wire_quarantine(self) -> None:
        """Hand the pool the campaign's quarantine so worker deaths feed it
        and blacklisted hashes are blocked at submit time."""
        if (self.integrity.quarantine is not None
                and isinstance(self.pool, EvalPool)):
            self.pool.quarantine = self.integrity.quarantine

    def _default_cache(self) -> EvalCache:
        """The cache __init__ semantics attach to a pool it builds itself:
        persisted in the workdir when there is one, in-memory otherwise."""
        return EvalCache(self.workdir / "eval_cache.jsonl"
                         if self.workdir else None)

    def _resolve_backend(self, backend, service, pool, workers,
                         eval_cache) -> EvalBackend:
        legacy = {k: v for k, v in dict(service=service, pool=pool,
                                        workers=workers,
                                        eval_cache=eval_cache).items()
                  if v is not _UNSET}
        if legacy and backend is not None:
            raise TypeError(
                f"pass either backend= or the deprecated kwargs "
                f"({', '.join(sorted(legacy))}), not both")
        if legacy:
            warnings.warn(
                f"KernelScientist({', '.join(k + '=' for k in sorted(legacy))}"
                f") is deprecated; pass a single backend= (an EvalBackend, "
                f"or an EvaluationService to wrap — e.g. "
                f"backend=EvalPool.of(service, workers=N, cache=...))",
                DeprecationWarning, stacklevel=3)
            pool = legacy.get("pool")
            if pool is None:
                cache = (self._default_cache()
                         if legacy.get("eval_cache", True) else None)
                pool = EvalPool.of(legacy.get("service")
                                   or EvaluationService(),
                                   workers=legacy.get("workers", 1),
                                   cache=cache,
                                   retry_policy=self.retry_policy,
                                   events=self.events, sleep=self._sleep)
            elif pool.events is None:
                pool.events = self.events
            return pool
        if backend is None:
            backend = EvaluationService()
        if isinstance(backend, EvalBackend):
            if getattr(backend, "events", _UNSET) is None:
                backend.events = self.events
            return backend
        if hasattr(backend, "submit"):
            return EvalPool.of(backend, workers=1,
                               cache=self._default_cache(),
                               retry_policy=self.retry_policy,
                               events=self.events, sleep=self._sleep)
        raise TypeError(
            f"backend must satisfy the EvalBackend protocol or be an "
            f"EvaluationService-like object with submit(); got "
            f"{type(backend).__name__}")

    # The first pool worker doubles as the legacy single-service view;
    # assigning a new service rebuilds the pool around it, preserving the
    # existing cache *instance* (a custom cache path survives even without
    # a workdir), retry policy, events, sleep, and worker count — dropping
    # to one worker if the new service can't clone.
    @property
    def service(self):
        return self.pool.services[0]

    @service.setter
    def service(self, svc) -> None:
        old = self.pool
        cache = getattr(old, "cache", None)
        if cache is None and not isinstance(old, EvalPool):
            # rebuilding around a foreign backend with no cache of its own:
            # fall back to the same default __init__ would attach
            cache = self._default_cache()
        n_workers = len(getattr(old, "services", ())) or 1
        workers = n_workers if hasattr(svc, "clone") else 1
        transport = getattr(getattr(old, "transport", None), "kind",
                            "inprocess")
        self.pool = EvalPool.of(
            svc, workers=workers, cache=cache,
            retry_policy=getattr(old, "retry_policy", self.retry_policy),
            events=getattr(old, "events", None) or self.events,
            sleep=getattr(old, "_sleep", self._sleep),
            transport=transport)
        self._wire_quarantine()
        if isinstance(old, EvalPool):
            old.close(wait=False)

    # ------------------------------------------------------------- resume
    @classmethod
    def resume(cls, workdir, llm: Optional[LLMClient] = None,
               backend=None, service=_UNSET,
               **kwargs) -> "KernelScientist":
        """Reconstruct a campaign from its workdir and continue it.

        Pass ``llm`` / ``backend`` instances constructed exactly as in the
        original run (same seeds and noise); their internal decision state is
        fast-forwarded from ``state.json`` so the continued campaign makes
        the same choices an uninterrupted run would have made.  If the last
        persisted state holds a partially-completed generation, the next
        :meth:`run` finishes it first — only the kernel that was in flight
        at the moment of the crash is re-generated and re-submitted.

        ``service=`` (and ``workers=`` / ``eval_cache=`` via ``kwargs``) are
        the deprecated pre-``EvalBackend`` spellings; ``__init__`` shims
        them with a ``DeprecationWarning``.
        """
        workdir = pathlib.Path(workdir)
        state_path = workdir / "state.json"
        if not state_path.exists():
            raise FileNotFoundError(
                f"no resumable campaign in {workdir} (state.json missing)")
        state = json.loads(state_path.read_text())
        if service is not _UNSET:
            kwargs["service"] = service
        sci = cls(llm=llm, backend=backend, workdir=workdir, **kwargs)
        if not state.get("seeded"):
            # crashed mid-seed: cheapest correct recovery is a fresh start
            sci.events.emit("resume", mode="restart_unseeded")
            return sci
        sci.population = Population.load(workdir / "population.json")
        logbook_path = workdir / "logbook.json"
        if logbook_path.exists():
            sci.logbook = [GenerationLog.from_dict(d)
                           for d in json.loads(logbook_path.read_text())]
        sci._seeded = True
        sci._restore_backend(sci.llm, state.get("llm"))
        sci.pool.load_state_dict(state.get("service"))
        if state.get("integrity"):
            sci.integrity.load_state_dict(state["integrity"])
        inflight = state.get("inflight")
        if inflight:
            inflight.setdefault("pending", [])
            # records whose evaluation completed ("submitted") or whose
            # writer output is durable ("pending" — source persisted, eval
            # to be re-enqueued) survive; anything else from the interrupted
            # generation is a ghost whose id is re-issued on replay
            durable = ({s[0] for s in inflight["submitted"]}
                       | set(inflight["pending"]))
            ghosts = [r.rid for r in sci.population
                      if r.generation == inflight["generation"]
                      and r.rid not in durable]
            for rid in ghosts:
                sci.population.remove(rid)
            sci._inflight = inflight
        sci.events.emit(
            "resume", mode="continue", generations_done=len(sci.logbook),
            population=len(sci.population),
            inflight_generation=(inflight["generation"] if inflight else None),
            inflight_submitted=(len(inflight["submitted"]) if inflight
                                else None),
            inflight_pending=(len(inflight["pending"]) if inflight else None))
        return sci

    @staticmethod
    def _restore_backend(obj, state) -> None:
        if state is not None and hasattr(obj, "load_state_dict"):
            obj.load_state_dict(state)

    # ------------------------------------------------------------ seeding
    def seed(self, genomes=(SEED_LIBRARY, SEED_NAIVE, SEED_MXU),
             descriptions=("library implementation (provided baseline)",
                           "direct translation into a CUDA kernel "
                           "(unoptimized: f32 FMA math, per-tile dequant)",
                           "first working tensor-core CUDA kernel "
                           "(128^3 tiles, fp8 wgmma fed by a TMA ring)"),
             ) -> None:
        """Paper §3: the process starts from a few seed kernels."""
        if len(self.population) != 0:
            raise RuntimeError("already seeded")
        self.events.emit("campaign_start", seeds=len(genomes))
        handles = []
        for genome, desc in zip(genomes, descriptions):
            source = codegen.render_source(genome, desc)
            rec = KernelRecord(
                rid=self.population.new_id(), parents=(), source=source,
                genome=genome,
                experiment={"description": desc, "rubric": "(seed)",
                            "performance": [0, 0], "innovation": 0},
                writer_report="(seed kernel)", generation=0)
            self.population.add(rec)
            handles.append((rec, self._submit_record(source, tag=rec.rid)))
        for rec, handle in handles:   # seeds evaluate concurrently
            self._apply_handle(rec, handle)
            self._persist()
        self._seeded = True
        self._persist()
        self.events.emit("seeded", population=len(self.population))

    # --------------------------------------------------------------- loop
    def run_generation(self, generation: int) -> GenerationLog:
        self.events.emit("generation_start", generation=generation)
        sel = self._stage(
            "selector", generation,
            lambda: selector.select(self.population, self.llm,
                                    self.task_text),
            fallback=lambda: selector.fallback_select(self.population))
        plans = self._stage(
            "designer", generation,
            lambda: designer.design(self.population, sel.basis_code,
                                    sel.basis_reference, self.llm,
                                    self.task_text),
            fallback=lambda: designer.fallback_design(self.population,
                                                      sel.basis_code))
        picked = designer.pick3(plans)
        inflight = {"generation": generation,
                    "selection": dataclasses.asdict(sel),
                    "plans": plans, "picked": picked, "submitted": [],
                    "pending": []}
        self._persist(inflight)
        return self._finish_generation(inflight)

    def _finish_generation(self, inflight: dict) -> GenerationLog:
        """Run (or, after a resume, complete) the submission half of a
        generation from its persisted in-flight checkpoint.

        The writer stage overlaps with in-flight evaluations: each writer
        output is enqueued on the pool the moment it exists (recorded as
        ``pending``), then results are applied and persisted in record-id
        order, so the durable ``submitted`` list is identical whatever
        order the pool completes them in."""
        generation = inflight["generation"]
        sel = selector.Selection(**inflight["selection"])
        picked = inflight["picked"]
        submitted = [tuple(s) for s in inflight["submitted"]]
        pending = list(inflight.get("pending", []))

        handles: dict[str, object] = {}
        for rid in pending:
            # resumed mid-drain: the writer output is durable — re-enqueue
            # its evaluation (a duplicate whose verdict already landed in
            # the cache returns without consuming a platform slot)
            handles[rid] = self._submit_record(
                self.population.get(rid).source, tag=rid)

        for exp in picked[len(submitted) + len(pending):]:
            # three independent writer instances (paper §3.2); each service
            # still serialises its own submissions — the pool is what scales
            rec = self._write_experiment(generation, sel, exp)
            pending.append(rec.rid)
            inflight["pending"] = list(pending)
            self._persist(inflight)
            handles[rec.rid] = self._submit_record(rec.source, tag=rec.rid)

        for rid in sorted(handles):   # apply in submission order
            rec = self.population.get(rid)
            self._apply_handle(rec, handles[rid])
            pending.remove(rid)
            submitted.append((rec.rid, rec.status,
                              rec.score if rec.score != float("inf")
                              else None))
            inflight["submitted"] = [list(s) for s in submitted]
            inflight["pending"] = list(pending)
            self._persist(inflight)

        remeasured = self._run_canaries(generation, handles)
        if remeasured:
            # drifted-worker verdicts were re-measured: refresh the
            # generation's submitted tuples from the trusted records
            submitted = [
                (rid, self.population.get(rid).status,
                 self.population.get(rid).score
                 if self.population.get(rid).score != float("inf") else None)
                for (rid, _, _) in submitted]
            inflight["submitted"] = [list(s) for s in submitted]
            self._persist(inflight)

        best = self.population.best()
        log = GenerationLog(
            generation=generation,
            selection=inflight["selection"],
            plans=[{k: p[k] for k in ("description", "performance",
                                      "innovation")}
                   for p in inflight["plans"]],
            picked=[p["description"] for p in picked],
            submitted=submitted,
            best_rid=best.rid if best else "",
            best_geomean_us=best.score if best else float("inf"))
        self.logbook.append(log)
        self._persist()   # clears the in-flight checkpoint
        self.events.emit(
            "generation_end", generation=generation, best_rid=log.best_rid,
            best_geomean_us=(None if log.best_geomean_us == float("inf")
                             else round(log.best_geomean_us, 3)))
        if self.integrity.health is not None:
            self.integrity.health.snapshot(
                self.events, generation=generation,
                population=len(self.population),
                submissions=getattr(self.pool, "submissions", None),
                best_geomean_us=(None if log.best_geomean_us == float("inf")
                                 else round(log.best_geomean_us, 3)))
        return log

    def _write_experiment(self, generation: int, sel, exp: dict
                          ) -> KernelRecord:
        """Writer stage only — the record joins the population as
        ``pending``; its evaluation is the caller's to enqueue."""
        wk = self._stage(
            "writer", generation,
            lambda: writer.write(self.population, sel.basis_code,
                                 sel.basis_reference, exp, self.llm,
                                 self.task_text),
            fallback=lambda: writer.fallback_write(self.population,
                                                   sel.basis_code, exp))
        rec = KernelRecord(
            rid=self.population.new_id(),
            parents=(sel.basis_code, sel.basis_reference),
            source=wk.source,
            genome=(KernelGenome.from_json(wk.genome_json)
                    if wk.genome_json else None),
            experiment={k: exp.get(k) for k in
                        ("description", "rubric", "performance",
                         "innovation")},
            writer_report=wk.report, generation=generation)
        self.population.add(rec)
        return rec

    def run(self, generations: int) -> Optional[KernelRecord]:
        if self.integrity.health is not None:
            self.integrity.health.start()
        remaining = generations
        if len(self.population) == 0 and self._inflight is None:
            self.seed()
        if self._inflight is not None and remaining > 0:
            inflight, self._inflight = self._inflight, None
            self._finish_generation(inflight)
            remaining -= 1
        start = len(self.logbook) + 1
        for g in range(start, start + remaining):
            # budgets are checked at generation boundaries only: the
            # campaign stops cleanly with everything persisted, never
            # mid-drain, and a resumed run re-checks before continuing
            if self._budget_stop(g):
                break
            self.run_generation(g)
        return self.population.best()

    def _budget_stop(self, generation: int) -> bool:
        health = self.integrity.health
        if health is None:
            return False
        reason = health.budget_exceeded(
            getattr(self.pool, "submissions", 0) or 0)
        if reason is None:
            return False
        self.events.emit("budget_stop", generation=generation, reason=reason,
                         elapsed_s=round(health.elapsed_s, 3))
        self._persist()
        return True

    # ------------------------------------------------------------ helpers
    def _stage(self, stage: str, generation: int, fn, fallback=None):
        """Run one LLM stage under the retry policy; fall back to the
        deterministic rule-based decision if it stays broken.

        With an LLM circuit breaker configured (``core.integrity``), a
        stage whose dependency is presumed down skips the whole retry/
        backoff schedule and goes straight to the fallback; the call that
        ends the breaker's cooldown is admitted as the half-open probe."""
        self.events.emit("stage_start", stage=stage, generation=generation)
        t0 = time.perf_counter()
        brk = self.integrity.llm_breaker

        if brk is not None and not brk.allow():
            e = CircuitOpenError(
                f"LLM circuit open ({brk.failures} consecutive stage "
                f"failures); using the rule-based fallback")
            self.events.emit("breaker", name="llm", action="skip",
                             state=brk.state, stage=stage,
                             generation=generation)
            if fallback is None:
                self.events.emit("stage_end", stage=stage,
                                 generation=generation, status="error",
                                 error=_errtext(e), duration_s=round(
                                     time.perf_counter() - t0, 6))
                raise e
            self.events.emit("fallback", stage=stage, generation=generation,
                             error=_errtext(e))
            out = fallback()
            self.events.emit("stage_end", stage=stage, generation=generation,
                             status="fallback",
                             duration_s=round(time.perf_counter() - t0, 6))
            return out

        def on_retry(attempt, exc, delay):
            self.events.emit("retry", stage=stage, generation=generation,
                             attempt=attempt, error=_errtext(exc),
                             delay_s=round(delay, 3))

        status = "ok"
        try:
            out = resilience.retry_call(fn, policy=self.retry_policy,
                                        on_retry=on_retry, sleep=self._sleep)
            if brk is not None:
                self._breaker_record(brk, success=True, stage=stage,
                                     generation=generation)
        except Exception as e:
            if brk is not None:
                self._breaker_record(brk, success=False, stage=stage,
                                     generation=generation)
            if fallback is None:
                self.events.emit("stage_end", stage=stage,
                                 generation=generation, status="error",
                                 error=_errtext(e), duration_s=round(
                                     time.perf_counter() - t0, 6))
                raise
            self.events.emit("fallback", stage=stage, generation=generation,
                             error=_errtext(e))
            out = fallback()
            status = "fallback"
        self.events.emit("stage_end", stage=stage, generation=generation,
                         status=status,
                         duration_s=round(time.perf_counter() - t0, 6))
        return out

    def _breaker_record(self, brk, success: bool, **fields) -> None:
        prev = brk.state
        brk.record_success() if success else brk.record_failure()
        if brk.state != prev:
            self.events.emit("breaker", name=brk.name,
                             transition=f"{prev}->{brk.state}", **fields)

    def _submit_record(self, source: str, tag,
                       priority: int = None) -> EvalHandle:
        """Submit through the eval circuit breaker (when configured): an
        open breaker refuses the submission up front with a pre-failed
        handle, so the drain marks the record ``failed`` without paying the
        pool's retry schedule against a dead backend."""
        brk = self.integrity.eval_breaker
        if brk is not None and not brk.allow():
            self.events.emit("breaker", name="eval", action="skip",
                             state=brk.state, tag=tag)
            handle = EvalHandle(EvalCache.key_of(source), tag=tag)
            handle._finish(exc=CircuitOpenError(
                f"evaluation circuit open ({brk.failures} consecutive "
                f"submission failures)"))
            return handle
        if priority is None:
            return self.pool.submit_async(source, tag=tag)
        return self.pool.submit_async(source, priority=priority, tag=tag)

    def _apply_handle(self, rec: KernelRecord, handle) -> None:
        """Block on one pooled evaluation, audit its verdict, and apply the
        trusted outcome.  A submission the platform never accepts (retries
        exhausted inside the pool worker) is marked ``failed`` rather than
        left ``pending``, so a resumed campaign carries no ghost members.
        BaseExceptions (KeyboardInterrupt — a killed campaign) propagate."""
        brk = self.integrity.eval_breaker
        try:
            res = handle.result()
        except Exception as e:
            # a refused (circuit-open) submission is not new evidence about
            # the backend — only real failures feed the breaker
            if brk is not None and not isinstance(e, CircuitOpenError):
                self._breaker_record(brk, success=False, tag=rec.rid)
            rec.status = "failed"
            rec.error = _errtext(e)
            self.events.emit("eval_result", rid=rec.rid, status="failed",
                             error=rec.error, cached=handle.cached,
                             duration_s=round(handle.duration_s, 6))
            return
        if brk is not None:
            self._breaker_record(brk, success=True, tag=rec.rid)
        res = self._audit(rec, res)
        self._apply_eval(rec, res)
        self.events.emit(
            "eval_result", rid=rec.rid, status=rec.status,
            geomean_us=(None if rec.score == float("inf")
                        else round(rec.score, 3)),
            cached=handle.cached,
            duration_s=round(handle.duration_s, 6))

    def _apply_eval(self, rec: KernelRecord, res: EvalResult) -> None:
        rec.status = res.status
        rec.error = res.error
        rec.timings_us = dict(res.timings_us)

    # -------------------------------------------------- verdict integrity
    def _audit(self, rec: KernelRecord, res: EvalResult) -> EvalResult:
        """Gate one ``ok`` verdict through the timing auditor before it may
        update the population.  A flagged verdict triggers the quorum:
        ``quorum_k`` salted resubmissions of the same kernel (urgent
        priority — the drain is blocked on this record), merged by robust
        median.  Entirely content-keyed, so the audit replays identically
        across workers counts, transports, and kill/resume (completed
        samples return as cache hits)."""
        auditor = self.integrity.auditor
        if auditor is None or res.status != "ok" or not res.timings_us:
            return res
        g = geomean(res.timings_us.values())
        reason = auditor.flag(g, self._trusted_baseline(rec))
        if reason is None:
            return res
        auditor.flags += 1
        self.events.emit("audit_flag", rid=rec.rid, geomean_us=round(g, 3),
                         reason=reason)
        sample_handles = [
            self._submit_record(auditor.salted(rec.source, i),
                                tag=f"{rec.rid}/quorum{i}",
                                priority=PRIORITY_URGENT)
            for i in range(1, auditor.quorum_k + 1)]
        samples = []
        for h in sample_handles:
            try:
                samples.append(h.result())
            except Exception:
                samples.append(None)   # a lost sample shrinks the quorum
        final, corrected = auditor.merge(res, samples)
        self.events.emit(
            "audit_quorum", rid=rec.rid, corrected=corrected,
            samples=sum(1 for s in samples
                        if s is not None and s.status == "ok"),
            geomean_us=round(g, 3),
            final_geomean_us=(round(geomean(final.timings_us.values()), 3)
                              if final.timings_us else None))
        return final

    def _trusted_baseline(self, rec: KernelRecord) -> Optional[float]:
        """Geomean of the nearest ok ancestor — the lineage expectation the
        auditor's z-test compares a fresh verdict against.  Breadth-first
        up the parent links (deterministic: parents tuples are ordered);
        ``None`` for seeds and orphans, which are therefore always
        re-measured before being trusted."""
        seen = set()
        frontier = list(rec.parents)
        while frontier:
            rid, frontier = frontier[0], frontier[1:]
            if rid in seen:
                continue
            seen.add(rid)
            try:
                anc = self.population.get(rid)
            except KeyError:
                continue
            if anc.status == "ok" and anc.timings_us:
                return geomean(anc.timings_us.values())
            frontier.extend(anc.parents)
        return None

    def _run_canaries(self, generation: int, handles: dict) -> list:
        """Generation-end drift sweep: run the known-timing sentinel on
        every worker directly (bypassing queue + cache), compare against
        the campaign reference, and respond to drift by respawning the
        worker and re-measuring every record it evaluated this generation.
        Returns the re-measured record ids."""
        canary = self.integrity.canary
        if (canary is None or not canary.due(generation)
                or not isinstance(self.pool, EvalPool)):
            return []
        sentinel = canary.sentinel_source()
        remeasured = []
        for idx in range(self.pool.transport.num_workers):
            try:
                res = self.pool.run_direct(idx, sentinel)
                g = (geomean(res.timings_us.values())
                     if res.status == "ok" and res.timings_us else None)
            except Exception as e:
                self.events.emit("canary", generation=generation, worker=idx,
                                 error=_errtext(e))
                g = None
            verdict = canary.check(g)
            self.events.emit(
                "canary", generation=generation, worker=idx, verdict=verdict,
                geomean_us=(round(g, 3) if g is not None else None),
                reference_us=(round(canary.reference_us, 3)
                              if canary.reference_us is not None else None))
            if verdict != "drift":
                continue
            self.events.emit("worker_drift", generation=generation,
                             worker=idx,
                             geomean_us=(round(g, 3) if g is not None
                                         else None),
                             reference_us=round(canary.reference_us or 0, 3))
            self.pool.respawn_worker(idx)
            # nothing this worker measured in this generation can be
            # trusted: drop the cached verdicts and re-measure urgently
            affected = sorted(
                rid for rid, h in handles.items()
                if getattr(h, "worker", None) == idx and not h.cached)
            for rid in affected:
                rec = self.population.get(rid)
                if self.pool.cache is not None:
                    self.pool.cache.invalidate(EvalCache.key_of(rec.source))
                self.events.emit("verdict_invalidated", rid=rid, worker=idx,
                                 generation=generation)
                fresh = self._submit_record(rec.source, tag=rid,
                                            priority=PRIORITY_URGENT)
                self._apply_handle(rec, fresh)
                self._persist()
                remeasured.append(rid)
        return remeasured

    def _backend_state(self, obj) -> Optional[dict]:
        sd = getattr(obj, "state_dict", None)
        return sd() if sd else None

    def _persist(self, inflight: Optional[dict] = None) -> None:
        if not self.workdir:
            return
        # population first, state.json last: state.json only ever references
        # records that are already durable, so any crash window resolves to
        # "replay the in-flight kernel"
        self.population.save(self.workdir / "population.json")
        tmp = self.workdir / "logbook.json.tmp"
        tmp.write_text(json.dumps([l.to_dict() for l in self.logbook],
                                  indent=1))
        tmp.replace(self.workdir / "logbook.json")
        state = {"schema": _STATE_SCHEMA,
                 "seeded": self._seeded,
                 "llm": self._backend_state(self.llm),
                 "service": self.pool.state_dict(),
                 "integrity": (self.integrity.state_dict()
                               if self.integrity.enabled else None),
                 "inflight": inflight}
        tmp = self.workdir / "state.json.tmp"
        tmp.write_text(json.dumps(state, indent=1))
        tmp.replace(self.workdir / "state.json")

    # ------------------------------------------------------------- report
    def trajectory(self) -> list:
        """(generation, best_geomean_us) pairs — the discovery curve.

        ``None`` (not the non-JSON token ``Infinity``) stands in for "no
        successful kernel yet"."""
        out = []
        best = min((r.score for r in self.population if r.generation == 0),
                   default=float("inf"))
        out.append((0, best if best != float("inf") else None))
        for log in self.logbook:
            best = min(best, log.best_geomean_us)
            out.append((log.generation,
                        best if best != float("inf") else None))
        return out
