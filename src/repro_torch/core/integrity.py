"""Measurement integrity: the verdict-trust authority of the campaign.

Port of ``repro.core.integrity`` (framework-free; copied with its imports
pointing at this package).

The paper's scientist steers on "only observed timing data" — which makes a
single corrupted, drifted, or lucky-jitter verdict poisonous: it enters the
population, wins selection, and biases every later generation.  KernelBench
(Ouyang et al., 2025) documents how easily noisy or invalid measurements
inflate apparent speedups; KernelFoundry (Wiedemann et al., 2025) re-measures
candidates *before* they enter the evolutionary population for exactly this
reason.  This module is the layer between "the platform said X" and "the
population believes X":

``TimingAuditor``
    Flags statistically improbable ``ok`` verdicts — a robust z-test of the
    verdict's log-geomean against the nearest trusted ancestor (plus
    "no trusted lineage" for seeds, which are always re-measured, the
    KernelFoundry rule) — and resolves flagged verdicts with a deterministic
    re-measure **quorum**: ``quorum_k`` salted resubmissions of the same
    kernel.  A salt is a trailing comment, so the genome (and therefore the
    cost-model timing) is unchanged while the content hash — the jitter key —
    differs, giving independent noise draws that are still a pure function of
    (platform seed, source, salt).  The quorum is content-keyed end to end:
    ``workers=N`` stays trajectory-identical, samples land in the eval cache,
    and a campaign killed mid-quorum replays the completed samples as cache
    hits.  A MAD test of the original against the sample median decides
    whether the original verdict is *confirmed* (kept bit-for-bit) or
    *corrected* (replaced by the per-config sample medians).

``Quarantine``
    Content-hash blacklist of kernels that kill or stall workers.  Each
    ``WorkerDiedError`` against a source hash counts one death; at
    ``after_k`` deaths the hash is quarantined — further submissions resolve
    instantly to a ``quarantined`` verdict without touching a worker, so a
    poison kernel evolution keeps rediscovering costs K worker deaths total,
    not ``max_requeues`` per rediscovery.  ``selector`` never picks
    quarantined members (their score is inf) and ``designer`` is told about
    them in its prompt context.

``CanaryController``
    Per-worker drift detection.  Every ``interval`` generations the scientist
    runs the same known-timing sentinel kernel directly on **each** worker
    (``EvalPool.run_direct`` — bypassing queue and cache, so the worker
    really measures it).  The first canary establishes the trusted reference;
    a worker whose canary deviates by more than ``tolerance`` is drifted: its
    verdicts from the current generation are cache-invalidated and
    re-measured, and the worker is respawned (stepped incarnation).

``HealthMonitor``
    The campaign watchdog: wall-clock / submission budgets that stop the
    loop at a generation boundary (``budget_stop`` event) instead of
    overrunning, plus a periodic ``health`` snapshot streamed to
    ``events.jsonl`` after every generation.

``Integrity``
    The facade the scientist owns.  Every knob defaults to *off* — a default
    ``Integrity()`` changes nothing — and all live state (audit ledger
    counters, quarantine set, breaker states, canary reference/schedule,
    consumed wall-clock) round-trips through ``state_dict`` /
    ``load_state_dict``, persisted in the campaign ``state.json`` under
    ``_STATE_SCHEMA >= 3`` so kill-and-resume keeps the trajectory-identity
    contract.

The circuit breakers themselves (LLM + eval backend) live in
``core.resilience.CircuitBreaker``; ``Integrity`` owns their instances and
persistence.
"""
from __future__ import annotations

import math
import statistics
import threading
import time
from typing import Optional

from .population import geomean
from .resilience import CircuitBreaker


class TimingAuditor:
    """Flag improbable ``ok`` verdicts and resolve them by salted quorum.

    ``flag`` is the statistical gate (robust z vs. the nearest trusted
    ancestor's geomean); ``salted`` produces the quorum sample sources;
    ``merge`` is the MAD decision between confirming the original verdict
    and correcting it to the per-config sample medians.  Everything is
    deterministic: no RNG, no wall clock."""

    def __init__(self, quorum_k: int = 3, z_max: float = 3.0,
                 sigma_floor: float = 0.25, mad_z: float = 5.0,
                 mad_floor: float = 0.02) -> None:
        if quorum_k < 1:
            raise ValueError("quorum_k must be >= 1")
        self.quorum_k = quorum_k
        self.z_max = z_max
        #: stand-in log-sigma for single-point lineage comparisons: a real
        #: optimization step moves the geomean by ~2x at most (z ~ 2.8),
        #: while a corrupted verdict at 4-5x lands well past z_max.
        self.sigma_floor = sigma_floor
        self.mad_z = mad_z
        self.mad_floor = mad_floor
        # audit ledger counters (persisted; the events log holds the detail)
        self.flags = 0
        self.quorums = 0
        self.corrected = 0

    # ------------------------------------------------------------- flagging
    def flag(self, geomean_us: float,
             baseline_us: Optional[float]) -> Optional[str]:
        """Reason string when the verdict needs a quorum, else ``None``.

        ``baseline_us`` is the geomean of the nearest trusted (already
        audited, status ok) ancestor; ``None`` means the kernel has no
        trusted lineage — seeds and orphans — which are always re-measured
        before the population may trust them."""
        if not (geomean_us > 0) or geomean_us == float("inf"):
            return "non-positive geomean"
        if baseline_us is None or not (baseline_us > 0):
            return "no trusted lineage baseline (seed or orphan)"
        z = abs(math.log(geomean_us) - math.log(baseline_us)) \
            / self.sigma_floor
        if z > self.z_max:
            return (f"z={z:.2f} vs trusted lineage baseline "
                    f"(|ln {geomean_us:.1f} - ln {baseline_us:.1f}| / "
                    f"{self.sigma_floor})")
        return None

    # -------------------------------------------------------------- quorum
    @staticmethod
    def salted(source: str, sample: int) -> str:
        """Sample ``sample`` of the re-measure quorum for ``source``.

        The salt is a trailing comment: the module still ``exec``s to the
        identical kernel (same GENOME, same cost-model timing) but its
        sha256 — the platform's jitter key and the cache key — changes, so
        each sample is an independent, *deterministic*, cacheable draw."""
        return source + f"\n# integrity-quorum sample {sample}\n"

    def merge(self, original, samples: list):
        """Resolve a flagged verdict against its quorum samples.

        Returns ``(final_result, corrected)``.  The decision is a MAD test
        in log space: if the original geomean sits within ``mad_z`` robust
        sigmas of the sample median it is *confirmed* (kept unchanged —
        the original is itself a legitimate draw); otherwise it is
        *corrected* to the per-config medians of the samples.  With no
        usable samples the original stands."""
        from .evaluator import EvalResult
        self.quorums += 1
        samples = [s for s in samples
                   if s is not None and s.status == "ok" and s.timings_us]
        if not samples:
            return original, False
        ln_gs = sorted(math.log(geomean(s.timings_us.values()))
                       for s in samples)
        med_ln = statistics.median(ln_gs)
        mad = statistics.median(abs(g - med_ln) for g in ln_gs)
        sigma = max(mad * 1.4826, self.mad_floor)
        ln_orig = math.log(geomean(original.timings_us.values()))
        if abs(ln_orig - med_ln) <= self.mad_z * sigma:
            return original, False
        self.corrected += 1
        keys = set().union(*(s.timings_us.keys() for s in samples))
        timings = {k: statistics.median(s.timings_us[k] for s in samples
                                        if k in s.timings_us)
                   for k in sorted(keys)}
        return EvalResult("ok", original.error, timings), True

    # ------------------------------------------------------------- persist
    def state_dict(self) -> dict:
        return {"flags": self.flags, "quorums": self.quorums,
                "corrected": self.corrected}

    def load_state_dict(self, d: dict) -> None:
        self.flags = d.get("flags", 0)
        self.quorums = d.get("quorums", 0)
        self.corrected = d.get("corrected", 0)


class Quarantine:
    """Content-hash blacklist of worker-killing kernels.

    Thread-safe: ``EvalPool`` worker threads call ``record_death`` /
    ``blocked`` concurrently with the scientist's submissions.  Keys are
    the same sha256 content addresses the eval cache uses."""

    def __init__(self, after_k: int = 3) -> None:
        if after_k < 1:
            raise ValueError("after_k must be >= 1")
        self.after_k = after_k
        self._deaths: dict[str, int] = {}
        self._reasons: dict[str, str] = {}
        self._lock = threading.Lock()

    def record_death(self, key: str, reason: str = "") -> int:
        """Count one worker death against ``key``; returns the new total."""
        with self._lock:
            n = self._deaths[key] = self._deaths.get(key, 0) + 1
            if n >= self.after_k and key not in self._reasons:
                self._reasons[key] = (reason or "killed its worker "
                                      f"{n} times")
            return n

    def blocked(self, key: str) -> Optional[str]:
        """The quarantine reason for ``key``, or ``None`` if admissible."""
        with self._lock:
            return self._reasons.get(key)

    def deaths(self, key: str) -> int:
        with self._lock:
            return self._deaths.get(key, 0)

    def __len__(self) -> int:
        with self._lock:
            return len(self._reasons)

    def state_dict(self) -> dict:
        with self._lock:
            return {"after_k": self.after_k, "deaths": dict(self._deaths),
                    "reasons": dict(self._reasons)}

    def load_state_dict(self, d: dict) -> None:
        with self._lock:
            self._deaths = dict(d.get("deaths", {}))
            self._reasons = dict(d.get("reasons", {}))


class CanaryController:
    """Schedule + reference for the per-worker sentinel submissions.

    The sentinel source is fixed for the whole campaign (constant content
    hash, so the content-keyed platform answers with constant timings on a
    healthy worker — the reference comparison is exact up to drift).  The
    first measurement establishes the reference; ``check`` classifies each
    subsequent one."""

    def __init__(self, interval: int = 1, tolerance: float = 0.25) -> None:
        if interval < 1:
            raise ValueError("interval must be >= 1 generation")
        if tolerance <= 0:
            raise ValueError("tolerance must be positive")
        self.interval = interval
        self.tolerance = tolerance
        self.reference_us: Optional[float] = None
        self.runs = 0
        self.drifts = 0
        self._sentinel: Optional[str] = None

    def due(self, generation: int) -> bool:
        return generation % self.interval == 0

    def sentinel_source(self) -> str:
        if self._sentinel is None:
            from . import codegen
            from .genome import SEED_MXU
            self._sentinel = codegen.render_source(
                SEED_MXU, "integrity canary: known-timing sentinel kernel")
        return self._sentinel

    def check(self, geomean_us: Optional[float]) -> str:
        """Classify one canary measurement: ``baseline`` (first trusted
        measurement), ``ok``, or ``drift``."""
        self.runs += 1
        if geomean_us is None or not (geomean_us > 0):
            self.drifts += 1
            return "drift"
        if self.reference_us is None:
            self.reference_us = geomean_us
            return "baseline"
        if abs(math.log(geomean_us / self.reference_us)) \
                > math.log1p(self.tolerance):
            self.drifts += 1
            return "drift"
        return "ok"

    def state_dict(self) -> dict:
        return {"interval": self.interval, "tolerance": self.tolerance,
                "reference_us": self.reference_us, "runs": self.runs,
                "drifts": self.drifts}

    def load_state_dict(self, d: dict) -> None:
        self.reference_us = d.get("reference_us")
        self.runs = d.get("runs", 0)
        self.drifts = d.get("drifts", 0)


class HealthMonitor:
    """Wall-clock / submission budgets + periodic health snapshots.

    Budgets are enforced at generation boundaries (the scientist checks
    before starting a generation) so the campaign stops cleanly with its
    state persisted, never mid-drain.  Consumed wall-clock is accumulated
    across resumes: ``state_dict`` folds the running segment in, and a
    resumed campaign continues the budget where the killed one left off."""

    def __init__(self, max_wall_clock_s: Optional[float] = None,
                 max_submissions: Optional[int] = None,
                 clock=time.monotonic) -> None:
        self.max_wall_clock_s = max_wall_clock_s
        self.max_submissions = max_submissions
        self._clock = clock
        self._accumulated_s = 0.0
        self._t0: Optional[float] = None

    def start(self) -> None:
        if self._t0 is None:
            self._t0 = self._clock()

    @property
    def elapsed_s(self) -> float:
        running = (self._clock() - self._t0) if self._t0 is not None else 0.0
        return self._accumulated_s + running

    def budget_exceeded(self, submissions: int) -> Optional[str]:
        if (self.max_submissions is not None
                and submissions >= self.max_submissions):
            return (f"submission budget exhausted "
                    f"({submissions}/{self.max_submissions})")
        if (self.max_wall_clock_s is not None
                and self.elapsed_s >= self.max_wall_clock_s):
            return (f"wall-clock budget exhausted "
                    f"({self.elapsed_s:.1f}s/{self.max_wall_clock_s}s)")
        return None

    def snapshot(self, events, **fields) -> None:
        """Stream one ``health`` event (the watchdog's periodic heartbeat)."""
        events.emit("health", elapsed_s=round(self.elapsed_s, 3),
                    budget_wall_clock_s=self.max_wall_clock_s,
                    budget_submissions=self.max_submissions, **fields)

    def state_dict(self) -> dict:
        return {"elapsed_s": round(self.elapsed_s, 3)}

    def load_state_dict(self, d: dict) -> None:
        self._accumulated_s = d.get("elapsed_s", 0.0)
        self._t0 = None        # restarted by the next run()


class Integrity:
    """Facade bundling the verdict-trust components for one campaign.

    Every knob defaults to *off*: ``Integrity()`` builds no components and
    the scientist behaves exactly as before.  Components are enabled
    independently —

    * ``quorum_k > 0``           → :class:`TimingAuditor`
    * ``quarantine_after > 0``   → :class:`Quarantine` (wired into the pool)
    * ``canary_interval > 0``    → :class:`CanaryController`
    * ``budget_*`` set           → :class:`HealthMonitor`
    * ``breaker_failures > 0``   → LLM + eval :class:`CircuitBreaker` pair
    """

    def __init__(self, quorum_k: int = 0, z_max: float = 3.0,
                 sigma_floor: float = 0.25, mad_z: float = 5.0,
                 quarantine_after: int = 0,
                 canary_interval: int = 0, canary_tolerance: float = 0.25,
                 budget_submissions: Optional[int] = None,
                 budget_wall_clock_s: Optional[float] = None,
                 breaker_failures: int = 0, breaker_cooldown: int = 8,
                 clock=time.monotonic) -> None:
        self.config = {
            "quorum_k": quorum_k, "z_max": z_max,
            "sigma_floor": sigma_floor, "mad_z": mad_z,
            "quarantine_after": quarantine_after,
            "canary_interval": canary_interval,
            "canary_tolerance": canary_tolerance,
            "budget_submissions": budget_submissions,
            "budget_wall_clock_s": budget_wall_clock_s,
            "breaker_failures": breaker_failures,
            "breaker_cooldown": breaker_cooldown,
        }
        self.auditor = (TimingAuditor(quorum_k=quorum_k, z_max=z_max,
                                      sigma_floor=sigma_floor, mad_z=mad_z)
                        if quorum_k else None)
        self.quarantine = (Quarantine(after_k=quarantine_after)
                           if quarantine_after else None)
        self.canary = (CanaryController(interval=canary_interval,
                                        tolerance=canary_tolerance)
                       if canary_interval else None)
        self.health = (HealthMonitor(max_wall_clock_s=budget_wall_clock_s,
                                     max_submissions=budget_submissions,
                                     clock=clock)
                       if (budget_submissions is not None
                           or budget_wall_clock_s is not None) else None)
        self.llm_breaker = (CircuitBreaker(
            failure_threshold=breaker_failures,
            cooldown_calls=breaker_cooldown, name="llm")
            if breaker_failures else None)
        self.eval_breaker = (CircuitBreaker(
            failure_threshold=breaker_failures,
            cooldown_calls=breaker_cooldown, name="eval")
            if breaker_failures else None)

    @property
    def enabled(self) -> bool:
        return any(c is not None for c in
                   (self.auditor, self.quarantine, self.canary, self.health,
                    self.llm_breaker))

    def state_dict(self) -> dict:
        parts = {"config": dict(self.config)}
        for name in ("auditor", "quarantine", "canary", "health",
                     "llm_breaker", "eval_breaker"):
            comp = getattr(self, name)
            parts[name] = comp.state_dict() if comp is not None else None
        return parts

    def load_state_dict(self, d: dict) -> None:
        if not d:
            return
        for name in ("auditor", "quarantine", "canary", "health",
                     "llm_breaker", "eval_breaker"):
            comp = getattr(self, name)
            if comp is not None and d.get(name) is not None:
                comp.load_state_dict(d[name])
