"""Campaign resilience: retry/backoff policies and seeded fault injection.

Port of ``repro.core.resilience`` (framework-free; copied with its imports
pointing at this package).

The paper's loop ran autonomously for days against a *shared external
evaluation queue* (§3.4): submissions were processed sequentially by a remote
platform with variable queueing delays, transient API failures, and
occasionally malformed LLM replies.  Surviving that environment — rather than
aborting a multi-day campaign on the first hiccup — is part of the method.
This module supplies the two halves needed to reproduce it offline:

* ``RetryPolicy`` / ``retry_call`` — bounded retry with exponential backoff
  and deterministic jitter, plus an optional per-attempt timeout.  Knob →
  paper §3.4 mapping:

  - ``max_attempts``  — how many times a stage re-asks the LLM or re-submits
    to the evaluation queue before the scientist falls back to a rule-based
    decision (the paper's loop "waited and retried" on platform errors).
  - ``base_delay_s`` / ``multiplier`` / ``max_delay_s`` — exponential backoff
    between attempts, modelling the "good citizen" pacing against the shared
    sequential queue (§3.4: one submission in flight at a time).
  - ``jitter`` — deterministic (seed + attempt hashed) spread of the backoff
    so many campaigns do not thunder the queue in lockstep.
  - ``timeout_s`` — per-attempt wall-clock bound, modelling the variable and
    occasionally unbounded evaluation-queue delays; a timed-out attempt is
    retried like any transient failure.  (Implemented with a worker thread;
    an abandoned attempt may keep running in the background — acceptable for
    network calls, so the default is ``None`` for in-process backends.)

* ``FlakyLLM`` / ``FlakyService`` — seeded fault-injection decorators that
  wrap an ``LLMClient`` / ``EvaluationService`` and deterministically inject
  transient errors, timeouts, and malformed (non-JSON) replies *without*
  consuming the wrapped backend's state.  They make every resilience path in
  ``KernelScientist`` testable in this offline container; a given
  ``(seed, call_index)`` pair always produces the same fault, so soak tests
  are exactly reproducible.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import time
from typing import Callable, Optional


class TransientError(RuntimeError):
    """A failure worth retrying: dropped connection, HTTP 5xx, queue hiccup."""


class ServiceBusyError(TransientError):
    """An evaluation worker is occupied by another in-flight submission.

    Distinct from a real platform fault: the submission never reached the
    platform, the worker is simply busy, so the right response is to reroute
    (resubmit immediately, ideally to a different worker) rather than to
    back off exponentially.  ``RetryPolicy.no_backoff`` encodes exactly
    that: ``retry_call`` retries these with zero delay."""


#: Exception types that ``retry_call`` retries by default.  ``ValueError`` and
#: ``KeyError`` cover malformed LLM replies (bad JSON, missing schema fields);
#: ``TimeoutError`` covers per-attempt timeouts; ``ConnectionError`` / OSError
#: cover the network failures an HTTP backend raises.
DEFAULT_RETRYABLE = (TransientError, TimeoutError, ValueError, KeyError,
                     ConnectionError, OSError)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    max_attempts: int = 4
    base_delay_s: float = 0.5
    multiplier: float = 2.0
    max_delay_s: float = 30.0
    jitter: float = 0.25          # +- fraction of the delay, deterministic
    timeout_s: Optional[float] = None
    retryable: tuple = DEFAULT_RETRYABLE
    #: Exception types retried with *zero* delay: the failure means "worker
    #: occupied, reroute now", not "platform unhealthy, back off".
    no_backoff: tuple = (ServiceBusyError,)
    seed: int = 0

    def delay(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (1-based), deterministic."""
        d = min(self.base_delay_s * self.multiplier ** (attempt - 1),
                self.max_delay_s)
        if self.jitter:
            d *= 1.0 + self.jitter * _unit(self.seed, "delay", attempt)
        return max(d, 0.0)


#: Sensible production default (~0.5s, 1s, 2s between 4 attempts).
DEFAULT_POLICY = RetryPolicy()

#: For tests and offline ScriptedLLM runs: same attempt budget, no waiting.
NO_WAIT_POLICY = RetryPolicy(base_delay_s=0.0, jitter=0.0)


def _unit(*parts) -> float:
    """Deterministic pseudo-random float in [-1, 1] from the hashed parts."""
    h = hashlib.sha256(":".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(h[:8], "big") / 2 ** 63 - 1.0


def _uniform01(*parts) -> float:
    """Deterministic pseudo-random float in [0, 1) from the hashed parts."""
    h = hashlib.sha256(":".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(h[:8], "big") / 2 ** 64


def _call_with_timeout(fn: Callable, timeout_s: Optional[float]):
    if not timeout_s:
        return fn()
    import concurrent.futures
    ex = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    fut = ex.submit(fn)
    try:
        return fut.result(timeout=timeout_s)
    except concurrent.futures.TimeoutError:
        raise TimeoutError(f"attempt exceeded the {timeout_s}s stage timeout")
    finally:
        ex.shutdown(wait=False)


def retry_call(fn: Callable, policy: RetryPolicy = DEFAULT_POLICY,
               on_retry: Optional[Callable] = None,
               sleep: Callable = time.sleep):
    """Call ``fn()`` under ``policy``; return its result.

    Retryable exceptions are swallowed up to ``policy.max_attempts`` total
    attempts with exponential backoff between them; the last one is re-raised.
    Non-retryable exceptions (and BaseExceptions such as KeyboardInterrupt)
    propagate immediately.  ``on_retry(attempt, exc, delay_s)`` is invoked
    before each backoff so callers can log retries.
    """
    if policy.max_attempts < 1:
        raise ValueError("max_attempts must be >= 1")
    for attempt in range(1, policy.max_attempts + 1):
        try:
            return _call_with_timeout(fn, policy.timeout_s)
        except policy.retryable as e:
            if attempt == policy.max_attempts:
                raise
            delay = (0.0 if isinstance(e, policy.no_backoff)
                     else policy.delay(attempt))
            if on_retry is not None:
                on_retry(attempt, e, delay)
            if delay:
                sleep(delay)


# ---------------------------------------------------------------------------
# Seeded fault injection
# ---------------------------------------------------------------------------
_MALFORMED_REPLY = ("I could not produce the requested JSON this time — "
                    "here is a prose apology instead. (injected fault: "
                    "malformed LLM reply)")


class FlakyLLM:
    """Wrap an ``LLMClient`` and deterministically inject transient faults.

    Per call, one uniform draw keyed on ``(seed, call_index)`` selects the
    fault: ``TransientError`` with probability ``error_rate``, ``TimeoutError``
    with ``timeout_rate``, a malformed non-JSON reply with ``malformed_rate``,
    otherwise the wrapped client answers.  Faults fire *before* the wrapped
    client is consulted, so its internal call counter only advances on the
    attempts that actually reach it.
    """

    def __init__(self, inner, seed: int = 0, error_rate: float = 0.1,
                 timeout_rate: float = 0.0, malformed_rate: float = 0.0):
        if error_rate + timeout_rate + malformed_rate > 1.0:
            raise ValueError("fault rates must sum to <= 1")
        self.inner = inner
        self.seed = seed
        self.error_rate = error_rate
        self.timeout_rate = timeout_rate
        self.malformed_rate = malformed_rate
        self.calls = 0
        self.faults = 0

    def complete(self, prompt: str) -> str:
        self.calls += 1
        u = _uniform01(self.seed, "llm", self.calls)
        if u < self.error_rate:
            self.faults += 1
            raise TransientError(
                f"injected: LLM API returned HTTP 503 (call {self.calls})")
        if u < self.error_rate + self.timeout_rate:
            self.faults += 1
            raise TimeoutError(
                f"injected: LLM API stalled past the deadline "
                f"(call {self.calls})")
        if u < self.error_rate + self.timeout_rate + self.malformed_rate:
            self.faults += 1
            return _MALFORMED_REPLY
        return self.inner.complete(prompt)

    # resumable-campaign state (see KernelScientist.resume)
    def state_dict(self) -> dict:
        inner = getattr(self.inner, "state_dict", None)
        return {"calls": self.calls, "faults": self.faults,
                "inner": inner() if inner else None}

    def load_state_dict(self, d: dict) -> None:
        self.calls = d["calls"]
        self.faults = d.get("faults", 0)
        if d.get("inner") is not None:
            self.inner.load_state_dict(d["inner"])


class FlakyService:
    """Wrap an ``EvaluationService`` and inject transient submission failures.

    Models the shared evaluation queue dropping or timing out a submission
    (paper §3.4) before it reaches the platform: the wrapped service's
    submission counter does not advance on an injected fault, exactly like a
    request that never arrived.
    """

    def __init__(self, inner, seed: int = 0, error_rate: float = 0.1,
                 timeout_rate: float = 0.0):
        if error_rate + timeout_rate > 1.0:
            raise ValueError("fault rates must sum to <= 1")
        self.inner = inner
        self.seed = seed
        self.error_rate = error_rate
        self.timeout_rate = timeout_rate
        self.calls = 0
        self.faults = 0

    def submit(self, source: str):
        self.calls += 1
        u = _uniform01(self.seed, "svc", self.calls)
        if u < self.error_rate:
            self.faults += 1
            raise TransientError(
                f"injected: evaluation queue dropped the submission "
                f"(call {self.calls})")
        if u < self.error_rate + self.timeout_rate:
            self.faults += 1
            raise TimeoutError(
                f"injected: evaluation queue exceeded its deadline "
                f"(call {self.calls})")
        return self.inner.submit(source)

    def state_dict(self) -> dict:
        inner = getattr(self.inner, "state_dict", None)
        return {"calls": self.calls, "faults": self.faults,
                "inner": inner() if inner else None}

    def load_state_dict(self, d: dict) -> None:
        self.calls = d["calls"]
        self.faults = d.get("faults", 0)
        if d.get("inner") is not None:
            self.inner.load_state_dict(d["inner"])

    def clone(self) -> "FlakyService":
        """An independent worker for ``EvalPool.of``: same platform (the
        inner service clones with an identical timing seed) but a distinct
        fault stream, as two routes into a shared queue would fail
        independently.  Chained cloning (clone of a clone) steps the fault
        seed again, giving every pool worker its own stream."""
        return FlakyService(self.inner.clone(), seed=self.seed + 1,
                            error_rate=self.error_rate,
                            timeout_rate=self.timeout_rate)

    def service_spec(self) -> dict:
        """JSON spec so a subprocess worker rebuilds this wrapper stack
        (``eval_worker.build_service``) with identical seeds and rates."""
        from .transport import service_spec_of
        return {"kind": "flaky", "inner": service_spec_of(self.inner),
                "seed": self.seed, "error_rate": self.error_rate,
                "timeout_rate": self.timeout_rate}

    def __getattr__(self, name):
        # delegate everything else (submissions, bench_configs, ...) so the
        # wrapper is a drop-in EvaluationService
        return getattr(self.inner, name)


class CircuitOpenError(RuntimeError):
    """Raised (or reported) when a circuit breaker is open: the dependency
    is presumed down, so the caller should take its fallback path *now*
    instead of paying the full retry/backoff schedule.  Deliberately not a
    ``TransientError``: ``retry_call`` must not retry it."""


class CircuitBreaker:
    """Classic closed / open / half-open breaker, deterministic by design.

    Guards a dependency (the LLM API, the evaluation backend) that is
    retried per call by ``retry_call``: once ``failure_threshold``
    *consecutive* calls have failed even after their retries, the breaker
    opens and subsequent calls are refused up front — the scientist flips
    straight to its rule-based fallback instead of paying the full backoff
    schedule against a dead dependency on every stage.

    Recovery is probed after ``cooldown_calls`` *refused calls* rather than
    after a wall-clock interval: the campaign's behaviour stays a pure
    function of the call sequence (no clock reads), which preserves the
    kill-and-resume trajectory-identity contract.  The call that ends the
    cooldown is admitted as the half-open probe; its outcome closes the
    breaker (success) or re-opens it for another cooldown (failure).
    """

    def __init__(self, failure_threshold: int = 3, cooldown_calls: int = 8,
                 name: str = "breaker"):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if cooldown_calls < 1:
            raise ValueError("cooldown_calls must be >= 1")
        self.failure_threshold = failure_threshold
        self.cooldown_calls = cooldown_calls
        self.name = name
        self.state = "closed"
        self.failures = 0            # consecutive, while closed
        self.skips = 0               # refused calls, while open
        self.trips = 0               # lifetime closed->open transitions

    def allow(self) -> bool:
        """Admit this call?  Counts one cooldown tick when open; the call
        that completes the cooldown is admitted as the half-open probe."""
        if self.state == "closed":
            return True
        if self.state == "open":
            self.skips += 1
            if self.skips >= self.cooldown_calls:
                self.state = "half_open"
                return True          # this call IS the probe
            return False
        return False                 # half_open: one probe already in flight

    def record_success(self) -> None:
        self.state = "closed"
        self.failures = 0
        self.skips = 0

    def record_failure(self) -> None:
        if self.state == "half_open":
            self.state = "open"      # probe failed: restart the cooldown
            self.skips = 0
            return
        self.failures += 1
        if self.state == "closed" and self.failures >= self.failure_threshold:
            self.state = "open"
            self.skips = 0
            self.trips += 1

    def state_dict(self) -> dict:
        return {"state": self.state, "failures": self.failures,
                "skips": self.skips, "trips": self.trips}

    def load_state_dict(self, d: dict) -> None:
        self.state = d.get("state", "closed")
        self.failures = d.get("failures", 0)
        self.skips = d.get("skips", 0)
        self.trips = d.get("trips", 0)


class CrashService:
    """Wrap an ``EvaluationService`` and deterministically *kill the whole
    worker process* mid-benchmark — the fault class that distinguishes a
    distributed campaign from a threaded one: a segfaulting kernel, an OOM
    kill, a preempted host.

    ``os._exit`` (no cleanup, no Python unwinding) models a hard death; the
    draw is keyed on ``(seed, incarnation, call_index)``, so a respawned
    worker (stepped incarnation — ``SubprocessTransport`` passes it through
    ``eval_worker.build_service``) faces a fresh fault stream and the
    resubmitted job eventually passes rather than crash-looping at the same
    call forever.  Only meaningful inside a subprocess worker: in-process it
    would take the campaign (or the test runner) down with it, which is
    exactly the failure mode the subprocess transport exists to contain.
    """

    def __init__(self, inner, seed: int = 0, crash_rate: float = 0.1,
                 incarnation: int = 0):
        if not 0.0 <= crash_rate <= 1.0:
            raise ValueError("crash_rate must be in [0, 1]")
        self.inner = inner
        self.seed = seed
        self.crash_rate = crash_rate
        self.incarnation = incarnation
        self.calls = 0

    def submit(self, source: str):
        self.calls += 1
        u = _uniform01(self.seed, "kill", self.incarnation, self.calls)
        if u < self.crash_rate:
            os._exit(17)          # hard worker death, mid-benchmark
        return self.inner.submit(source)

    def clone(self) -> "CrashService":
        return CrashService(self.inner.clone(), seed=self.seed + 1,
                            crash_rate=self.crash_rate,
                            incarnation=self.incarnation)

    def service_spec(self) -> dict:
        from .transport import service_spec_of
        return {"kind": "crash", "inner": service_spec_of(self.inner),
                "seed": self.seed, "crash_rate": self.crash_rate}

    def __getattr__(self, name):
        return getattr(self.inner, name)


class CorruptTimingService:
    """Wrap an ``EvaluationService`` and corrupt a fraction of ``ok``
    verdicts' timings — the silent measurement failure ``core.integrity``'s
    ``TimingAuditor`` exists to catch (a thermal-throttled device, a
    contended host, a platform bug reporting the wrong kernel's numbers).

    The corruption draw is keyed on ``(seed, source_hash)`` — content, not
    call order — so the *same* kernel source is corrupted (or not) on every
    worker, every incarnation, and every quorum-free resubmission, exactly
    like the platform's content-keyed jitter.  Crucially the auditor's
    *salted* quorum samples hash differently and therefore draw their own
    (mostly clean) corruption verdicts, which is what lets median-of-k
    recover the true timing.  ``clone()`` keeps the same seed for the same
    reason: corruption must be a property of the submission, not of which
    worker served it, or ``workers=N`` would diverge from ``workers=1``.
    """

    def __init__(self, inner, seed: int = 0, corrupt_rate: float = 0.1,
                 factor: float = 5.0):
        if not 0.0 <= corrupt_rate <= 1.0:
            raise ValueError("corrupt_rate must be in [0, 1]")
        if factor <= 1.0:
            raise ValueError("factor must be > 1")
        self.inner = inner
        self.seed = seed
        self.corrupt_rate = corrupt_rate
        self.factor = factor
        self.corruptions = 0

    def submit(self, source: str):
        res = self.inner.submit(source)
        if res.status != "ok" or not res.timings_us:
            return res
        skey = hashlib.sha256(source.encode()).hexdigest()
        if _uniform01(self.seed, "corrupt", skey) >= self.corrupt_rate:
            return res
        self.corruptions += 1
        scale = (self.factor
                 if _uniform01(self.seed, "corrupt-dir", skey) < 0.5
                 else 1.0 / self.factor)
        timings = {k: v * scale for k, v in res.timings_us.items()}
        return type(res)(res.status, res.error, timings)

    def clone(self) -> "CorruptTimingService":
        # SAME seed on purpose: corruption is content-keyed, so every
        # worker must agree on which sources are corrupted (see class doc).
        return CorruptTimingService(self.inner.clone(), seed=self.seed,
                                    corrupt_rate=self.corrupt_rate,
                                    factor=self.factor)

    def service_spec(self) -> dict:
        from .transport import service_spec_of
        return {"kind": "corrupt_timing",
                "inner": service_spec_of(self.inner), "seed": self.seed,
                "corrupt_rate": self.corrupt_rate, "factor": self.factor}

    def __getattr__(self, name):
        return getattr(self.inner, name)


#: Source marker that makes ``PoisonService`` kill its worker.
POISON_MARKER = "POISON"


class PoisonService:
    """Wrap an ``EvaluationService`` and hard-kill the worker process when
    the submitted source contains :data:`POISON_MARKER` — a *deterministic*
    worker-killer, unlike ``CrashService``'s random one.  This models the
    poison-kernel class (infinite loop, device wedge, segfault) that dies
    *every* time it runs: without ``core.integrity.Quarantine`` the
    evolutionary loop burns ``max_requeues`` worker deaths on every
    rediscovery of the same genome.  Subprocess workers only — in-process
    it would take the test runner down, which is the point of the marker
    check living behind the transport boundary."""

    def __init__(self, inner, marker: str = POISON_MARKER):
        self.inner = inner
        self.marker = marker

    def submit(self, source: str):
        if self.marker in source:
            os._exit(23)          # hard worker death: the kernel wedged it
        return self.inner.submit(source)

    def clone(self) -> "PoisonService":
        return PoisonService(self.inner.clone(), marker=self.marker)

    def service_spec(self) -> dict:
        from .transport import service_spec_of
        return {"kind": "poison", "inner": service_spec_of(self.inner),
                "marker": self.marker}

    def __getattr__(self, name):
        return getattr(self.inner, name)


class DriftService:
    """Wrap an ``EvaluationService`` and let incarnation 0 *drift*: after
    ``drift_after`` submissions, every ``ok`` verdict's timings are scaled
    by ``drift_factor`` — the slow measurement skew of an overheating or
    contended device, invisible to per-verdict checks because it biases
    *every* verdict consistently.  ``core.integrity``'s canary sentinel is
    the detector: its known-timing kernel shifts with the drift.  A
    respawned worker (stepped incarnation) measures clean again, modelling
    a device reset; ``respawn()`` lets the in-process transport step the
    incarnation without a process boundary."""

    def __init__(self, inner, drift_after: int = 0, drift_factor: float = 1.5,
                 incarnation: int = 0):
        if drift_factor <= 0:
            raise ValueError("drift_factor must be positive")
        self.inner = inner
        self.drift_after = drift_after
        self.drift_factor = drift_factor
        self.incarnation = incarnation
        self.calls = 0

    def _drifting(self) -> bool:
        return (self.incarnation == 0 and self.drift_after > 0
                and self.calls > self.drift_after)

    def submit(self, source: str):
        self.calls += 1
        res = self.inner.submit(source)
        if self._drifting() and res.status == "ok" and res.timings_us:
            timings = {k: v * self.drift_factor
                       for k, v in res.timings_us.items()}
            return type(res)(res.status, res.error, timings)
        return res

    def respawn(self) -> None:
        """Device reset: the replacement worker measures clean."""
        self.incarnation += 1
        self.calls = 0

    def clone(self) -> "DriftService":
        return DriftService(self.inner.clone(), drift_after=self.drift_after,
                            drift_factor=self.drift_factor,
                            incarnation=self.incarnation)

    def service_spec(self) -> dict:
        from .transport import service_spec_of
        return {"kind": "drift", "inner": service_spec_of(self.inner),
                "drift_after": self.drift_after,
                "drift_factor": self.drift_factor}

    def state_dict(self) -> dict:
        inner = getattr(self.inner, "state_dict", None)
        return {"calls": self.calls, "incarnation": self.incarnation,
                "inner": inner() if inner else None}

    def load_state_dict(self, d: dict) -> None:
        self.calls = d["calls"]
        self.incarnation = d.get("incarnation", 0)
        if d.get("inner") is not None:
            self.inner.load_state_dict(d["inner"])

    def __getattr__(self, name):
        return getattr(self.inner, name)
