"""Subprocess evaluation worker — ``python -m repro_torch.core.eval_worker``.

Port of ``repro.core.eval_worker``: the child half of
:class:`repro_torch.core.transport.SubprocessTransport`.  Reads
length-prefixed JSONL frames on stdin, writes frames on stdout:

1. receives the ``init`` frame, builds its ``EvaluationService`` (or a
   fault-injection wrapper stack) from the JSON *service spec*, replies
   ``hello``;
2. starts a heartbeat thread that emits a ``heartbeat`` frame every
   ``heartbeat_interval_s`` — including while an evaluation is running, so
   the parent can tell "slow benchmark" from "dead process";
3. loops: each ``submit`` frame is evaluated under the (numeric subset of
   the) parent's retry policy and answered with a ``result`` frame, or an
   ``error`` frame when the retries are exhausted;
4. exits on the ``shutdown`` frame, on stdin EOF, or after a verdict that
   left its CUDA context unusable (below).

Service specs
-------------
A spec is ``{"kind": ..., ...}``; wrapper kinds nest an ``"inner"`` spec.
Producers are the ``service_spec()`` methods on ``EvaluationService``
(its ``device`` included) and the fault-injection wrappers of
``core.resilience``; :func:`build_service` is the single consumer.  The
*incarnation* (how many times this worker slot has been respawned) is
folded into fault-injection seeds so a deterministic crash draw cannot
kill every respawn at the same call index forever.

Three extra kinds exist for protocol tests and transport diagnostics
without a card: ``echo`` (instant content-keyed verdicts), ``sleepy``
(stalls on matching sources for incarnation 0 — exercises the parent's
deadline/requeue path) and ``sticky`` (a matching source leaves the
service's context unusable, as a faulting kernel leaves the card's).

Behaviour that exists only on the card
--------------------------------------
* *Fault attribution.*  The service ends each submission with
  ``torch.cuda.synchronize()`` before its verdict is sent, so a fault that
  the card reports late lands on the source that caused it, not on the
  next one.
* *Poisoned context.*  An illegal address, a launch failure or a
  device-side trap is sticky: every later launch in that CUDA context
  fails.  After an execution error the service launches a trivial op and
  synchronises; if that fails, it sets ``context_lost``, and this worker
  sends the submission's verdict (with ``exit`` set) and then exits.  The
  transport respawns it on the next job with a stepped incarnation.
* *The verdict stays a pure function of the source.*  The bad source gets
  the verdict a fresh process gives it (``runtime_error``), and the next
  source runs in a clean context.
* *A kernel that never returns.*  The heartbeat thread keeps beating while
  the kernel hangs, so only the transport's ``job_timeout_s`` catches it;
  killing the process frees the card.

Each ``result`` frame also carries the kernel launches the job made
(``kernels._build.LAUNCHES``, counted in this process), so the parent can
show which kernels its verdicts came from.
"""
from __future__ import annotations

import collections
import hashlib
import os
import sys
import threading
import time

from ..kernels import _build
from . import resilience
from .evaluator import EvalResult
from .transport import POLICY_WIRE_FIELDS, read_frame, write_frame


class EchoService:
    """Instant deterministic verdicts keyed on the source content — the
    platform contract (content-pure results) without a card.  For
    wire-protocol and liveness tests only."""

    def __init__(self, latency_s: float = 0.0) -> None:
        self.latency_s = latency_s
        self.submissions = 0

    def submit(self, source: str) -> EvalResult:
        self.submissions += 1
        if self.latency_s:
            time.sleep(self.latency_s)
        digest = hashlib.sha256(source.encode()).hexdigest()
        return EvalResult("ok", timings_us={
            "len": float(len(source)),
            "sha16": float(int(digest[:4], 16))})

    def clone(self) -> "EchoService":
        return EchoService(latency_s=self.latency_s)

    def service_spec(self) -> dict:
        return {"kind": "echo", "latency_s": self.latency_s}


class SleepyService:
    """Stalls (sleeps ``sleep_s``) on sources containing ``match`` — but
    only at incarnation 0, so the respawned worker makes progress.  Drives
    the parent's stall-deadline detection in tests."""

    def __init__(self, inner, match: str = "STALL", sleep_s: float = 30.0,
                 incarnation: int = 0) -> None:
        self.inner = inner
        self.match = match
        self.sleep_s = sleep_s
        self.incarnation = incarnation

    def submit(self, source: str) -> EvalResult:
        if self.incarnation == 0 and self.match in source:
            time.sleep(self.sleep_s)
        return self.inner.submit(source)

    def clone(self) -> "SleepyService":
        return SleepyService(self.inner.clone(), match=self.match,
                             sleep_s=self.sleep_s,
                             incarnation=self.incarnation)

    def service_spec(self) -> dict:
        return {"kind": "sleepy", "inner": self.inner.service_spec(),
                "match": self.match, "sleep_s": self.sleep_s}

    def __getattr__(self, name):
        return getattr(self.inner, name)


class StickyService:
    """A source containing ``match`` behaves as a kernel that faults on
    the card: its verdict is ``runtime_error`` with the CUDA runtime's
    text for an illegal address, and the service's ``context_lost`` is set,
    as ``EvaluationService`` sets it when its context probe fails after
    such a fault.  Every other source goes to ``inner``.  Drives the
    worker's exit-after-verdict path without a card."""

    ERROR = ("RuntimeError during execution: CUDA error: an illegal memory "
             "access was encountered")

    def __init__(self, inner, match: str = "FAULT") -> None:
        self.inner = inner
        self.match = match
        self.context_lost = None

    def submit(self, source: str) -> EvalResult:
        if self.match in source:
            self.context_lost = self.ERROR
            return EvalResult("runtime_error", self.ERROR)
        return self.inner.submit(source)

    def clone(self) -> "StickyService":
        return StickyService(self.inner.clone(), match=self.match)

    def service_spec(self) -> dict:
        return {"kind": "sticky", "inner": self.inner.service_spec(),
                "match": self.match}

    def __getattr__(self, name):
        return getattr(self.inner, name)


def build_service(spec: dict, incarnation: int = 0):
    """Rebuild a service (stack) from its JSON spec inside the worker."""
    kind = spec.get("kind")
    if kind == "evaluation":
        from .evaluator import EvaluationService
        kwargs = {k: spec[k] for k in
                  ("device", "noise", "seed", "rtol", "latency_s")
                  if k in spec}
        if "bench_configs" in spec:
            kwargs["bench_configs"] = tuple(
                tuple(c) for c in spec["bench_configs"])
        if "correctness_config" in spec:
            kwargs["correctness_config"] = tuple(spec["correctness_config"])
        return EvaluationService(**kwargs)
    if kind == "flaky":
        return resilience.FlakyService(
            build_service(spec["inner"], incarnation),
            seed=spec.get("seed", 0),
            error_rate=spec.get("error_rate", 0.1),
            timeout_rate=spec.get("timeout_rate", 0.0))
    if kind == "crash":
        return resilience.CrashService(
            build_service(spec["inner"], incarnation),
            seed=spec.get("seed", 0),
            crash_rate=spec.get("crash_rate", 0.1),
            incarnation=incarnation)
    if kind == "corrupt_timing":
        return resilience.CorruptTimingService(
            build_service(spec["inner"], incarnation),
            seed=spec.get("seed", 0),
            corrupt_rate=spec.get("corrupt_rate", 0.1),
            factor=spec.get("factor", 5.0))
    if kind == "poison":
        return resilience.PoisonService(
            build_service(spec["inner"], incarnation),
            marker=spec.get("marker", resilience.POISON_MARKER))
    if kind == "drift":
        return resilience.DriftService(
            build_service(spec["inner"], incarnation),
            drift_after=spec.get("drift_after", 0),
            drift_factor=spec.get("drift_factor", 1.5),
            incarnation=incarnation)
    if kind == "echo":
        return EchoService(latency_s=spec.get("latency_s", 0.0))
    if kind == "sleepy":
        return SleepyService(
            build_service(spec["inner"], incarnation),
            match=spec.get("match", "STALL"),
            sleep_s=spec.get("sleep_s", 30.0),
            incarnation=incarnation)
    if kind == "sticky":
        return StickyService(build_service(spec["inner"], incarnation),
                             match=spec.get("match", "FAULT"))
    raise ValueError(f"unknown service spec kind {kind!r}")


def _policy_from(d) -> resilience.RetryPolicy:
    if not d:
        return resilience.DEFAULT_POLICY
    return resilience.RetryPolicy(
        **{k: v for k, v in d.items() if k in POLICY_WIRE_FIELDS})


def serve(stdin, stdout):
    """Frame loop over binary streams (factored out for in-process tests).
    Returns why the service's context was lost, if that ended the loop."""
    init = read_frame(stdin)
    if not init or init.get("frame") != "init":
        raise SystemExit("eval_worker: expected an init frame first")
    incarnation = init.get("incarnation", 0)
    service = build_service(init["spec"], incarnation=incarnation)
    policy = _policy_from(init.get("policy"))

    wlock = threading.Lock()

    def send(obj: dict) -> None:
        with wlock:
            write_frame(stdout, obj)

    send({"frame": "hello", "pid": os.getpid(),
          "worker": init.get("worker"), "incarnation": incarnation})

    stop = threading.Event()
    interval = init.get("heartbeat_interval_s", 0.5)

    def beat() -> None:
        while not stop.wait(interval):
            try:
                send({"frame": "heartbeat"})
            except (OSError, ValueError):
                os._exit(0)       # parent went away; nothing left to serve

    threading.Thread(target=beat, daemon=True).start()

    while True:
        frame = read_frame(stdin)
        if frame is None or frame.get("frame") == "shutdown":
            break
        if frame.get("frame") != "submit":
            continue
        job_id = frame.get("job_id")
        before = collections.Counter(_build.LAUNCHES)
        try:
            res = resilience.retry_call(
                lambda: service.submit(frame["source"]), policy=policy)
        except Exception as e:
            send({"frame": "error", "job_id": job_id,
                  "error": f"{type(e).__name__}: {e}"})
            continue
        out = {"frame": "result", "job_id": job_id, "status": res.status,
               "error": res.error, "timings_us": res.timings_us}
        launches = collections.Counter(_build.LAUNCHES)
        launches.subtract(before)
        if +launches:
            out["launches"] = dict(+launches)
        # the service's context can take no more work: this verdict is the
        # last this process gives, and the next job runs in a fresh one
        lost = getattr(service, "context_lost", None)
        if lost:
            out["exit"] = f"CUDA context unusable: {lost}"
        send(out)
        if lost:
            stop.set()
            return lost
    stop.set()
    return None


def main() -> None:
    if serve(sys.stdin.buffer, sys.stdout.buffer):
        # no teardown in a poisoned CUDA context: freeing its memory would
        # only raise the same fault again
        os._exit(0)


if __name__ == "__main__":
    main()
