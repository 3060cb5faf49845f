"""Worker transports for the evaluation pool (paper §3.4, distributed).

Port of ``repro.core.transport``.  ``core.evalpool.EvalPool`` routes
queued submissions to N sequential-only evaluation workers.  *How* a
worker executes a submission is this module's concern — the
``WorkerTransport`` abstraction — so the pool's queueing, caching, and
determinism logic is identical whether the workers are threads in this
process or separate Python processes:

* ``InProcessTransport`` — each worker is an ``EvaluationService`` object
  called directly from the pool's worker thread.  Zero overhead, but the
  campaign shares its process, and on the card its CUDA context, with
  every submitted kernel: one kernel that faults (an illegal address, a
  trap) leaves the context unusable for every later launch, so the
  service then refuses to go on (``evaluator.PoisonedContextError``).

* ``SubprocessTransport`` — each worker is a ``python -m
  repro_torch.core.eval_worker`` child process that rebuilds its service
  from a JSON *service spec* (see :mod:`repro_torch.core.eval_worker`) and
  speaks the wire protocol below over stdin/stdout.  A worker that
  crashes mid-benchmark takes down only itself: the transport detects the
  death, raises :class:`WorkerDiedError`, and the pool requeues the
  in-flight job.  A worker whose CUDA context a submitted kernel poisoned
  sends that submission's verdict and exits; the next job respawns it.
  Every LLM-written kernel on the card should be evaluated this way.

Wire protocol — length-prefixed JSONL frames
--------------------------------------------
Each frame is one JSON object encoded as UTF-8, prefixed by its byte length
in ASCII decimal plus ``\\n``, and followed by ``\\n``::

    23\\n{"frame":"heartbeat"}\\n

Parent -> child frames:
  ``init``      first frame: ``{spec, incarnation, policy, heartbeat_interval_s}``
  ``submit``    ``{job_id, source}`` — evaluate one kernel source
  ``shutdown``  drain and exit cleanly

Child -> parent frames:
  ``hello``     child is up, service built: ``{pid}``
  ``heartbeat`` emitted every ``heartbeat_interval_s`` from a side thread,
                including *during* a long evaluation — proof of process
                liveness, not of job progress
  ``result``    ``{job_id, status, error, timings_us}`` — a platform
                verdict, plus ``launches`` (the kernel launches the job
                made, by wrapper counter, when it made any) and ``exit``
                (why the child leaves after this verdict: its CUDA context
                is unusable)
  ``error``     ``{job_id, error}`` — the child's retries were exhausted

Liveness (load-bearing for multi-day campaigns):
  * **Death** — the child's stdout hits EOF or the process exits: detected
    within one poll interval.
  * **Stall** — no frame (heartbeat or otherwise) for ``deadline_s``: the
    process is wedged (e.g. SIGSTOP, runaway native code holding the GIL);
    it is killed and declared dead.
  * **Job deadline** — optional ``job_timeout_s``: a single evaluation that
    exceeds it is treated as a stall even if heartbeats keep arriving.  A
    kernel that never returns hangs the card's stream, not the child's
    heartbeat thread, so only this deadline catches it; killing the
    process frees the card.

All three surface as :class:`WorkerDiedError`; the pool's response —
requeue the job, respawn the worker lazily with a stepped *incarnation*
(folded into fault-injection seeds so a deterministic crash draw cannot
repeat forever) — keeps the campaign trajectory identical to a run without
deaths, because every ``EvalResult`` is a pure function of
``(platform seed, source, config)`` (the content-keyed jitter invariant).
A worker that exits between jobs (after an ``exit`` verdict, or for any
other reason) is respawned with a stepped incarnation too.  On the card
the times are measured, so that purity holds for the statuses; the
population identity across transports holds only on the CPU.
"""
from __future__ import annotations

import copy
import itertools
import json
import os
import pathlib
import subprocess
import sys
import threading
import time
from collections import Counter
from typing import Optional

from .evaluator import EvalResult

#: Numeric RetryPolicy fields forwarded to subprocess workers (exception
#: type tuples are not serializable; the child uses the defaults).
POLICY_WIRE_FIELDS = ("max_attempts", "base_delay_s", "multiplier",
                      "max_delay_s", "jitter", "timeout_s", "seed")


class WorkerDiedError(RuntimeError):
    """The worker executing a job died or stalled past its deadline.

    Deliberately *not* a ``resilience.TransientError``: the submission's
    fate is unknown (the platform may or may not have started it), so the
    correct response is the pool's — requeue the job for any live worker —
    not an in-place blind retry on a dead route."""


class RemoteEvalError(RuntimeError):
    """A subprocess worker reported that its own retries were exhausted.

    Mirrors the in-process outcome where ``retry_call`` around
    ``service.submit`` gives up: the pool marks the submission ``failed``.
    Not retryable by the parent — the child already spent the attempt
    budget."""


# ---------------------------------------------------------------------------
# Wire protocol
# ---------------------------------------------------------------------------
def write_frame(stream, obj: dict) -> None:
    """Write one length-prefixed JSONL frame and flush."""
    data = json.dumps(obj, separators=(",", ":")).encode()
    stream.write(b"%d\n" % len(data) + data + b"\n")
    stream.flush()


def read_frame(stream) -> Optional[dict]:
    """Read one frame; ``None`` on clean EOF; ``ValueError`` on a torn or
    corrupt frame (half-written length line or truncated payload)."""
    line = stream.readline()
    if line == b"":
        return None
    try:
        n = int(line)
    except ValueError:
        raise ValueError(f"corrupt frame length {line!r}")
    payload = stream.read(n)
    if len(payload) != n:
        raise ValueError(f"truncated frame: expected {n} bytes, "
                         f"got {len(payload)}")
    stream.read(1)  # trailing newline
    try:
        return json.loads(payload)
    except json.JSONDecodeError as e:
        raise ValueError(f"corrupt frame payload: {e}")


def policy_wire_dict(policy) -> dict:
    """The serializable subset of a RetryPolicy, for the init frame."""
    return {f: getattr(policy, f) for f in POLICY_WIRE_FIELDS}


def service_spec_of(service) -> dict:
    """The JSON service spec of ``service`` (see eval_worker.build_service).

    Raises ``TypeError`` for services that cannot describe themselves —
    those can only run on the in-process transport."""
    fn = getattr(service, "service_spec", None)
    if fn is None:
        raise TypeError(
            f"{type(service).__name__} has no service_spec(); it cannot be "
            f"rebuilt inside a subprocess worker — use transport='inprocess' "
            f"or add a service_spec() method")
    return fn()


# ---------------------------------------------------------------------------
# Transports
# ---------------------------------------------------------------------------
class WorkerTransport:
    """Executes one job at a time per worker index, on behalf of the pool.

    The pool guarantees ``run(idx, ...)`` is never called concurrently for
    the same ``idx`` (worker threads are bound 1:1 to indices).  ``emitter``
    is wired by the pool to its event log."""

    kind = "abstract"
    emitter = None   # callable(event, **fields), set by the owning pool

    @property
    def num_workers(self) -> int:
        raise NotImplementedError

    def run(self, idx: int, source: str) -> EvalResult:
        raise NotImplementedError

    def worker_states(self) -> list:
        raise NotImplementedError

    def load_worker_states(self, states: list) -> None:
        raise NotImplementedError

    def respawn(self, idx: int) -> None:
        """Force worker ``idx`` to be rebuilt (the drift response from
        ``core.integrity``: a replacement worker measures clean).  Base
        implementation only records the request — transports with a real
        worker boundary override it."""
        self._emit("worker_respawn", worker=idx, transport=self.kind,
                   effect="none")

    @property
    def submissions(self) -> int:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def _emit(self, event: str, **fields) -> None:
        if self.emitter is not None:
            self.emitter(event, **fields)


class InProcessTransport(WorkerTransport):
    """The original pool behaviour: workers are service objects called from
    the pool's own threads.  Exceptions propagate unchanged (the pool's
    retry policy sees ``TransientError`` / ``ServiceBusyError`` directly)."""

    kind = "inprocess"

    def __init__(self, services) -> None:
        self.services = list(services)
        if not self.services:
            raise ValueError("InProcessTransport needs at least one service")

    @property
    def num_workers(self) -> int:
        return len(self.services)

    def run(self, idx: int, source: str) -> EvalResult:
        return self.services[idx].submit(source)

    def worker_states(self) -> list:
        return [(s.state_dict() if hasattr(s, "state_dict") else None)
                for s in self.services]

    def load_worker_states(self, states: list) -> None:
        for svc, sd in zip(self.services, states):
            if sd is not None and hasattr(svc, "load_state_dict"):
                svc.load_state_dict(sd)

    def respawn(self, idx: int) -> None:
        """No process to kill in-process; delegate to the service when it
        models incarnations itself (e.g. ``DriftService.respawn``)."""
        svc_respawn = getattr(self.services[idx], "respawn", None)
        if svc_respawn is not None:
            svc_respawn()
        self._emit("worker_respawn", worker=idx, transport=self.kind,
                   effect="service" if svc_respawn is not None else "none")

    @property
    def submissions(self) -> int:
        return sum(getattr(s, "submissions", 0) for s in self.services)


class _Pending:
    __slots__ = ("event", "frame")

    def __init__(self):
        self.event = threading.Event()
        self.frame: Optional[dict] = None

    def resolve(self, frame: dict) -> None:
        self.frame = frame
        self.event.set()


class _WorkerProc:
    """One live child process plus its reader thread and liveness clock."""

    def __init__(self, proc, incarnation: int) -> None:
        self.proc = proc
        self.incarnation = incarnation
        self.pending: dict[int, _Pending] = {}
        self.last_seen = time.monotonic()
        self.hello = threading.Event()
        self.eof = False
        self._wlock = threading.Lock()

    def send(self, obj: dict) -> None:
        with self._wlock:
            write_frame(self.proc.stdin, obj)

    def reader(self) -> None:
        try:
            while True:
                frame = read_frame(self.proc.stdout)
                if frame is None:
                    break
                self.last_seen = time.monotonic()
                kind = frame.get("frame")
                if kind == "hello":
                    self.hello.set()
                elif kind in ("result", "error"):
                    pend = self.pending.pop(frame.get("job_id"), None)
                    if pend is not None:
                        pend.resolve(frame)
                # heartbeats only refresh last_seen
        except (ValueError, OSError):
            pass          # torn frame / closed pipe: treated as death below
        self.eof = True

    def kill(self) -> None:
        try:
            self.proc.kill()
        except OSError:
            pass
        try:
            self.proc.wait(timeout=5)
        except Exception:
            pass


class SubprocessTransport(WorkerTransport):
    """Each worker is a ``repro_torch.core.eval_worker`` child process.

    Workers spawn lazily on first use and respawn (with a stepped
    incarnation) after a death; in-flight jobs of a dead worker surface as
    ``WorkerDiedError`` for the pool to requeue.  Parent-side dispatch
    counters stand in for the children's ``submissions`` accounting in
    ``state_dict`` (children are disposable; verdicts are content-pure, so
    nothing a child accumulates affects the campaign trajectory)."""

    kind = "subprocess"

    def __init__(self, specs, policy=None,
                 heartbeat_interval_s: float = 0.5,
                 deadline_s: float = 15.0,
                 job_timeout_s: Optional[float] = None,
                 spawn_timeout_s: float = 60.0,
                 poll_interval_s: float = 0.05,
                 python: Optional[str] = None) -> None:
        specs = list(specs)
        if not specs:
            raise ValueError("SubprocessTransport needs at least one spec")
        self._specs = specs
        self._policy = policy
        self.heartbeat_interval_s = heartbeat_interval_s
        self.deadline_s = deadline_s
        self.job_timeout_s = job_timeout_s
        self.spawn_timeout_s = spawn_timeout_s
        self.poll_interval_s = poll_interval_s
        self._python = python or sys.executable
        self._workers: list[Optional[_WorkerProc]] = [None] * len(specs)
        self._incarnations = [0] * len(specs)
        self._dispatched = [0] * len(specs)
        self._job_ids = itertools.count(1)
        self._closed = False
        #: kernel launches the children reported with their verdicts, by
        #: wrapper counter (``kernels._build.LAUNCHES`` lives in each child)
        self.launches: Counter = Counter()

    @property
    def num_workers(self) -> int:
        return len(self._specs)

    # --------------------------------------------------------------- spawn
    def _child_env(self) -> dict:
        env = dict(os.environ)
        src = str(pathlib.Path(__file__).resolve().parents[2])
        existing = env.get("PYTHONPATH", "")
        if src not in existing.split(os.pathsep):
            env["PYTHONPATH"] = (src + os.pathsep + existing if existing
                                 else src)
        return env

    def _spawn(self, idx: int) -> _WorkerProc:
        incarnation = self._incarnations[idx]
        proc = subprocess.Popen(
            [self._python, "-m", "repro_torch.core.eval_worker"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            env=self._child_env())
        w = _WorkerProc(proc, incarnation)
        threading.Thread(target=w.reader, daemon=True,
                         name=f"evalworker-reader-{idx}").start()
        init = {"frame": "init", "worker": idx,
                "incarnation": incarnation,
                "spec": copy.deepcopy(self._specs[idx]),
                "heartbeat_interval_s": self.heartbeat_interval_s}
        if self._policy is not None:
            init["policy"] = policy_wire_dict(self._policy)
        try:
            w.send(init)
        except OSError:
            self._reap(idx, w, "died during init handshake")
        deadline = time.monotonic() + self.spawn_timeout_s
        while not w.hello.wait(self.poll_interval_s):
            if w.eof or proc.poll() is not None:
                self._reap(idx, w, "exited during startup")
            if time.monotonic() > deadline:
                self._reap(idx, w, "startup exceeded spawn_timeout_s")
        self._workers[idx] = w
        self._emit("worker_spawn", worker=idx, incarnation=incarnation,
                   pid=proc.pid, transport=self.kind)
        return w

    def _reap(self, idx: int, w: _WorkerProc, reason: str):
        """Kill + forget a worker and raise WorkerDiedError.  The next run()
        on this index respawns with a stepped incarnation."""
        w.kill()
        if self._workers[idx] is w:
            self._workers[idx] = None
        self._incarnations[idx] += 1
        self._emit("worker_died", worker=idx, incarnation=w.incarnation,
                   reason=reason, transport=self.kind)
        raise WorkerDiedError(f"worker {idx} (incarnation {w.incarnation}) "
                              f"{reason}")

    # ----------------------------------------------------------------- run
    def run(self, idx: int, source: str) -> EvalResult:
        if self._closed:
            raise RuntimeError("SubprocessTransport is closed")
        w = self._workers[idx]
        if w is not None and (w.eof or w.proc.poll() is not None):
            # exited between jobs: its replacement is a new incarnation
            w.kill()
            self._workers[idx] = None
            self._incarnations[idx] += 1
            self._emit("worker_exit", worker=idx, incarnation=w.incarnation,
                       reason="exited between jobs", transport=self.kind)
            w = None
        if w is None:
            w = self._spawn(idx)
        job_id = next(self._job_ids)
        pend = _Pending()
        w.pending[job_id] = pend
        self._dispatched[idx] += 1
        try:
            w.send({"frame": "submit", "job_id": job_id, "source": source})
        except OSError:
            self._reap(idx, w, "stdin closed (died before submit)")
        t0 = time.monotonic()
        while not pend.event.wait(self.poll_interval_s):
            if w.eof or w.proc.poll() is not None:
                self._reap(idx, w, "exited mid-evaluation")
            if time.monotonic() - w.last_seen > self.deadline_s:
                self._reap(idx, w, f"silent past the {self.deadline_s}s "
                                   f"heartbeat deadline")
            if (self.job_timeout_s is not None
                    and time.monotonic() - t0 > self.job_timeout_s):
                self._reap(idx, w, f"evaluation exceeded the "
                                   f"{self.job_timeout_s}s job deadline")
        frame = pend.frame
        if frame.get("frame") == "error":
            raise RemoteEvalError(frame.get("error", "unknown remote error"))
        self.launches.update(frame.get("launches", {}))
        if frame.get("exit"):
            self._retire(idx, w, frame["exit"])
        return EvalResult(frame["status"], frame.get("error", ""),
                          frame.get("timings_us", {}))

    def _retire(self, idx: int, w: _WorkerProc, reason: str) -> None:
        """The child said it leaves after this verdict (its CUDA context is
        unusable): let it exit, and respawn the slot as a new incarnation
        on the next job."""
        try:
            w.proc.wait(timeout=self.deadline_s)
        except subprocess.TimeoutExpired:
            pass
        w.kill()
        if self._workers[idx] is w:
            self._workers[idx] = None
        self._incarnations[idx] += 1
        self._emit("worker_exit", worker=idx, incarnation=w.incarnation,
                   reason=reason, transport=self.kind)

    def respawn(self, idx: int) -> None:
        """Kill worker ``idx`` and step its incarnation; the next ``run``
        on this index spawns the replacement lazily (same path a detected
        death takes, minus the in-flight job)."""
        w = self._workers[idx]
        if w is not None:
            w.kill()
            self._workers[idx] = None
            self._incarnations[idx] += 1
        self._emit("worker_respawn", worker=idx, transport=self.kind,
                   incarnation=self._incarnations[idx], effect="process")

    # ------------------------------------------------------------ accounting
    def worker_states(self) -> list:
        return [{"submissions": n} for n in self._dispatched]

    def load_worker_states(self, states: list) -> None:
        for idx, sd in enumerate(states[:len(self._dispatched)]):
            if sd is not None:
                self._dispatched[idx] = sd.get("submissions", 0)

    @property
    def submissions(self) -> int:
        return sum(self._dispatched)

    # --------------------------------------------------------------- close
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for idx, w in enumerate(self._workers):
            if w is None:
                continue
            try:
                w.send({"frame": "shutdown"})
                w.proc.wait(timeout=5)
                self._emit("worker_exit", worker=idx,
                           incarnation=w.incarnation, transport=self.kind)
            except Exception:
                w.kill()
            self._workers[idx] = None


def make_transport(transport, services, retry_policy=None, options=None
                   ) -> WorkerTransport:
    """Resolve the pool's ``transport=`` argument: an instance passes
    through; ``"inprocess"``/``"subprocess"`` construct one over
    ``services`` (subprocess via their JSON service specs)."""
    if isinstance(transport, WorkerTransport):
        return transport
    if transport in (None, "inprocess", "in-process", "thread"):
        return InProcessTransport(services)
    if transport == "subprocess":
        return SubprocessTransport(
            [service_spec_of(s) for s in services],
            policy=retry_policy, **(options or {}))
    raise ValueError(f"unknown transport {transport!r} "
                     f"(expected 'inprocess' or 'subprocess')")
