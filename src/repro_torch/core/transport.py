"""Worker transports for the evaluation pool (paper §3.4, distributed).

Port of ``repro.core.transport``, in-process transport only.
``core.evalpool.EvalPool`` routes queued submissions to N sequential-only
evaluation workers; *how* a worker executes a submission is this module's
concern — the ``WorkerTransport`` abstraction.

* ``InProcessTransport`` — each worker is an ``EvaluationService`` object
  called directly from the pool's worker thread.

The JAX package's ``SubprocessTransport`` (each worker a child process
speaking a length-prefixed JSONL wire protocol) and its eval worker are
not ported yet; ``transport="subprocess"`` raises ``ValueError``.
"""
from __future__ import annotations

from .evaluator import EvalResult


class WorkerDiedError(RuntimeError):
    """The worker executing a job died or stalled past its deadline.

    Deliberately *not* a ``resilience.TransientError``: the submission's
    fate is unknown (the platform may or may not have started it), so the
    correct response is the pool's — requeue the job for any live worker —
    not an in-place blind retry on a dead route."""


# ---------------------------------------------------------------------------
def service_spec_of(service) -> dict:
    """The JSON constructor spec of ``service`` (what a worker process
    would rebuild it from).

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
        raise ValueError(
            "transport='subprocess' is not ported yet: the port has no "
            "eval worker process; use transport='inprocess'")
    raise ValueError(f"unknown transport {transport!r} "
                     f"(expected 'inprocess' or 'subprocess')")
