"""Distributed evaluation subsystem: the ``EvalBackend`` API, the pooled
scheduler, worker transports, and the content-addressed eval cache (§3.4).

Port of ``repro.core.evalpool`` (framework-free; copied with its imports
pointing at this package).

The paper's campaigns were wall-clock-bound by the external evaluation
queue: one submission in flight at a time, variable service delays, no
memory of what the platform had already timed — and, over multi-day runs,
workers that die mid-benchmark.  This module is the eval-throughput
authority that removes those bottlenecks behind one small API.

``EvalBackend`` protocol
------------------------
Everything the scientist needs from an evaluation backend, and nothing
more: ``submit_async`` / ``probe`` / ``stats`` / ``state_dict`` /
``load_state_dict`` / ``close``.  ``EvalPool`` is the reference
implementation; anything satisfying the protocol (a remote queue client, a
recorded-fixture backend) plugs into ``KernelScientist(backend=...)``
unchanged.

``EvalPool`` — N sequential-only workers behind one priority queue
------------------------------------------------------------------
Each worker still processes submissions strictly sequentially (the "good
citizen" rule of §3.4 — a busy service raises ``ServiceBusyError``); the
pool is what scales, by routing queued submissions to whichever worker is
free.  Three priority tiers: ``PRIORITY_URGENT`` (jump the queue — e.g. a
re-evaluation the drain is blocked on) < ``PRIORITY_CAMPAIGN`` (generation
submissions) < ``PRIORITY_PROBE`` (idle-time autotune/benchmark probes).
``pause()`` stops workers from starting *new* jobs (in-flight evaluations
finish; the queue keeps accepting); ``resume()`` continues.

Transport matrix (see ``core.transport``)
-----------------------------------------
=============  =====================  ======================================
transport      worker                 failure domain
=============  =====================  ======================================
``inprocess``  service object called  none: a crash in any evaluation kills
               from a pool thread     the campaign process
``subprocess`` ``eval_worker`` child  one worker: death/stall is detected
               process, JSONL wire    (heartbeat + deadlines), the in-flight
               protocol               job is requeued at its original
                                      priority, the worker respawns lazily
                                      with a stepped incarnation
=============  =====================  ======================================

``EvalCache`` — content-addressed verdict store
-----------------------------------------------
Keyed by ``sha256(source)``, in front of the pool: duplicate submissions —
identical fallback kernels, resubmissions after a resume, repeated genomes
— return the persisted ``EvalResult`` without consuming a platform slot.
With ``max_entries`` set it is a size-capped LRU: ``get`` refreshes
recency, overflow evicts the least recently used, and the append-only
``eval_cache.jsonl`` is compacted (atomic rewrite of live entries) once
dead lines outnumber the cap.  Hits/misses/evictions stream to
``events.jsonl``.

Cross-transport determinism contract (load-bearing)
---------------------------------------------------
1. **Cache key = jitter key = sha256(source).**  Benchmark jitter keys on
   the submission's content address, never on submission order: an
   ``EvalResult`` is a pure function of (platform seed, source, config).
   This single invariant is what makes verdicts cacheable, makes
   ``workers=N`` population-identical to ``workers=1``, and makes a
   subprocess campaign with worker kills population-identical to an
   uninterrupted in-process run — a requeued job re-evaluates to the same
   verdict wherever and whenever it lands.
2. **Workers clone the platform seed.**  ``EvalPool.of`` builds extra
   workers with ``service.clone()`` (same timing seed; fault-injection
   wrappers step their *fault* seed instead), and ``SubprocessTransport``
   rebuilds children from ``service_spec()`` with the same seeds, so
   worker assignment and respawns never change timings.
3. **Results are applied in record-id order.**  The pool completes jobs in
   any order; the scientist's drain applies them sorted by record id and
   persists pending/completed state after every application, so
   kill-and-resume stays trajectory-identical across transports.
4. **Integrity re-measurement rides the same invariants.**  A quorum
   re-measure sample (``core.integrity.TimingAuditor.salted``) is the same
   kernel plus a trailing comment: the genome — and therefore the platform
   timing model — is unchanged, but the content address differs, so each
   sample is an independent *deterministic* jitter draw that caches like
   any other submission (a campaign killed mid-quorum replays completed
   samples as cache hits).  Canary sentinels go the other way: one constant
   source, so its verdict is constant on a healthy worker — which is why
   ``run_direct`` must bypass both the queue (the canary targets a
   *specific* worker) and the cache (a cached verdict would mask drift).
   Canary measurements never enter the cache and never consume a campaign
   submission slot in the drain.

Only platform *verdicts* are cached (ok / compile_error / runtime_error /
incorrect); submissions that failed at the queue level ("failed"), gave up
after repeated worker deaths ("worker_error"), or were quarantine-blocked
("quarantined") never produced a platform verdict and are never cached —
lifting a quarantine or raising ``max_requeues`` re-evaluates them fresh.
"""
from __future__ import annotations

import collections
import hashlib
import itertools
import json
import pathlib
import queue
import threading
import time
from typing import Optional, Protocol, runtime_checkable

from . import resilience
from .evaluator import EvalResult
from .transport import WorkerDiedError, WorkerTransport, make_transport

#: Queue priorities (lower value = served first).
PRIORITY_URGENT = -10            # jump the queue: drain-blocking work
PRIORITY_CAMPAIGN = 0            # generation submissions
PRIORITY_PROBE = 10              # idle-time autotune/benchmark probes
_PRIORITY_SHUTDOWN = 10 ** 9     # sentinels drain after all real work


@runtime_checkable
class EvalBackend(Protocol):
    """What ``KernelScientist`` requires of an evaluation backend.

    ``EvalPool`` implements it; so can a remote evaluation-queue client or
    a test double.  The contract: ``submit_async`` returns an
    :class:`EvalHandle`-like future immediately; ``probe`` is the
    low-priority lane; ``state_dict``/``load_state_dict`` carry whatever
    must survive a campaign restart; ``close`` quiesces workers."""

    def submit_async(self, source: str, priority: int = PRIORITY_CAMPAIGN,
                     tag=None) -> "EvalHandle": ...
    def probe(self, source: str, tag=None) -> "EvalHandle": ...
    def stats(self) -> dict: ...
    def state_dict(self) -> dict: ...
    def load_state_dict(self, d) -> None: ...
    def close(self, wait: bool = True) -> None: ...


class EvalCache:
    """Content-addressed ``EvalResult`` store keyed by ``sha256(source)``.

    In-memory by default; given a path, every ``put`` appends one JSONL
    line so a resumed campaign reloads all previously-computed verdicts
    (torn tail lines from a crash mid-append are skipped; later lines win
    over earlier ones for the same key).

    With ``max_entries`` set the cache is a bounded LRU: ``get`` refreshes
    an entry's recency, inserting past the cap evicts the least recently
    used entry, and the JSONL file is compacted in place (atomic tmp +
    rename of the live entries, in recency order) whenever evicted/dead
    lines outnumber ``max_entries`` — so a month-long campaign's cache file
    stays O(max_entries), not O(submissions)."""

    def __init__(self, path=None, max_entries: Optional[int] = None) -> None:
        if max_entries is not None and max_entries < 1:
            raise ValueError("max_entries must be >= 1 (or None)")
        self.path = pathlib.Path(path) if path else None
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.compactions = 0
        self._lines = 0           # JSONL lines currently in the file
        self._entries: collections.OrderedDict[str, EvalResult] = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        if self.path and self.path.exists():
            for line in self.path.read_text().splitlines():
                line = line.strip()
                if not line:
                    continue
                try:
                    d = json.loads(line)
                    if d.get("invalidated"):
                        # tombstone (drift invalidation): later lines win,
                        # so drop whatever an earlier line established
                        self._lines += 1
                        self._entries.pop(d["key"], None)
                        continue
                    res = EvalResult(d["status"], d.get("error", ""),
                                     d.get("timings_us", {}))
                except (json.JSONDecodeError, KeyError):
                    continue
                self._lines += 1
                self._entries[d["key"]] = res
                self._entries.move_to_end(d["key"])
            # reload trims to the cap by file order (append order ~ recency)
            if self.max_entries is not None:
                while len(self._entries) > self.max_entries:
                    self._entries.popitem(last=False)
        elif self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)

    @staticmethod
    def key_of(source: str) -> str:
        return hashlib.sha256(source.encode()).hexdigest()

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: str) -> Optional[EvalResult]:
        """Lookup with hit/miss accounting (one call per submission); a hit
        refreshes the entry's LRU recency."""
        with self._lock:
            res = self._entries.get(key)
            if res is None:
                self.misses += 1
            else:
                self.hits += 1
                self._entries.move_to_end(key)
            return res

    def put(self, key: str, result: EvalResult) -> None:
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return
            self._entries[key] = result
            if self.path:
                with open(self.path, "a") as f:
                    f.write(self._line(key, result))
                self._lines += 1
            if self.max_entries is not None:
                while len(self._entries) > self.max_entries:
                    self._entries.popitem(last=False)
                    self.evictions += 1
                if (self.path
                        and self._lines - len(self._entries)
                        > self.max_entries):
                    self._compact()

    @staticmethod
    def _line(key: str, result: EvalResult) -> str:
        return json.dumps({"key": key, "status": result.status,
                           "error": result.error,
                           "timings_us": result.timings_us}) + "\n"

    def _compact(self) -> None:
        """Rewrite the JSONL file to just the live entries (LRU order, so a
        reload reconstructs recency).  Atomic: tmp + rename.  Caller holds
        the lock."""
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text("".join(self._line(k, r)
                               for k, r in self._entries.items()))
        tmp.replace(self.path)
        self._lines = len(self._entries)
        self.compactions += 1

    def invalidate(self, key: str) -> bool:
        """Drop ``key``'s verdict — it was measured by a worker later found
        to be drifting, so it can no longer be trusted.  Persisted as an
        appended tombstone line (later lines win on reload); compaction
        clears tombstones.  Returns whether the key was present."""
        with self._lock:
            present = self._entries.pop(key, None) is not None
            if self.path:
                with open(self.path, "a") as f:
                    f.write(json.dumps({"key": key, "invalidated": True})
                            + "\n")
                self._lines += 1
            return present

    def compact(self) -> None:
        """Force a compaction (e.g. at campaign end)."""
        with self._lock:
            if self.path:
                self._compact()

    def stats(self) -> dict:
        d = {"entries": len(self._entries), "hits": self.hits,
             "misses": self.misses}
        if self.max_entries is not None:
            d.update(max_entries=self.max_entries,
                     evictions=self.evictions,
                     compactions=self.compactions)
        return d


class EvalHandle:
    """Future for one pooled submission.

    ``result()`` blocks until the evaluation completes and returns the
    ``EvalResult`` — or re-raises whatever the worker raised (including
    ``BaseException`` such as ``KeyboardInterrupt``, so a killed campaign
    still unwinds through the drain loop).  ``requeues`` counts how many
    times the job was re-enqueued after a worker *death*; ``busy_reroutes``
    counts re-enqueues because every retry found the worker occupied —
    deliberately separate counters, because a saturated-but-healthy pool
    must never exhaust a job's death budget."""

    def __init__(self, key: str, tag=None) -> None:
        self.key = key
        self.tag = tag            # caller metadata (record id) for events
        self.cached = False
        self.worker: Optional[int] = None
        self.duration_s = 0.0
        self.requeues = 0
        self.busy_reroutes = 0
        self._event = threading.Event()
        self._result: Optional[EvalResult] = None
        self._exc: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> EvalResult:
        if not self._event.wait(timeout):
            raise TimeoutError(f"evaluation of {self.key[:12]} still running")
        if self._exc is not None:
            raise self._exc
        return self._result

    def _finish(self, result=None, exc=None) -> None:
        self._result, self._exc = result, exc
        self._event.set()


class EvalPool:
    """N sequential-only evaluation workers behind one priority queue —
    the reference :class:`EvalBackend`.

    Worker threads are bound 1:1 to transport worker indices, spawn on
    demand, and exit after a short idle period (no resource leak across
    many short-lived pools).  A submission whose service turns out busy
    raises ``ServiceBusyError``, retried with zero backoff; a submission
    whose *worker dies* (subprocess transport) is requeued at its original
    priority — up to ``max_requeues`` times — and the worker respawns."""

    def __init__(self, services=None, cache: Optional[EvalCache] = None,
                 retry_policy: Optional[resilience.RetryPolicy] = None,
                 events=None, sleep=time.sleep,
                 idle_timeout_s: float = 0.5,
                 transport="inprocess",
                 transport_options: Optional[dict] = None,
                 max_requeues: int = 32,
                 max_busy_reroutes: int = 1000,
                 quarantine=None) -> None:
        services = list(services) if services is not None else []
        if not services and not isinstance(transport, WorkerTransport):
            raise ValueError("EvalPool needs at least one service "
                             "(or a constructed transport)")
        self.services = services
        self.cache = cache
        self.retry_policy = retry_policy or resilience.DEFAULT_POLICY
        self.events = events
        self._sleep = sleep
        self._idle_s = idle_timeout_s
        self.max_requeues = max_requeues
        self.max_busy_reroutes = max_busy_reroutes
        #: Optional ``core.integrity.Quarantine``: worker deaths feed it,
        #: quarantined content hashes short-circuit at submit time.
        self.quarantine = quarantine
        self.transport = make_transport(transport, services,
                                        retry_policy=self.retry_policy,
                                        options=transport_options)
        self.transport.emitter = self._emit
        self._queue: queue.PriorityQueue = queue.PriorityQueue()
        self._threads: dict[int, threading.Thread] = {}
        # one lock per worker index: serializes run_direct (canaries /
        # respawns target a *specific* worker) against that worker's thread
        self._worker_locks: dict[int, threading.Lock] = {}
        self._lock = threading.Lock()
        self._seq = itertools.count()
        self._closed = False
        self._unpaused = threading.Event()
        self._unpaused.set()

    # ----------------------------------------------------------- construct
    @classmethod
    def of(cls, service, workers: int = 1, **kwargs) -> "EvalPool":
        """Pool ``service`` plus ``workers - 1`` clones of it.

        Cloning is chained (each worker clones the previous one) so
        wrappers that step per-clone state — e.g. ``FlakyService`` fault
        seeds — give every worker an independent stream."""
        if workers < 1:
            raise ValueError("workers must be >= 1")
        svcs = [service]
        while len(svcs) < workers:
            clone = getattr(svcs[-1], "clone", None)
            if clone is None:
                raise TypeError(
                    f"{type(svcs[-1]).__name__} has no clone(); pass the "
                    f"worker services explicitly: EvalPool(services=[...])")
            svcs.append(clone())
        return cls(svcs, **kwargs)

    # ----------------------------------------------------------------- api
    def submit_async(self, source: str, priority: int = PRIORITY_CAMPAIGN,
                     tag=None) -> EvalHandle:
        """Enqueue one submission; returns immediately with its handle.

        A quarantined content hash never reaches a worker: its handle
        resolves instantly to a ``quarantined`` verdict (uncached, so
        lifting the quarantine re-evaluates it fresh)."""
        if self._closed:
            raise RuntimeError("EvalPool is closed")
        handle = EvalHandle(EvalCache.key_of(source), tag=tag)
        if self.quarantine is not None:
            reason = self.quarantine.blocked(handle.key)
            if reason is not None:
                self._emit("quarantine_block", key=handle.key[:12],
                           tag=handle.tag, reason=reason)
                handle._finish(result=EvalResult(
                    "quarantined", f"quarantined kernel: {reason}"))
                return handle
        self._queue.put((priority, next(self._seq), source, handle))
        self._ensure_workers()
        return handle

    def submit(self, source: str, **kwargs) -> EvalResult:
        """Blocking convenience wrapper (drop-in for a bare service)."""
        return self.submit_async(source, **kwargs).result()

    def probe(self, source: str, tag=None) -> EvalHandle:
        """Low-priority idle-time work (autotune/benchmark probes): only
        reaches a worker when no campaign submission is queued."""
        return self.submit_async(source, priority=PRIORITY_PROBE, tag=tag)

    def urgent(self, source: str, tag=None) -> EvalHandle:
        """Queue-jumping tier for drain-blocking work (e.g. re-evaluating
        the one kernel the scientist cannot advance without)."""
        return self.submit_async(source, priority=PRIORITY_URGENT, tag=tag)

    def run_direct(self, idx: int, source: str) -> EvalResult:
        """Run ``source`` on worker ``idx`` *now*, synchronously — bypassing
        both the queue and the cache.  This is the canary lane: drift
        detection needs the measurement to come from one specific worker
        (the queue routes to whoever is free) and to be freshly measured (a
        cache hit would mask drift).  Serialized against the worker's own
        thread via its per-index lock; blocks while that worker finishes
        its in-flight job.  Raises whatever the transport raises
        (``WorkerDiedError`` included) — callers classify failures."""
        if not 0 <= idx < self.transport.num_workers:
            raise ValueError(f"no worker {idx}")
        with self._lock_for(idx):
            return resilience.retry_call(
                lambda: self.transport.run(idx, source),
                policy=self.retry_policy, sleep=self._sleep)

    def respawn_worker(self, idx: int) -> None:
        """Force worker ``idx`` to be rebuilt (stepped incarnation) — the
        drift response: a replacement worker measures clean.  Serialized
        against the worker's in-flight job."""
        with self._lock_for(idx):
            self.transport.respawn(idx)

    # -------------------------------------------------------- pause/resume
    def pause(self) -> None:
        """Stop workers from *starting* new jobs.  In-flight evaluations
        finish; the queue keeps accepting submissions; ``close()`` on a
        paused pool unpauses it so queued work drains."""
        if self._unpaused.is_set():
            self._unpaused.clear()
            self._emit("pool_pause", queued=self._queue.qsize())

    def resume(self) -> None:
        if not self._unpaused.is_set():
            self._unpaused.set()
            self._emit("pool_resume", queued=self._queue.qsize())
            self._ensure_workers()

    @property
    def paused(self) -> bool:
        return not self._unpaused.is_set()

    # ---------------------------------------------------------- accounting
    @property
    def submissions(self) -> int:
        """Total platform slots consumed across all workers."""
        return self.transport.submissions

    def stats(self) -> dict:
        d = {"workers": self.transport.num_workers,
             "submissions": self.submissions,
             "transport": self.transport.kind,
             "paused": self.paused}
        if self.cache is not None:
            d.update({f"cache_{k}": v for k, v in self.cache.stats().items()})
        return d

    def close(self, wait: bool = True) -> None:
        """Stop accepting work; sentinels drain after already-queued jobs.
        A paused pool is unpaused first so nothing queued is stranded."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            threads = list(self._threads.values())
        self._unpaused.set()
        for _ in threads:
            self._queue.put((_PRIORITY_SHUTDOWN, next(self._seq), None, None))
        if wait:
            for t in threads:
                t.join()
        self.transport.close()

    def __enter__(self) -> "EvalPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------- resumable campaigns
    def state_dict(self) -> dict:
        return {"workers": self.transport.worker_states()}

    def load_state_dict(self, d) -> None:
        if not d:
            return
        # pre-pool state.json persisted one bare service's state dict
        worker_states = d["workers"] if "workers" in d else [d]
        self.transport.load_worker_states(worker_states)

    # ------------------------------------------------------------ internals
    def _emit(self, event: str, **fields) -> None:
        if self.events is not None:
            self.events.emit(event, **fields)

    def _lock_for(self, idx: int) -> threading.Lock:
        with self._lock:
            lock = self._worker_locks.get(idx)
            if lock is None:
                lock = self._worker_locks[idx] = threading.Lock()
            return lock

    def _ensure_workers(self) -> None:
        with self._lock:
            if self._closed:
                return
            for idx in range(self.transport.num_workers):
                t = self._threads.get(idx)
                if t is None or not t.is_alive():
                    t = threading.Thread(target=self._worker, args=(idx,),
                                         name=f"evalpool-{idx}", daemon=True)
                    self._threads[idx] = t
                    t.start()

    def _worker(self, idx: int) -> None:
        while True:
            if not self._unpaused.is_set():
                # paused: never pop (or idle-exit past) queued work
                self._unpaused.wait(self._idle_s)
                continue
            try:
                prio, _, source, handle = self._queue.get(
                    timeout=self._idle_s)
            except queue.Empty:
                with self._lock:
                    # exit only while provably idle: a job enqueued before
                    # this check keeps the thread alive; one enqueued after
                    # finds the thread dead and _ensure_workers respawns it
                    if self._queue.empty():
                        if self._threads.get(idx) is threading.current_thread():
                            del self._threads[idx]
                        return
                continue
            if source is None:        # shutdown sentinel
                with self._lock:
                    if self._threads.get(idx) is threading.current_thread():
                        del self._threads[idx]
                return
            with self._lock_for(idx):
                self._run_job(idx, source, handle, prio)

    def _run_job(self, idx: int, source: str, handle: EvalHandle,
                 priority: int = PRIORITY_CAMPAIGN) -> None:
        t0 = time.perf_counter()
        handle.worker = idx
        try:
            if self.cache is not None:
                res = self.cache.get(handle.key)
                if res is not None:
                    handle.cached = True
                    self._emit("eval_cache", outcome="hit",
                               key=handle.key[:12], tag=handle.tag,
                               worker=idx)
                    handle.duration_s = time.perf_counter() - t0
                    handle._finish(result=res)
                    return
                self._emit("eval_cache", outcome="miss",
                           key=handle.key[:12], tag=handle.tag, worker=idx)

            def on_retry(attempt, exc, delay):
                self._emit("retry", stage="evaluate", tag=handle.tag,
                           worker=idx, attempt=attempt,
                           error=f"{type(exc).__name__}: {exc}",
                           delay_s=round(delay, 3))

            res = resilience.retry_call(
                lambda: self.transport.run(idx, source),
                policy=self.retry_policy, on_retry=on_retry,
                sleep=self._sleep)
            if self.cache is not None:
                self.cache.put(handle.key, res)
            handle.duration_s = time.perf_counter() - t0
            handle._finish(result=res)
        except resilience.ServiceBusyError as e:
            # every zero-backoff retry found this worker occupied: reroute —
            # re-enqueue at the original priority so whichever worker frees
            # up first takes it.  Deliberately NOT handle.requeues: a
            # saturated-but-healthy pool must never exhaust a job's
            # worker-death budget.
            handle.busy_reroutes += 1
            self._emit("busy_reroute", worker=idx, tag=handle.tag,
                       busy_reroutes=handle.busy_reroutes)
            if handle.busy_reroutes > self.max_busy_reroutes:
                handle.duration_s = time.perf_counter() - t0
                handle._finish(exc=RuntimeError(
                    f"rerouted {handle.busy_reroutes} times without finding "
                    f"a free worker: {e}"))
            else:
                self._queue.put((priority, next(self._seq), source, handle))
        except WorkerDiedError as e:
            # the worker died or stalled with this job in flight: requeue at
            # the original priority — any (respawned) worker re-evaluates to
            # the identical verdict, so the campaign trajectory is unchanged
            handle.requeues += 1
            self._emit("worker_requeue", worker=idx, tag=handle.tag,
                       requeues=handle.requeues, reason=str(e))
            handle.duration_s = time.perf_counter() - t0
            if self.quarantine is not None:
                deaths = self.quarantine.record_death(handle.key, str(e))
                blocked = self.quarantine.blocked(handle.key)
                if blocked is not None:
                    # this kernel kills workers deterministically: blacklist
                    # its content hash so rediscoveries cost zero deaths
                    self._emit("quarantine_add", key=handle.key[:12],
                               tag=handle.tag, deaths=deaths, reason=blocked)
                    handle._finish(result=EvalResult(
                        "quarantined", f"quarantined kernel: {blocked}"))
                    return
            if handle.requeues > self.max_requeues:
                # terminal *verdict*, not an exception: the campaign records
                # it in the logbook (score inf) and moves on — one doomed
                # kernel must not abort the drain.  Never cached.
                handle._finish(result=EvalResult(
                    "worker_error",
                    f"gave up after {handle.requeues} worker deaths: {e}"))
            else:
                self._queue.put((priority, next(self._seq), source, handle))
        except BaseException as e:
            # Exceptions (retries exhausted) become the caller's "failed"
            # verdict; BaseExceptions (KeyboardInterrupt) surface at drain
            # so a killed campaign unwinds exactly like the sequential loop.
            handle.duration_s = time.perf_counter() - t0
            handle._finish(exc=e)
