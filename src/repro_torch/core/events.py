"""Structured JSONL event log for the Kernel Scientist campaign.

Port of ``repro.core.events`` (framework-free; copied with its imports
pointing at this package).

Every observable of the discovery process — stage start/end with durations,
retries and fallbacks, per-submission evaluation outcomes, generation
summaries — is appended as one JSON object per line to ``events.jsonl`` in
the campaign workdir (and kept in memory when no workdir is set).  The log is
append-only so a resumed campaign extends the same file, and it is consumed
by ``benchmarks/trajectory.py`` for the §4.4 discovery-process figure
(best-so-far curve annotated with retry/fallback density and stage
latencies).

Events are *observational*: nothing in the loop reads them back, so wall
timestamps here never affect resume determinism.

Worker lifecycle events (``WORKER_LIFECYCLE_EVENTS``) chronicle the
distributed evaluation layer: spawns/exits/deaths of transport workers,
requeues of in-flight jobs after a death, and pool pause/resume — the
observables a campaign operator greps first when a multi-day run slows
down.  ``worker_lifecycle()`` filters them per worker index.
"""
from __future__ import annotations

import json
import pathlib
import threading
import time
from typing import Optional

#: Events emitted by the evalpool/transport layer about worker health.
WORKER_LIFECYCLE_EVENTS = ("worker_spawn", "worker_exit", "worker_died",
                           "worker_requeue", "worker_respawn",
                           "pool_pause", "pool_resume")

#: Events emitted by the verdict-trust layer (``core.integrity``): audit
#: flags and quorum resolutions, quarantine adds/blocks, canary checks and
#: drift responses, circuit-breaker transitions, health snapshots, and
#: budget stops.  The substream an operator greps to answer "can I trust
#: this campaign's timings?".
INTEGRITY_EVENTS = ("audit_flag", "audit_quorum", "quarantine_add",
                    "quarantine_block", "canary", "worker_drift",
                    "worker_respawn", "verdict_invalidated", "breaker",
                    "health", "budget_stop", "busy_reroute")


class EventLog:
    def __init__(self, path=None, clock=time.time) -> None:
        self.path = pathlib.Path(path) if path else None
        self.records: list[dict] = []
        self._seq = 0
        self._clock = clock
        # EvalPool workers emit from their own threads; keep seq + append
        # atomic so the JSONL stream stays well-ordered
        self._lock = threading.Lock()
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            if self.path.exists():  # resumed campaign: continue the sequence
                try:
                    prior = self.read(self.path)
                    self._seq = prior[-1]["seq"] if prior else 0
                except (json.JSONDecodeError, KeyError):
                    self._seq = 0

    def emit(self, event: str, **fields) -> dict:
        with self._lock:
            self._seq += 1
            rec = {"seq": self._seq, "ts": round(self._clock(), 3),
                   "event": event, **fields}
            self.records.append(rec)
            if self.path:
                with open(self.path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
        return rec

    # ------------------------------------------------------------- queries
    def counts(self, event: Optional[str] = None) -> dict:
        """event name -> count (or {} filtered to one event)."""
        out: dict[str, int] = {}
        for r in self.records:
            if event is None or r["event"] == event:
                out[r["event"]] = out.get(r["event"], 0) + 1
        return out

    def select(self, event: str, **where) -> list[dict]:
        return [r for r in self.records if r["event"] == event
                and all(r.get(k) == v for k, v in where.items())]

    def worker_lifecycle(self, worker: Optional[int] = None) -> list[dict]:
        """The worker-health substream (spawns, deaths, requeues,
        pause/resume), optionally filtered to one worker index."""
        out = [r for r in self.records
               if r["event"] in WORKER_LIFECYCLE_EVENTS]
        if worker is not None:
            out = [r for r in out if r.get("worker") == worker]
        return out

    def integrity_events(self, event: Optional[str] = None) -> list[dict]:
        """The verdict-trust substream (audits, quarantines, canaries,
        breakers, health), optionally filtered to one event name."""
        wanted = INTEGRITY_EVENTS if event is None else (event,)
        return [r for r in self.records if r["event"] in wanted]

    def stage_durations(self) -> dict:
        """stage name -> list of duration_s from stage_end events."""
        out: dict[str, list] = {}
        for r in self.select("stage_end"):
            out.setdefault(r["stage"], []).append(r["duration_s"])
        return out

    @staticmethod
    def read(path) -> list[dict]:
        out = []
        for line in pathlib.Path(path).read_text().splitlines():
            line = line.strip()
            if line:
                out.append(json.loads(line))
        return out
