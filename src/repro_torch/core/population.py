"""Kernel population: records, lineage, per-config benchmark timings.

Port of ``repro.core.population`` (framework-free; copied with its imports
pointing at this package).

Mirrors the paper's population mechanics exactly: each member has an ID, its
parents' IDs, and benchmark results over the competition's MxKxN
configurations; the Evolutionary Selector sees a compact table of exactly
this information (paper §3.1).
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
from typing import Optional

from .genome import KernelGenome

# ---------------------------------------------------------------------------
# Benchmark configurations.  The AMD Developer Challenge 2025 "fp8-mm" task
# benchmarked DeepSeek-shaped GEMMs at m in {1024, 6144}; the leaderboard was
# the geometric mean over 18 (m, n, k) sizes, and the paper's selector prompt
# shows 6 of them (§3.1, A.1 cites m=6144, k=512, n=4096).
# ---------------------------------------------------------------------------
_NK_PAIRS = [
    (1536, 7168), (3072, 1536), (576, 7168), (7168, 256), (7168, 2048),
    (4608, 7168), (7168, 2304), (512, 7168), (4096, 512),
]
BENCH_CONFIGS_18 = tuple((m, n, k) for m in (1024, 6144) for (n, k) in _NK_PAIRS)
# The 6-config view given to the Evolutionary Selector (paper §3.1).
BENCH_CONFIGS_6 = (
    (1024, 1536, 7168), (1024, 7168, 2048), (1024, 4096, 512),
    (6144, 1536, 7168), (6144, 7168, 2048), (6144, 4096, 512),
)


def config_key(cfg: tuple) -> str:
    m, n, k = cfg
    return f"m{m}_n{n}_k{k}"


def geomean(values) -> float:
    vals = [v for v in values if v is not None and v > 0]
    if not vals:
        return float("inf")
    return math.exp(sum(math.log(v) for v in vals) / len(vals))


@dataclasses.dataclass
class KernelRecord:
    """One population member — the unit the three LLM stages operate on."""

    rid: str                                  # "00001"-style ID
    parents: tuple                            # (base_id,) or (base_id, reference_id)
    source: str                               # the kernel source text submitted
    genome: Optional[KernelGenome]            # None if source was hand/LLM-written
    experiment: dict                          # {description, rubric, performance, innovation}
    writer_report: str = ""                   # what the writer says it actually did
    # pending | ok | compile_error | runtime_error | incorrect | failed
    #         | worker_error | quarantined
    # ("failed": the evaluation service itself errored after retries —
    #  platform-level failure, not a verdict about the kernel;
    #  "worker_error": the kernel's evaluation killed workers until the
    #  pool's requeue budget ran out; "quarantined": its content hash is
    #  blacklisted by core.integrity.Quarantine — both score inf, so
    #  selection never touches them)
    status: str = "pending"
    error: str = ""                           # platform feedback on failure
    timings_us: dict = dataclasses.field(default_factory=dict)  # config_key -> µs
    generation: int = 0

    @property
    def score(self) -> float:
        """Leaderboard metric: geometric-mean µs (lower is better)."""
        if self.status != "ok":
            return float("inf")
        return geomean(self.timings_us.values())

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["parents"] = list(self.parents)
        d["genome"] = self.genome.to_json() if self.genome else None
        return d

    @staticmethod
    def from_dict(d: dict) -> "KernelRecord":
        d = dict(d)
        d["parents"] = tuple(d["parents"])
        d["genome"] = KernelGenome.from_json(d["genome"]) if d["genome"] else None
        return KernelRecord(**d)


class Population:
    """Ordered store of KernelRecords with lineage queries + persistence."""

    def __init__(self) -> None:
        self._records: dict[str, KernelRecord] = {}
        self._counter = 0

    # ----------------------------------------------------------- mutation
    def new_id(self) -> str:
        self._counter += 1
        return f"{self._counter:05d}"

    def add(self, rec: KernelRecord) -> KernelRecord:
        # real exceptions, not asserts: these invariants must hold under -O
        if rec.rid in self._records:
            raise ValueError(f"duplicate record id {rec.rid!r}")
        for p in rec.parents:
            if p not in self._records:
                raise ValueError(f"unknown parent {p!r} of {rec.rid!r}")
        self._records[rec.rid] = rec
        return rec

    def remove(self, rid: str) -> KernelRecord:
        """Drop a record (and roll back the id counter if it was the newest).

        Used by campaign resume to discard the in-flight kernel of a crashed
        generation so its replay re-issues the same id.  Records with
        children cannot be removed.
        """
        rec = self._records.get(rid)
        if rec is None:
            raise KeyError(rid)
        children = [r.rid for r in self if rid in r.parents]
        if children:
            raise ValueError(f"{rid!r} has children {children}")
        del self._records[rid]
        self._counter = max((int(r.rid) for r in self), default=0)
        return rec

    # ------------------------------------------------------------ queries
    def __len__(self) -> int:
        return len(self._records)

    def __iter__(self):
        return iter(self._records.values())

    def get(self, rid: str) -> KernelRecord:
        return self._records[rid]

    def ok_records(self) -> list[KernelRecord]:
        return [r for r in self if r.status == "ok"]

    def quarantined_records(self) -> list[KernelRecord]:
        """Members blacklisted by ``core.integrity.Quarantine`` (their
        evaluation killed workers): excluded from selection, surfaced to
        the designer as genomes to steer away from."""
        return [r for r in self if r.status == "quarantined"]

    def best(self) -> Optional[KernelRecord]:
        ok = self.ok_records()
        return min(ok, key=lambda r: r.score) if ok else None

    def best_per_config(self) -> dict:
        """config_key -> (rid, µs) of the per-config champion."""
        out: dict[str, tuple] = {}
        for r in self.ok_records():
            for key, t in r.timings_us.items():
                if t is not None and (key not in out or t < out[key][1]):
                    out[key] = (r.rid, t)
        return out

    def ancestors(self, rid: str) -> set:
        seen: set[str] = set()
        stack = list(self.get(rid).parents)
        while stack:
            p = stack.pop()
            if p not in seen:
                seen.add(p)
                stack.extend(self.get(p).parents)
        return seen

    def lineage_divergent(self, a: str, b: str) -> bool:
        """True when neither record is an ancestor of the other — the
        'divergent optimization path' situation the paper's selector
        rationales single out (A.1, first sample)."""
        return b not in self.ancestors(a) | {a} and a not in self.ancestors(b) | {b}

    def one_step_analysis(self, rid: str) -> dict:
        """The paper's 'one-step experiment analysis': the experiment that led
        to a record, plus its own and its parent's benchmarks.  'By
        construction, all this information will exist' (§3.3)."""
        rec = self.get(rid)
        parent = self.get(rec.parents[0]) if rec.parents else None
        return {
            "id": rec.rid,
            "experiment": rec.experiment,
            "writer_report": rec.writer_report,
            "benchmarks": rec.timings_us,
            "status": rec.status,
            "error": rec.error,
            "parent_id": parent.rid if parent else None,
            "parent_benchmarks": parent.timings_us if parent else {},
        }

    def summary_table(self) -> list[dict]:
        """The Evolutionary Selector's view: ID, parents, per-config timings
        (paper §3.1) — nothing else crosses the interface."""
        rows = []
        for r in self:
            kind = ("library" if (r.genome and r.genome.style == "library")
                    else "kernel")
            rows.append({
                "id": r.rid,
                "parents": list(r.parents),
                "kind": kind,
                "status": r.status,
                "benchmarks_us": {k: (round(v, 2) if v else v)
                                  for k, v in r.timings_us.items()},
                "score_geomean_us": (round(r.score, 2)
                                     if r.score != float("inf") else None),
            })
        return rows

    # -------------------------------------------------------- persistence
    def save(self, path) -> None:
        path = pathlib.Path(path)
        tmp = path.with_suffix(".tmp")
        payload = {
            "counter": self._counter,
            "records": [r.to_dict() for r in self],
        }
        tmp.write_text(json.dumps(payload, indent=1))
        tmp.replace(path)  # atomic

    @staticmethod
    def load(path) -> "Population":
        payload = json.loads(pathlib.Path(path).read_text())
        pop = Population()
        pop._counter = payload["counter"]
        for d in payload["records"]:
            rec = KernelRecord.from_dict(d)
            pop._records[rec.rid] = rec
        return pop
