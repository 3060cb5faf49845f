"""The port's Kernel Scientist slice on the CPU, against the JAX package.

* Verdict parity: the three seeds and every kernel of a 1-generation port
  campaign (``device="cpu"``, configs (256,256,256) and (256,384,512)) get
  the same verdict status from the port's EvaluationService as from the JAX
  ``EvaluationService(backend="wall_clock")`` on the JAX rendering of the
  same genome (Pallas in interpret mode).
* Determinism: ``workers=3`` is population-identical to ``workers=1`` over
  2 generations, and kill-and-resume is trajectory-identical, under a
  test-only service whose timings are a pure function of the GENOME.
* Platform feedback and the card-by-default contract.
"""
import json
import threading

import pytest
import torch

from repro.core import codegen as jcodegen
from repro.core import genome as jgenome
from repro.core.evaluator import EvaluationService as JaxService
from repro_torch.core import (EvalPool, EvalResult, EvaluationService,
                              KernelScientist, NO_WAIT_POLICY, ScriptedLLM,
                              codegen, knowledge, prompts)
from repro_torch.core.genome import SEED_MONOLITH, SEED_MXU, KernelGenome
from repro_torch.core.llm import ScriptedLLM as _ScriptedLLM
from repro_torch.core.population import config_key
from repro_torch.launch import scientist as launch

SMALL = ((256, 256, 256), (256, 384, 512))


@pytest.fixture(scope="module")
def cpu_campaign(tmp_path_factory):
    wd = tmp_path_factory.mktemp("campaign")
    sci = launch.run_campaign(1, wd, device="cpu", bench_configs=SMALL)
    sci.pool.close()
    return sci


def test_campaign_verdicts_match_jax_service(cpu_campaign):
    recs = list(cpu_campaign.population)
    assert len(recs) == 6                 # 3 seeds + 3 writer kernels
    jsvc = JaxService(backend="wall_clock", bench_configs=SMALL)
    for rec in recs:
        jg = jgenome.KernelGenome(**json.loads(rec.genome.to_json()))
        jres = jsvc.submit(jcodegen.render_source(jg))
        assert rec.status == jres.status, (rec.rid, rec.error, jres.error)
        assert set(rec.timings_us) == {config_key(c) for c in SMALL}


def test_campaign_seeds_and_writer_kernels_are_ok(cpu_campaign):
    recs = list(cpu_campaign.population)
    assert [r.status for r in recs[:3]] == ["ok"] * 3
    assert any(r.generation == 1 and r.status == "ok" for r in recs)
    assert "CUDA" in recs[1].experiment["description"]


# ----------------------------------------------------------- determinism
class GenomeTimedService:
    """Sequential test service: correctness from the real CPU platform is
    not needed here, so every GENOME is ``ok`` with timings that are a pure
    function of it (the ScriptedLLM's napkin model)."""

    configs = SMALL

    def __init__(self):
        self._lock = threading.Lock()
        self.submissions = 0

    def submit(self, source: str) -> EvalResult:
        with self._lock:
            self.submissions += 1
            _, genome_json = codegen.load_kernel(source)
            g = json.loads(genome_json)
            llm = _ScriptedLLM()
            return EvalResult("ok", timings_us={
                config_key(c): llm._napkin_us(g, *c) for c in self.configs})

    def clone(self):
        return GenomeTimedService()

    def state_dict(self):
        return {"submissions": self.submissions}

    def load_state_dict(self, d):
        self.submissions = d["submissions"]


def _snapshot(sci):
    return [(r.rid, r.parents, r.status, r.timings_us, r.source)
            for r in sci.population]


def _campaign(workers, workdir=None, generations=2):
    pool = EvalPool.of(GenomeTimedService(), workers=workers,
                       retry_policy=NO_WAIT_POLICY)
    sci = KernelScientist(llm=ScriptedLLM(seed=3), backend=pool,
                          workdir=workdir, retry_policy=NO_WAIT_POLICY)
    sci.run(generations=generations)
    pool.close()
    return sci


def test_workers_3_population_identical_to_workers_1():
    one, three = _campaign(1), _campaign(3)
    assert len(one.population) == 9
    assert _snapshot(one) == _snapshot(three)


def test_resume_is_trajectory_identical(tmp_path):
    straight = _campaign(1, generations=2)
    _campaign(1, workdir=tmp_path, generations=1)
    pool = EvalPool.of(GenomeTimedService(), retry_policy=NO_WAIT_POLICY)
    resumed = KernelScientist.resume(tmp_path, llm=ScriptedLLM(seed=3),
                                     backend=pool, retry_policy=NO_WAIT_POLICY)
    resumed.run(generations=1)
    pool.close()
    assert _snapshot(resumed) == _snapshot(straight)


# ------------------------------------------------------ platform feedback
@pytest.fixture
def svc():
    return EvaluationService(device="cpu", bench_configs=SMALL[:1])


def test_platform_rejects_broken_source(svc):
    assert svc.submit("this is not python !!").status == "compile_error"
    assert svc.submit("x = 1\n").status == "compile_error"


@pytest.mark.parametrize("exc,status", [
    ("_build.KernelBuildError('nvcc failed')", "compile_error"),
    ("_build.LaunchRefusedError('too much shared memory')", "compile_error"),
    ("_build.CudaError('illegal address')", "runtime_error"),
    ("IndexError('tile bug')", "runtime_error"),
])
def test_build_and_launch_failures_map_to_verdicts(svc, exc, status):
    src = ("GENOME = None\n"
           "from repro_torch.kernels import _build\n"
           "def run(a, b, a_scale, b_scale):\n"
           f"    raise {exc}\n")
    assert svc.submit(src).status == status


def test_platform_rejects_wrong_answers(svc):
    src = ("GENOME = None\nimport torch\n"
           "def run(a, b, a_scale, b_scale):\n"
           "    return torch.zeros(a.shape[0], b.shape[1])\n")
    assert svc.submit(src).status == "incorrect"


def test_single_block_seed_is_correct_at_the_check_size(svc):
    res = svc.submit(codegen.render_source(SEED_MONOLITH))
    assert res.status == "ok"


def test_sequential_submission_enforced(svc):
    svc._lock.acquire()
    try:
        with pytest.raises(RuntimeError, match="sequential"):
            svc.submit("x = 1")
    finally:
        svc._lock.release()


def test_jitter_is_content_keyed():
    a = EvaluationService(device="cpu", noise=0.02, seed=7)
    b = EvaluationService(device="cpu", noise=0.02, seed=7)
    c = EvaluationService(device="cpu", noise=0.02, seed=8)
    cfg = (256, 256, 256)
    assert a._jitter(100.0, cfg, "k") == b._jitter(100.0, cfg, "k")
    assert a._jitter(100.0, cfg, "k") != c._jitter(100.0, cfg, "k")
    assert a._jitter(100.0, cfg, "k") != a._jitter(100.0, cfg, "j")


# ---------------------------------------------- card by default, no TPU
def test_service_and_campaign_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        EvaluationService()
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.main(["--generations", "1", "--workdir", str(tmp_path)])


def test_subprocess_transport_gives_inprocess_verdicts():
    """Worker processes rebuild the service from its spec (device
    included) and give the in-process statuses; the times are measured in
    each process, so only their keys are compared."""
    service = EvaluationService(device="cpu", bench_configs=SMALL[:1])
    sources = [codegen.render_source(SEED_MXU),
               codegen.render_source(SEED_MONOLITH),
               "this is not python !!",
               "GENOME = None\nimport torch\n"
               "def run(a, b, a_scale, b_scale):\n"
               "    return torch.zeros(a.shape[0], b.shape[1])\n"]
    pool = EvalPool.of(service, transport="subprocess",
                       retry_policy=NO_WAIT_POLICY)
    try:
        got = [pool.submit_async(s).result(timeout=300) for s in sources]
        assert pool.stats()["transport"] == "subprocess"
    finally:
        pool.close()
    want = [service.submit(s) for s in sources]
    assert [r.status for r in got] == [r.status for r in want] == \
        ["ok", "ok", "compile_error", "incorrect"]
    assert [set(r.timings_us) for r in got] == \
        [set(r.timings_us) for r in want]


def test_launcher_evaluates_in_subprocess_workers_by_default(monkeypatch):
    seen = []

    def fake(generations, workdir, **kw):
        seen.append(kw)
        raise SystemExit(0)

    monkeypatch.setattr(launch, "run_campaign", fake)
    for argv in ([], ["--transport", "inprocess", "--job-timeout-s", "5"]):
        with pytest.raises(SystemExit):
            launch.main(argv)
    assert [(k["transport"], k["job_timeout_s"]) for k in seen] == \
        [("subprocess", 600.0), ("inprocess", 5.0)]


def test_writer_repairs_a_shared_memory_excess():
    llm = _ScriptedLLM()
    base = SEED_MXU
    state = {"stage": "writer",
             "experiment": {"description": "grow tiles", "rubric": "r",
                            "genome_edit": {"block_m": 256, "block_n": 256,
                                            "block_k": 256}},
             "base": {"genome": base.to_json(), "source": ""}}
    reply = json.loads(llm.complete(prompts._state_block(state)))
    g = KernelGenome(**reply["genome"])
    assert g.validate() == []
    assert "shared memory" in reply["report"]


def test_prompts_and_avenues_name_the_card():
    assert "H100" in prompts.TASK_TEXT and "CUDA" in prompts.TASK_TEXT
    assert "TPU" not in prompts.TASK_TEXT and "Pallas" not in prompts.TASK_TEXT
    assert "H100" in knowledge.FINDINGS_DOCUMENT
    names = {a.name for a in knowledge.AVENUES}
    assert "dimension_semantics" not in names and "split_k" in names
    for avenue in knowledge.AVENUES:
        for _, g in avenue.edits(SEED_MXU):
            assert g.validate() == []
