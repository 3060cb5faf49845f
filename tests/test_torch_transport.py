"""The port's subprocess eval workers, on the CPU.

The contracts of ``tests/test_transport.py`` for ``repro_torch``:
  * wire protocol — length-prefixed JSONL frames round-trip; EOF is a clean
    ``None``; torn/corrupt frames raise instead of desyncing the stream;
  * service specs — an ``EvaluationService`` stack (its ``device``
    included) rebuilds from its JSON spec;
  * subprocess transport — real ``repro_torch.core.eval_worker`` children
    give the in-process verdicts, injected ``os._exit`` deaths requeue and
    respawn with stepped incarnations, job deadlines reap wedged workers,
    and a child's exhausted retries are an error, not a death;
  * ``make_transport`` resolution;
  * the kill soak — a subprocess campaign with >= 20% injected worker
    deaths finishes population-identical to an in-process ``workers=1``
    run, through the content-keyed ``EchoService`` (on the CPU the port's
    ``EvaluationService`` measures its times, so its verdicts carry no
    fixed timings to compare);
  * the poisoned-context rule — a submission that leaves the service's
    context unusable gets its verdict, then the worker exits and the next
    job runs in a fresh incarnation; in-process, the service refuses every
    later submission with ``PoisonedContextError``.
"""
import io
import json

import pytest
import torch

from repro_torch.core import codegen, evaluator
from repro_torch.core.eval_worker import (EchoService, SleepyService,
                                          StickyService, build_service, serve)
from repro_torch.core.evalpool import EvalCache, EvalPool
from repro_torch.core.evaluator import (EvalResult, EvaluationService,
                                        PoisonedContextError)
from repro_torch.core.events import EventLog
from repro_torch.core.genome import SEED_MXU
from repro_torch.core.llm import ScriptedLLM
from repro_torch.core.resilience import (NO_WAIT_POLICY, CrashService,
                                         FlakyService, TransientError)
from repro_torch.core.scientist import KernelScientist
from repro_torch.core.transport import (
    InProcessTransport, RemoteEvalError, SubprocessTransport, make_transport,
    read_frame, service_spec_of, write_frame,
)

SMALL = ((256, 256, 256),)

#: Subprocess options tuned for tests: fast heartbeats, a deadline generous
#: enough for a cold child (torch import) but short enough to fail fast.
FAST_SUB = dict(heartbeat_interval_s=0.1, deadline_s=30.0,
                poll_interval_s=0.02)


# ---------------------------------------------------------------------------
# Wire protocol
# ---------------------------------------------------------------------------
def test_frame_round_trip():
    buf = io.BytesIO()
    frames = [{"frame": "submit", "job_id": 1, "source": "x = 1\n"},
              {"frame": "result", "timings_us": {"m1_n1_k1": 2.5},
               "note": "unicode µs → ok"},
              {"frame": "heartbeat"},
              {"frame": "submit", "source": "L" * 100_000}]  # large payload
    for f in frames:
        write_frame(buf, f)
    buf.seek(0)
    assert [read_frame(buf) for _ in frames] == frames
    assert read_frame(buf) is None           # clean EOF after the last frame


def test_frame_torn_and_corrupt_inputs():
    assert read_frame(io.BytesIO(b"")) is None
    with pytest.raises(ValueError, match="corrupt frame length"):
        read_frame(io.BytesIO(b"not-a-number\n{}\n"))
    whole = io.BytesIO()
    write_frame(whole, {"frame": "hello"})
    torn = io.BytesIO(whole.getvalue()[:-5])  # truncated payload
    with pytest.raises(ValueError, match="truncated"):
        read_frame(torn)
    with pytest.raises(ValueError, match="payload"):
        read_frame(io.BytesIO(b"8\n{\"frame\"\n"))  # right length, bad JSON


def test_service_spec_round_trip_rebuilds_equivalent_stack():
    svc = FlakyService(EvaluationService(device="cpu", bench_configs=SMALL,
                                         noise=0.05, seed=9),
                       seed=4, error_rate=0.2)
    spec = service_spec_of(svc)
    rebuilt = build_service(json.loads(json.dumps(spec)))  # via the wire
    assert type(rebuilt).__name__ == "FlakyService"
    assert (rebuilt.seed, rebuilt.error_rate) == (4, 0.2)
    inner = rebuilt.inner
    assert inner.device == torch.device("cpu")
    assert (inner.seed, inner.noise, inner.bench_configs) == (9, 0.05, SMALL)
    assert service_spec_of(rebuilt) == spec
    src = codegen.render_source(SEED_MXU)
    assert inner.submit(src).status == svc.inner.submit(src).status == "ok"
    with pytest.raises(TypeError, match="service_spec"):
        service_spec_of(object())


# ---------------------------------------------------------------------------
# SubprocessTransport against real eval_worker children
# ---------------------------------------------------------------------------
def test_subprocess_round_trip_matches_inprocess_verdicts():
    events = EventLog()
    pool = EvalPool.of(EchoService(), workers=2, events=events,
                       retry_policy=NO_WAIT_POLICY, transport="subprocess",
                       transport_options=FAST_SUB)
    sources = [f"kernel variant {i}\n" for i in range(4)]
    handles = [pool.submit_async(s, tag=str(i))
               for i, s in enumerate(sources)]
    results = [h.result(timeout=60) for h in handles]
    local = EchoService()
    for src, res in zip(sources, results):
        assert res.status == "ok"
        assert res.timings_us == local.submit(src).timings_us
    assert pool.stats()["transport"] == "subprocess"
    assert pool.submissions == len(sources)
    spawns = events.select("worker_spawn")
    assert spawns and all(s["transport"] == "subprocess" for s in spawns)
    pool.close()
    # close() shut the children down cleanly
    assert len(events.select("worker_exit")) == len(spawns)


def test_subprocess_worker_kill_requeues_and_respawns():
    """CrashService(seed=0) inside the child os._exit()s deterministically;
    the parent must detect each death, respawn with a stepped incarnation,
    and requeue to the same content-keyed verdicts."""
    events = EventLog()
    svc = CrashService(EchoService(), seed=0, crash_rate=0.25)
    pool = EvalPool.of(svc, workers=1, events=events,
                       retry_policy=NO_WAIT_POLICY, transport="subprocess",
                       transport_options=FAST_SUB)
    sources = [f"crashy kernel {i}\n" for i in range(6)]
    handles = [pool.submit_async(s) for s in sources]
    results = [h.result(timeout=120) for h in handles]
    local = EchoService()
    for src, res in zip(sources, results):
        assert res.status == "ok"
        assert res.timings_us == local.submit(src).timings_us
    deaths = events.select("worker_died")
    assert deaths, "crash_rate=0.25 at seed 0 must kill at least one worker"
    assert len(events.select("worker_requeue")) == len(deaths)
    assert sum(h.requeues for h in handles) == len(deaths)
    # every respawn stepped the incarnation: 0, 1, 2, ...
    incs = [s["incarnation"] for s in events.select("worker_spawn")]
    assert incs == list(range(len(deaths) + 1))
    pool.close()


def test_subprocess_job_deadline_reaps_wedged_worker():
    events = EventLog()
    svc = SleepyService(EchoService(), match="STALL", sleep_s=60.0)
    opts = dict(FAST_SUB, job_timeout_s=2.0)
    pool = EvalPool.of(svc, workers=1, events=events,
                       retry_policy=NO_WAIT_POLICY, transport="subprocess",
                       transport_options=opts)
    handle = pool.submit_async("kernel with STALL marker\n")
    res = handle.result(timeout=120)         # incarnation 1 does not sleep
    assert res.status == "ok" and handle.requeues == 1
    [death] = events.select("worker_died")
    assert "job deadline" in death["reason"]
    pool.close()


def test_subprocess_remote_retry_exhaustion_is_not_a_death():
    """A child whose own retries are exhausted reports an error frame —
    the pool marks the submission failed instead of requeueing forever."""
    transport = SubprocessTransport(
        [{"kind": "flaky", "error_rate": 1.0, "seed": 0,
          "inner": {"kind": "echo"}}],
        policy=NO_WAIT_POLICY, **FAST_SUB)
    try:
        with pytest.raises(RemoteEvalError, match="TransientError"):
            transport.run(0, "always fails\n")
    finally:
        transport.close()


def test_make_transport_resolution():
    svc = EchoService()
    assert isinstance(make_transport("inprocess", [svc]), InProcessTransport)
    inst = InProcessTransport([svc])
    assert make_transport(inst, []) is inst
    sub = make_transport("subprocess", [svc])
    assert isinstance(sub, SubprocessTransport)
    sub.close()
    with pytest.raises(ValueError, match="unknown transport"):
        make_transport("carrier-pigeon", [svc])


def test_subprocess_evaluation_service_reports_kernel_launches():
    """The worker counts its launches (none on the CPU: the plain
    versions) and the verdict is the in-process one."""
    svc = EvaluationService(device="cpu", bench_configs=SMALL)
    transport = SubprocessTransport([service_spec_of(svc)], **FAST_SUB)
    src = codegen.render_source(SEED_MXU)
    try:
        res = transport.run(0, src)
    finally:
        transport.close()
    assert res.status == svc.submit(src).status == "ok"
    assert set(res.timings_us) == set(svc.submit(src).timings_us)
    assert sum(transport.launches.values()) == 0


# ---------------------------------------------------------------------------
# The poisoned-context rule
# ---------------------------------------------------------------------------
def test_worker_exits_after_the_verdict_that_lost_its_context():
    """Fault attribution and containment: the faulting source gets its
    runtime_error, its worker leaves, the next sources run ok in a fresh
    incarnation."""
    events = EventLog()
    svc = StickyService(EchoService(), match="FAULT")
    pool = EvalPool.of(svc, workers=1, events=events,
                       retry_policy=NO_WAIT_POLICY, transport="subprocess",
                       transport_options=FAST_SUB)
    sources = ["good kernel\n", "kernel with FAULT\n", "good kernel #2\n",
               "another good kernel\n"]
    results = [pool.submit_async(s).result(timeout=120) for s in sources]
    assert [r.status for r in results] == ["ok", "runtime_error", "ok", "ok"]
    assert "illegal memory access" in results[1].error
    local = EchoService()
    assert results[2].timings_us == local.submit(sources[2]).timings_us
    exits = events.select("worker_exit")
    assert exits[0]["incarnation"] == 0
    assert "CUDA context unusable" in exits[0]["reason"]
    assert [s["incarnation"] for s in events.select("worker_spawn")] == [0, 1]
    assert not events.select("worker_died")   # a clean exit, not a death
    assert not events.select("worker_requeue")
    pool.close()


def test_serve_loop_stops_after_a_lost_context():
    """The frame loop itself: the verdict goes out with ``exit`` set, and
    the submission queued behind it is never evaluated."""
    stdin = io.BytesIO()
    write_frame(stdin, {"frame": "init", "incarnation": 0,
                        "spec": StickyService(EchoService()).service_spec(),
                        "heartbeat_interval_s": 30.0})
    write_frame(stdin, {"frame": "submit", "job_id": 1,
                        "source": "FAULT here\n"})
    write_frame(stdin, {"frame": "submit", "job_id": 2, "source": "next\n"})
    stdin.seek(0)
    stdout = io.BytesIO()
    lost = serve(stdin, stdout)
    assert "illegal memory access" in lost
    stdout.seek(0)
    frames = []
    while (f := read_frame(stdout)) is not None:
        frames.append(f)
    results = [f for f in frames if f["frame"] == "result"]
    assert [r["job_id"] for r in results] == [1]
    assert results[0]["status"] == "runtime_error"
    assert "CUDA context unusable" in results[0]["exit"]


def test_inprocess_service_refuses_to_go_on_after_a_lost_context(monkeypatch):
    """After an execution error whose context probe fails, the faulting
    source keeps its runtime_error and every later submission raises a
    non-transient error that names the poisoned context."""
    svc = EvaluationService(device="cpu", bench_configs=SMALL)
    monkeypatch.setattr(evaluator.torch.cuda, "synchronize",
                        lambda device=None: None)
    monkeypatch.setattr(evaluator, "probe_context",
                        lambda device: "AcceleratorError: CUDA error: an "
                                       "illegal memory access was encountered")
    ok = svc._settle(EvalResult("ok"))
    assert ok.status == "ok" and svc.context_lost is None  # no probe
    bad = svc._settle(EvalResult("runtime_error", "CudaError ..."))
    assert bad.status == "runtime_error"
    assert "illegal memory access" in svc.context_lost
    with pytest.raises(PoisonedContextError, match="subprocess") as info:
        svc.submit(codegen.render_source(SEED_MXU))
    assert not isinstance(info.value, TransientError)
    assert "CUDA context" in str(info.value)


def test_late_fault_lands_on_its_own_source(monkeypatch):
    """The synchronise that ends a submission turns a fault the card
    reports late into that submission's runtime_error."""
    svc = EvaluationService(device="cpu", bench_configs=SMALL)

    def late_fault(device=None):
        raise RuntimeError("CUDA error: unspecified launch failure")

    monkeypatch.setattr(evaluator.torch.cuda, "synchronize", late_fault)
    monkeypatch.setattr(evaluator, "probe_context", lambda device: None)
    res = svc._settle(EvalResult("ok", timings_us={"m": 1.0}))
    assert res.status == "runtime_error"
    assert "unspecified launch failure" in res.error
    assert svc.context_lost is None          # the probe found it usable


def test_probe_context_is_none_off_the_card():
    assert evaluator.probe_context("cpu") is None


# ---------------------------------------------------------------------------
# The kill soak: the cross-transport determinism contract
# ---------------------------------------------------------------------------
def _population(sci):
    return [(r.rid, r.parents, r.status, r.timings_us, r.source)
            for r in sci.population]


def test_soak_subprocess_kills_match_inprocess_population():
    """A subprocess campaign with >= 20% injected worker deaths finishes
    with the population of an uninterrupted in-process workers=1 run."""
    seed, gens = 5, 6
    ref = KernelScientist(
        llm=ScriptedLLM(seed=seed),
        backend=EvalPool.of(EchoService(), workers=1, cache=EvalCache(),
                            retry_policy=NO_WAIT_POLICY),
        retry_policy=NO_WAIT_POLICY)
    ref.run(gens)
    ref.pool.close()

    crashy = CrashService(EchoService(), seed=0, crash_rate=0.25)
    sub = KernelScientist(
        llm=ScriptedLLM(seed=seed),
        backend=EvalPool.of(crashy, workers=2, cache=EvalCache(),
                            retry_policy=NO_WAIT_POLICY,
                            transport="subprocess",
                            transport_options=FAST_SUB),
        retry_policy=NO_WAIT_POLICY)
    sub.run(gens)
    stats = sub.pool.stats()
    counts = sub.events.counts()
    sub.pool.close()

    assert len(sub.logbook) == gens          # zero aborted generations
    assert counts.get("worker_died", 0) > 0, \
        "the soak must actually exercise worker deaths"
    assert counts.get("worker_requeue", 0) >= counts["worker_died"] > 0
    assert stats["transport"] == "subprocess"
    assert _population(sub) == _population(ref)
