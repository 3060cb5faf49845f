"""EvaluationService — the black-box testing/benchmark platform (paper §3.4).

Port of ``repro.core.evaluator``.  It keeps the competition interface
constraints:
  * submissions are **source text**, compiled server-side; compile
    failures come back as feedback strings.  Here "compile" covers both
    loading the module and building its CUDA kernel with nvcc, and a launch
    the card refuses before it runs (more shared memory or threads than a
    block may have) — the Hopper form of the TPU's VMEM refusal;
  * numerical correctness is verified against a reference oracle before any
    timing is reported;
  * the only performance signal is end-to-end time per benchmark MxKxN
    configuration — no profiler;
  * submissions are processed **sequentially** ("good citizen", §3.4) — the
    service raises a typed ``ServiceBusyError`` on concurrent use.  Scaling
    comes from running *several* services behind ``core.evalpool.EvalPool``,
    never from violating the per-service contract.

Timing is wall clock on the service's device: one warm-up call, then the
minimum of three, with CUDA events on the card.  The JAX package's
analytic TPU-v5e model (``estimate_us``) is not ported: on the card every
verdict is a measured time.  The service runs on the card unless it is
given ``device="cpu"`` (the tests do so, at small configurations); without
a card and without that request it raises.

On the card a submission ends with ``torch.cuda.synchronize()``, so a
fault the card reports late lands on the source that caused it.  A kernel
that faults (an illegal address, a trap) leaves the process's CUDA context
unusable for every later launch, so after an execution error the service
launches a trivial op and synchronises (:func:`probe_context`).  If that
fails, the service keeps the reason in ``context_lost``: the faulting
source still gets its ``runtime_error`` verdict, but every later
``submit`` raises :class:`PoisonedContextError` instead of handing out
false ``runtime_error`` verdicts.  A subprocess worker
(``core.eval_worker``) reads ``context_lost`` after each verdict and exits;
in-process, the campaign has to stop, which is why LLM-written kernels go
through ``transport="subprocess"``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..kernels import _build, ref
from . import codegen
from .population import BENCH_CONFIGS_18, config_key
from .resilience import ServiceBusyError


# nvcc refused the source, or the card refused the launch before it ran
COMPILE_ERRORS = (_build.KernelBuildError, _build.LaunchRefusedError)


class PoisonedContextError(RuntimeError):
    """An earlier submission left this process's CUDA context unusable.

    Not a ``resilience.TransientError``: no retry in this process can
    succeed.  Evaluate submitted kernels with ``transport="subprocess"``,
    whose workers exit after such a fault and come back in a fresh
    process."""


def probe_context(device) -> Optional[str]:
    """Why ``device``'s CUDA context can take no more work, or ``None``:
    launches a trivial op and synchronises.  ``None`` off the card."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    try:
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize(device)
    except Exception as e:
        return f"{type(e).__name__}: {e}"
    return None


def resolve_device(device=None) -> torch.device:
    """The service's device: the card unless the caller names another."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the evaluation platform times kernels on "
                "the card; pass device='cpu' to run the plain versions")
        return torch.device("cuda")
    return torch.device(device)


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class EvalResult:
    # ok | compile_error | runtime_error | incorrect — platform verdicts —
    # plus pool-level outcomes worker_error (requeue budget exhausted) and
    # quarantined (content hash blacklisted by core.integrity.Quarantine)
    status: str
    error: str = ""
    timings_us: dict = dataclasses.field(default_factory=dict)


class EvaluationService:
    def __init__(self, device=None,
                 bench_configs=BENCH_CONFIGS_18,
                 correctness_config=(256, 256, 256),
                 noise: float = 0.0, seed: int = 0,
                 rtol: float = 0.06, latency_s: float = 0.0) -> None:
        self.device = resolve_device(device)
        self.bench_configs = tuple(tuple(c) for c in bench_configs)
        self.correctness_config = tuple(correctness_config)
        self.noise = noise
        self.seed = seed
        self.rtol = rtol
        self.latency_s = latency_s   # models the shared queue's service delay
        self.submissions = 0
        #: why this process's CUDA context is unusable, once a submitted
        #: kernel has faulted (see :func:`probe_context`)
        self.context_lost: Optional[str] = None
        self._lock = threading.Lock()
        # per-(config, seed) memo of problem tensors and the reference-oracle
        # output: computed once per service, not per submission
        self._memo: dict = {}

    # ------------------------------------------------------------------ api
    def submit(self, source: str) -> EvalResult:
        """Sequential black-box evaluation of one kernel source."""
        if not self._lock.acquire(blocking=False):
            raise ServiceBusyError(
                "EvaluationService is sequential-only (paper §3.4): a "
                "submission is already in flight")
        try:
            if self.context_lost:
                raise PoisonedContextError(
                    f"the CUDA context of {self.device} is unusable after an "
                    f"earlier submission faulted ({self.context_lost}); no "
                    "verdict from this process can be trusted: evaluate "
                    "submitted kernels with transport='subprocess'")
            self.submissions += 1
            if self.latency_s:
                time.sleep(self.latency_s)
            res = self._evaluate(source)
            if self.device.type == "cuda":
                res = self._settle(res)
            return res
        finally:
            self._lock.release()

    def clone(self) -> "EvaluationService":
        """An identically-configured independent worker (for ``EvalPool``).

        The clone shares the timing seed: benchmark jitter is keyed on
        ``(seed, sha256(source), config)``.  Workers that share one card
        disturb each other's wall-clock timings; time with one worker, or
        give each worker its own card."""
        return EvaluationService(
            device=self.device, bench_configs=self.bench_configs,
            correctness_config=self.correctness_config, noise=self.noise,
            seed=self.seed, rtol=self.rtol, latency_s=self.latency_s)

    def service_spec(self) -> dict:
        """JSON-serializable constructor spec (for a subprocess worker)."""
        return {"kind": "evaluation", "device": str(self.device),
                "bench_configs": [list(c) for c in self.bench_configs],
                "correctness_config": list(self.correctness_config),
                "noise": self.noise, "seed": self.seed, "rtol": self.rtol,
                "latency_s": self.latency_s}

    # ------------------------------------------------- resumable campaigns
    def state_dict(self) -> dict:
        """Counters to persist across a campaign restart (accounting only)."""
        return {"submissions": self.submissions}

    def load_state_dict(self, d: dict) -> None:
        self.submissions = d["submissions"]

    # ------------------------------------------------------------ internals
    def _settle(self, res: EvalResult) -> EvalResult:
        """End a submission on the card: synchronise, so that a late fault
        is this source's, and after an execution error probe the context."""
        try:
            torch.cuda.synchronize(self.device)
        except Exception as e:
            res = EvalResult("runtime_error",
                             f"{type(e).__name__} during execution: {e}")
        if res.status == "runtime_error":
            self.context_lost = probe_context(self.device)
        return res

    def _evaluate(self, source: str) -> EvalResult:
        # content address of the submission: benchmark jitter keys on it
        skey = hashlib.sha256(source.encode()).hexdigest()
        try:
            run, _ = codegen.load_kernel(source)
        except Exception as e:  # platform 'compile' feedback
            return EvalResult("compile_error", f"{type(e).__name__}: {e}")

        try:
            ok = self._check_correctness(run)
        except COMPILE_ERRORS as e:
            return EvalResult("compile_error", f"{type(e).__name__}: {e}")
        except Exception as e:
            # the kernel built but blew up while executing — a distinct
            # platform verdict (a tiling bug, not a syntax error)
            return EvalResult("runtime_error",
                              f"{type(e).__name__} during execution: {e}")
        if not ok:
            return EvalResult("incorrect",
                              "output mismatch vs reference oracle "
                              f"(rtol {self.rtol}) on "
                              f"{self.correctness_config}")

        timings = {}
        for cfg in self.bench_configs:
            try:
                t = self._time_wall(run, cfg)
            except COMPILE_ERRORS as e:
                return EvalResult("compile_error",
                                  f"{type(e).__name__} on {cfg}: {e}")
            except Exception as e:
                return EvalResult("runtime_error",
                                  f"{type(e).__name__} on {cfg}: {e}")
            timings[config_key(cfg)] = self._jitter(t, cfg, skey)
        return EvalResult("ok", timings_us=timings)

    def _problem(self, cfg, seed=0):
        """Quantized problem tensors for one config on the service's
        device, memoized per ``(config, seed)``.  The values are drawn as
        the JAX service draws them (f64 normals cast to f32)."""
        memo_key = ("problem", tuple(cfg), seed)
        if memo_key in self._memo:
            return self._memo[memo_key]
        m, n, k = cfg
        rng = np.random.default_rng(seed)
        a32 = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
        b32 = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
        aq, a_s = ref.quantize_blockwise(a32.to(self.device))
        bq, b_s = ref.quantize_blockwise_2d(b32.to(self.device))
        self._memo[memo_key] = (aq, bq, a_s, b_s)
        return self._memo[memo_key]

    def _oracle(self, cfg, seed) -> np.ndarray:
        """Reference-oracle output, memoized per ``(config, seed)``."""
        memo_key = ("oracle", tuple(cfg), seed)
        if memo_key in self._memo:
            return self._memo[memo_key]
        aq, bq, a_s, b_s = self._problem(cfg, seed=seed)
        want = ref.scaled_gemm(aq, bq, a_s, b_s).float().cpu().numpy()
        self._memo[memo_key] = want
        return want

    def _check_correctness(self, run) -> bool:
        m, n, k = self.correctness_config
        aq, bq, a_s, b_s = self._problem((m, n, k), seed=1234)
        want = self._oracle((m, n, k), seed=1234)
        got = run(aq, bq, a_s, b_s)
        got = got.float().cpu().numpy()   # waits for the device
        if got.shape != want.shape:
            return False
        scale = float(np.max(np.abs(want))) or 1.0
        return bool(np.max(np.abs(got - want)) <= self.rtol * scale)

    def _time_wall(self, run, cfg) -> float:
        """Microseconds of one call: warm-up, then the minimum of three."""
        args = self._problem(cfg)
        if self.device.type != "cuda":
            run(*args)
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                run(*args)
                best = min(best, time.perf_counter() - t0)
            return best * 1e6
        run(*args)
        torch.cuda.synchronize(self.device)
        best = float("inf")
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run(*args)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) * 1e3)
        return best

    def _jitter(self, t_us: float, cfg, source_key: str) -> float:
        """Deterministic benchmark noise, keyed on the submission's content
        address (``sha256(source)``): the reported timings are a pure
        function of (platform seed, source, config, measured time)."""
        if not self.noise:
            return t_us
        h = hashlib.sha256(
            f"{self.seed}:{source_key}:{cfg}".encode()).digest()
        u = int.from_bytes(h[:8], "big") / 2**64
        v = int.from_bytes(h[8:16], "big") / 2**64
        gauss = math.sqrt(-2 * math.log(max(u, 1e-12))) * math.cos(2 * math.pi * v)
        return t_us * math.exp(self.noise * gauss)
