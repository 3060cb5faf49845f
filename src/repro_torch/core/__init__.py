"""The GPU Kernel Scientist on one NVIDIA H100 — an LLM-driven evolutionary
loop (Selector -> Designer -> 3x Writer -> pooled black-box Evaluation)
optimizing one complex accelerator kernel.

Port of ``repro.core``.  Not ported: the analytic TPU-v5e cost model
(``estimate_us``; every verdict here is a time measured on the card) and
the autotuner.

``__all__`` is the supported public surface, as in ``repro.core``.
"""
from .evalpool import (
    PRIORITY_CAMPAIGN, PRIORITY_PROBE, PRIORITY_URGENT,
    EvalBackend, EvalCache, EvalHandle, EvalPool,
)
from .evaluator import EvalResult, EvaluationService, PoisonedContextError
from .events import INTEGRITY_EVENTS, WORKER_LIFECYCLE_EVENTS, EventLog
from .genome import (
    SEED_LIBRARY, SEED_MONOLITH, SEED_MXU, SEED_NAIVE, KernelGenome,
)
from .integrity import (
    CanaryController, HealthMonitor, Integrity, Quarantine, TimingAuditor,
)
from .llm import HTTPChatLLM, LLMClient, ScriptedLLM
from .population import (
    BENCH_CONFIGS_6, BENCH_CONFIGS_18, KernelRecord, Population,
)
from .resilience import (
    DEFAULT_POLICY, NO_WAIT_POLICY, CircuitBreaker, CircuitOpenError,
    CorruptTimingService, CrashService, DriftService, FlakyLLM,
    FlakyService, PoisonService, RetryPolicy, ServiceBusyError,
    TransientError, retry_call,
)
from .scientist import GenerationLog, KernelScientist
from .transport import (
    InProcessTransport, RemoteEvalError, SubprocessTransport,
    WorkerDiedError, WorkerTransport,
)

__all__ = [
    # scientist loop
    "KernelScientist", "GenerationLog",
    # evaluation backend API
    "EvalBackend", "EvalPool", "EvalCache", "EvalHandle",
    "PRIORITY_URGENT", "PRIORITY_CAMPAIGN", "PRIORITY_PROBE",
    # transports
    "WorkerTransport", "InProcessTransport", "SubprocessTransport",
    "WorkerDiedError", "RemoteEvalError",
    # evaluation platform
    "EvaluationService", "EvalResult", "PoisonedContextError",
    # resilience
    "RetryPolicy", "retry_call", "DEFAULT_POLICY", "NO_WAIT_POLICY",
    "TransientError", "ServiceBusyError",
    "CircuitBreaker", "CircuitOpenError",
    "FlakyLLM", "FlakyService", "CrashService",
    "CorruptTimingService", "PoisonService", "DriftService",
    # verdict-trust layer
    "Integrity", "TimingAuditor", "Quarantine", "CanaryController",
    "HealthMonitor",
    # events
    "EventLog", "WORKER_LIFECYCLE_EVENTS", "INTEGRITY_EVENTS",
    # LLM clients
    "LLMClient", "ScriptedLLM", "HTTPChatLLM",
    # data model
    "KernelGenome", "KernelRecord", "Population",
    "BENCH_CONFIGS_6", "BENCH_CONFIGS_18",
    "SEED_LIBRARY", "SEED_NAIVE", "SEED_MXU", "SEED_MONOLITH",
]
