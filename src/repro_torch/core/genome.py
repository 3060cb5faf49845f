"""KernelGenome — the typed search space the Kernel Scientist explores.

Port of ``repro.core.genome``.  The writer renders a genome into a module
that embeds the CUDA C++ kernel of ``csrc/scaled_gemm.cu`` with the
genome's constants as ``#define``s (see ``core.codegen``); the
EvaluationService compiles that **source text** with nvcc, so compile
errors and refused launches are black-box feedback as on the competition
platform.

Two changes from the TPU genome:

* ``dimension_semantics`` is gone: it told the TPU compiler which grid axes
  it may split across the cores of one chip, and Hopper has no such axis
  (every block of a grid may run on any SM).
* The legality check is the kernel's real shared-memory need per block
  (``smem_bytes``) against the card's opt-in limit, in place of the TPU's
  VMEM working set.

A blocked genome compiles to one of two kernels (``kernel_path``), by the
rule of ``kernels.scaled_gemm.wgmma_path``:

* ``wgmma`` — the family the campaign evolves from the MXU seed: the bf16
  compute type under ``scale_acc`` with a tile of one, two or four 64x128
  sub-tiles (64x128, 128x128, 256x128, 64x256, 128x256), at any
  ``block_k``, ``k_split``, grid order and output type.  TMA brings the
  raw fp8 (or int8) bytes into a ring as deep as fits; fp8 (or s8) wgmma
  multiplies them, and the scales are applied per 128-K block in
  registers.  Its shared memory does not depend on ``block_k``, which sets
  the split-K slicing.
* ``mma_sync`` — every other blocked genome: the f32 compute type (the
  naive seed), ``dequant_inputs``, and every other tile (192x128 among
  them).  One block per output tile stages bf16 or f32 slabs of
  ``block_k`` and multiplies them with mma.sync or FMAs.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any

from ..kernels import scaled_gemm as _sg

# H100 SXM data sheet (NVIDIA), dense rates.  Used only by the writer's
# napkin model (core.llm) and its findings text (core.knowledge): every
# verdict of the platform is a time measured on the card.
H100 = {
    "sms": 132,
    "bf16_flops": 989e12,
    "fp8_flops": 1979e12,
    "f32_flops": 67e12,
    "hbm_bytes_per_s": 3.35e12,
    "smem_per_block_optin": 232448,
}

SCALE_BLOCK = 128             # quantization block (AMD challenge spec)
MMA_M = 16                    # rows of one mma.sync tile


def smem_limit() -> int:
    """Dynamic shared memory a block may opt into on this process's card."""
    import torch
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(torch.cuda.current_device())
        return int(getattr(props, "shared_memory_per_block_optin",
                           _sg.SMEM_OPTIN))
    return _sg.SMEM_OPTIN


@dataclasses.dataclass(frozen=True)
class KernelGenome:
    """One point in the scaled-GEMM kernel design space."""

    style: str = "blocked"            # "library" | "naive" | "blocked"
    block_m: int = 256
    block_n: int = 256
    block_k: int = 256
    grid_order: str = "mn"            # outermost output axis: "mn" | "nm"
    scale_application: str = "scale_acc"   # | "dequant_inputs"
    compute_dtype: str = "bfloat16"   # tensor-core input dtype | "float32"
    acc_dtype: str = "float32"
    out_dtype: str = "bfloat16"
    # Beyond-paper axes added during hillclimbing:
    k_split: int = 1                  # split-K reduction factor (1 = off)

    # ----------------------------------------------------------------- utils
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "KernelGenome":
        return KernelGenome(**json.loads(s))

    def replace(self, **kw: Any) -> "KernelGenome":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------ validation
    def kernel_path(self) -> str:
        """Which blocked kernel this genome compiles to, ``wgmma`` or
        ``mma_sync`` (see the module docstring); ``""`` for the other
        styles."""
        if self.style != "blocked":
            return ""
        return "wgmma" if _sg.wgmma_path(**self._rule_args()) else "mma_sync"

    def smem_bytes(self) -> int:
        """Dynamic shared memory one block of the blocked kernel asks for
        (``SMEM_BYTES`` in ``csrc/scaled_gemm.cu``, by the formula of
        ``kernels.scaled_gemm.smem_bytes``): the wgmma path's ring and
        output staging, or the mma.sync path's padded slabs and their
        scales.  The sums live in registers.  The naive style holds the
        whole problem, which only the platform can check against the actual
        (M, K, N)."""
        if self.style != "blocked":
            return 0
        return _sg.smem_bytes(block_k=self.block_k, **self._rule_args())

    def _rule_args(self) -> dict:
        return dict(block_m=self.block_m, block_n=self.block_n,
                    compute_bf16=self.compute_dtype == "bfloat16",
                    scale_acc=self.scale_application == "scale_acc")

    def validate(self) -> list[str]:
        """Static (pre-submission) legality check.  Returns problem list; the
        EvaluationService independently rejects at compile/launch time, so
        an LLM writer that skips this check still gets platform feedback."""
        errs = []
        if self.style not in ("library", "naive", "blocked"):
            errs.append(f"unknown style {self.style!r}")
        if self.style == "blocked":
            for name, b in (("block_m", self.block_m), ("block_n", self.block_n),
                            ("block_k", self.block_k)):
                if b <= 0:
                    errs.append(f"{name}={b} must be positive")
            if self.block_m % MMA_M:
                errs.append(f"block_m={self.block_m} must divide by {MMA_M}")
            if self.block_k % SCALE_BLOCK:
                errs.append(f"block_k={self.block_k} must divide by {SCALE_BLOCK}")
            if self.block_n % SCALE_BLOCK:
                errs.append(f"block_n={self.block_n} must divide by {SCALE_BLOCK}")
            if not errs and self.smem_bytes() > smem_limit():
                errs.append(
                    f"shared memory {self.smem_bytes()} bytes per block exceeds "
                    f"the {smem_limit()} a block may use")
            if self.grid_order not in ("mn", "nm"):
                errs.append(f"grid_order={self.grid_order!r}")
            if self.scale_application not in ("scale_acc", "dequant_inputs"):
                errs.append(f"scale_application={self.scale_application!r}")
            if self.compute_dtype not in ("bfloat16", "float32"):
                errs.append(f"compute_dtype={self.compute_dtype!r}")
            if self.acc_dtype != "float32":
                errs.append(f"acc_dtype={self.acc_dtype!r}: the sum is float32")
            if self.out_dtype not in ("bfloat16", "float32"):
                errs.append(f"out_dtype={self.out_dtype!r}")
            if self.k_split < 1 or self.k_split > 16:
                errs.append(f"k_split={self.k_split} out of range [1, 16]")
        return errs

    # --------------------------------------------------------------- pretty
    def describe(self) -> str:
        if self.style == "library":
            return "library path: torch.matmul after full f32 dequantization"
        if self.style == "naive":
            return "naive: one CUDA block, whole problem in shared memory"
        return (
            f"blocked {self.block_m}x{self.block_n}x{self.block_k} "
            f"grid={self.grid_order} k_split={self.k_split} "
            f"scales={self.scale_application} mma={self.compute_dtype}"
        )


# Paper §3 seed set, for Hopper:
#  - the provided library implementation (paper: "basic PyTorch"),
#  - a direct translation: correct but unoptimized — f32 FMA math, per-tile
#    dequantization, minimal square tiles (paper: "~6x slower than PyTorch"),
#  - the first working tensor-core kernel (paper: "Matrix Cores gift").
SEED_LIBRARY = KernelGenome(style="library")
SEED_NAIVE = KernelGenome(
    style="blocked", block_m=128, block_n=128, block_k=128,
    compute_dtype="float32", scale_application="dequant_inputs",
)
SEED_MXU = KernelGenome(style="blocked", block_m=128, block_n=128, block_k=128)
# A single-block whole-problem kernel (refused at launch on real sizes —
# exercised by tests of the platform's compile-error feedback path).
SEED_MONOLITH = KernelGenome(style="naive")
