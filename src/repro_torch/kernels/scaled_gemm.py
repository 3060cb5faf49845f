"""Block-scaled GEMM for Hopper — the paper's target kernel, in CUDA C++.

Port of ``repro.kernels.scaled_gemm``.  ``C[bf16] = dequant(A[fp8]) @
dequant(B[fp8])`` with per-(1x128) scales for A and per-(128x128) scales
for B, f32 accumulation.  Both kernels live in ``csrc/scaled_gemm.cu``
(whose header note says what each replaces, what bounds it on the card
and how its design answers that); the genome's constants reach it as
``#define``s, and ``_build`` compiles it with nvcc for ``sm_90a``.

* :func:`scaled_gemm` (K3) — the blocked kernel as a library call, without
  split-K.  The Kernel Scientist's rendered modules launch the same kernel
  text (K1, ``core.codegen``).  The blocked kernel has two paths, chosen
  at compile time by :func:`wgmma_path`, the one path rule: 8-bit wgmma
  fed by a TMA ring for the genome family the campaign evolves, the
  mma.sync kernel for every other configuration.
* :func:`naive_scaled_gemm` (K4) — the single-block kernel that holds the
  whole problem in shared memory (K2 in ``core.codegen``).

Each has its plain PyTorch version here (:func:`blocked_reference`,
:func:`monolith_reference`), with the same numerics: the same rounding to
the compute dtype, the same scale point and the same split-K order.  A
wrapper takes the plain version only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises, and counts the launch in
``_build.LAUNCHES``.  The wrappers and the rendered modules load the
kernel library through :func:`load_library`, once per set of ``#define``s.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import SCALE_BLOCK, dequantize, full_f32_matmul

STORAGE_DTYPES = (torch.float8_e4m3fn, torch.int8)
COMPUTE_DTYPES = (torch.bfloat16, torch.float32)
OUT_DTYPES = (torch.bfloat16, torch.float32)


# The wgmma kernel's tiles: one, two or four 64x128 sub-tiles, which divide
# evenly between its one or two consumer warpgroups.
WGMMA_TILES = ((64, 128), (128, 128), (256, 128), (64, 256), (128, 256))
# Shared memory one H100 block may opt into (227 KB); the wgmma kernel's ring
# is as deep as fits in it, at most RING_MAX_STAGES stages of 128 K.
SMEM_OPTIN = 232448
RING_MAX_STAGES = 8
OUT_STAGING = 64 * 256   # bytes of output staging per consumer warpgroup


def wgmma_path(block_m: int, block_n: int, *, compute_bf16: bool,
               scale_acc: bool) -> bool:
    """The path rule, the only one: the blocked kernel multiplies the
    stored 8-bit values with wgmma, fed by a TMA ring, for the bf16 compute
    type under ``scale_acc`` with a tile of :data:`WGMMA_TILES`, at any
    ``block_k``, split, grid order and output type.  Every other blocked
    configuration runs the mma.sync kernel."""
    return compute_bf16 and scale_acc and (block_m, block_n) in WGMMA_TILES


def _stage_bytes(block_m: int, block_n: int) -> int:
    # one 128-K block of A, of B as it came and of B transposed, and the
    # stage's three 8-byte mbarriers
    return 128 * (block_m + 2 * block_n) + 24


def _fixed_bytes(block_m: int, block_n: int) -> int:
    # the output staging of one or two consumers, 1 KB of alignment
    consumers = 1 if (block_m, block_n) == (64, 128) else 2
    return consumers * OUT_STAGING + 1024


def ring_stages(block_m: int, block_n: int) -> int:
    """The wgmma kernel's ring depth: as many 128-K stages as fit beside
    the consumers' output staging, at most :data:`RING_MAX_STAGES`."""
    return min(RING_MAX_STAGES, (SMEM_OPTIN - _fixed_bytes(block_m, block_n))
               // _stage_bytes(block_m, block_n))


def smem_bytes(block_m: int, block_n: int, block_k: int, *,
               compute_bf16: bool, scale_acc: bool) -> int:
    """Dynamic shared memory one block of the blocked kernel asks for
    (``SMEM_BYTES`` in ``csrc/scaled_gemm.cu``, which the built library
    reports as ``sg_blocked_smem``).  The wgmma kernel: its ring, the
    consumers' output staging and 1 KB of alignment, whatever ``block_k``.
    The mma.sync kernel: the A and transposed B slabs of ``block_k`` in
    the compute dtype, each row padded (8 bf16 or 1 f32) against bank
    conflicts, plus the slab's scales."""
    if wgmma_path(block_m, block_n, compute_bf16=compute_bf16,
                  scale_acc=scale_acc):
        return (ring_stages(block_m, block_n) * _stage_bytes(block_m, block_n)
                + _fixed_bytes(block_m, block_n))
    esize, pad = (2, 8) if compute_bf16 else (4, 1)
    n_sub = block_k // SCALE_BLOCK
    return ((block_m + block_n) * (block_k + pad) * esize
            + (block_m * n_sub + n_sub * (block_n // SCALE_BLOCK)) * 4)


def blocked_defines(*, block_m: int = 128, block_n: int = 128,
                    block_k: int = 128, storage=torch.float8_e4m3fn,
                    compute_dtype=torch.bfloat16,
                    scale_application: str = "scale_acc",
                    grid_order: str = "mn", out_dtype=torch.bfloat16) -> dict:
    """The ``#define``s of one blocked configuration: the genome's constants,
    the path (``WGMMA_PATH``, by :func:`wgmma_path`) and, on the wgmma path,
    the ring's depth (``RING_STAGES``).  The kernel text takes both from
    here and has no rule of its own."""
    compute_bf16 = compute_dtype == torch.bfloat16
    scale_acc = scale_application == "scale_acc"
    path = wgmma_path(block_m, block_n, compute_bf16=compute_bf16,
                      scale_acc=scale_acc)
    defines = {
        "BLOCK_M": block_m, "BLOCK_N": block_n, "BLOCK_K": block_k,
        "STORAGE_INT8": int(storage == torch.int8),
        "COMPUTE_BF16": int(compute_bf16), "SCALE_ACC": int(scale_acc),
        "GRID_NM": int(grid_order == "nm"),
        "OUT_F32": int(out_dtype == torch.float32),
        "WGMMA_PATH": int(path),
    }
    if path:
        defines["RING_STAGES"] = ring_stages(block_m, block_n)
    return defines


def monolith_defines(storage=torch.float8_e4m3fn) -> dict:
    """The ``#define``s of the single-block kernel's library (which also
    holds the default blocked kernel, on the mma.sync path)."""
    return {"STORAGE_INT8": int(storage == torch.int8), "WGMMA_PATH": 0}


def with_defines(defines: dict, cuda: str) -> str:
    return "".join(f"#define {k} {v}\n" for k, v in defines.items()) + cuda


# The loaded library per set of #defines (and kernel text: a rendered module
# carries its own copy).  A call neither rebuilds nor hashes the kernel text;
# underneath, ``_build`` caches each build by sha256(source + flags).
_LIBRARIES: dict = {}


def load_library(defines: dict, cuda: str | None = None):
    """``cuda`` (``csrc/scaled_gemm.cu`` when None) built with ``defines``
    and loaded, once per process."""
    key = (frozenset(defines.items()), cuda)
    lib = _LIBRARIES.get(key)
    if lib is None:
        text = _build.read_csrc("scaled_gemm.cu") if cuda is None else cuda
        lib = _build.compile_source(with_defines(defines, text))
        _LIBRARIES[key] = lib
    return lib


def check_operands(a, b, a_scale, b_scale) -> tuple:
    """Validate the operand contract; returns (M, N, K)."""
    for name, t in (("a", a), ("b", b), ("a_scale", a_scale),
                    ("b_scale", b_scale)):
        if t.ndim != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a is on {a.device}")
    if a.dtype not in STORAGE_DTYPES or b.dtype != a.dtype:
        raise TypeError(f"storage dtypes must match and be one of "
                        f"{STORAGE_DTYPES}: got {a.dtype}, {b.dtype}")
    if a_scale.dtype != torch.float32 or b_scale.dtype != torch.float32:
        raise TypeError("scales must be float32")
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"inner dimensions differ: {a.shape} @ {b.shape}")
    if k % SCALE_BLOCK:
        raise ValueError(f"K={k} must divide by {SCALE_BLOCK}")
    kb, nb = k // SCALE_BLOCK, -(-n // SCALE_BLOCK)
    if tuple(a_scale.shape) != (m, kb) or tuple(b_scale.shape) != (kb, nb):
        raise ValueError(f"scale shapes {tuple(a_scale.shape)}, "
                         f"{tuple(b_scale.shape)} do not fit A {tuple(a.shape)}"
                         f" and B {tuple(b.shape)}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a.device}")
    if a.device.type == "cuda" and (a.data_ptr() % 16 or b.data_ptr() % 16):
        raise ValueError("A and B must start on a 16-byte boundary")
    return m, n, k


def blocked_reference(a, b, a_scale, b_scale, *, block_k: int,
                      k_split: int = 1, scale_application: str = "scale_acc",
                      compute_dtype=torch.bfloat16, out_dtype=torch.bfloat16):
    """Plain version of the blocked kernel, with its numerics: per 128-K
    sub-block, a dot of compute-dtype inputs accumulated in f32, scaled
    after the dot (``scale_acc``) or before it (``dequant_inputs``), added
    to the sum in K order; ``k_split`` slices of ``K / block_k / k_split``
    slabs each, whose f32 partials are summed over the slice axis."""
    k = a.shape[1]
    n = b.shape[1]
    a32, b32 = a.float(), b.float()
    a_s = a_scale.float()
    b_cols = b_scale.float().repeat_interleave(SCALE_BLOCK, 1)[:, :n]  # (K/128, N)
    subs = (k // block_k // k_split) * (block_k // SCALE_BLOCK)
    partials = []
    with full_f32_matmul():
        for s in range(k_split):
            acc = torch.zeros(a.shape[0], n, dtype=torch.float32, device=a.device)
            for j in range(s * subs, (s + 1) * subs):
                a_blk = a32[:, j * SCALE_BLOCK:(j + 1) * SCALE_BLOCK]
                b_blk = b32[j * SCALE_BLOCK:(j + 1) * SCALE_BLOCK]
                if scale_application == "dequant_inputs":
                    a_d = (a_blk * a_s[:, j:j + 1]).to(compute_dtype).float()
                    b_d = (b_blk * b_cols[j]).to(compute_dtype).float()
                    acc = acc + a_d @ b_d
                else:
                    part = (a_blk.to(compute_dtype).float()
                            @ b_blk.to(compute_dtype).float())
                    acc = acc + part * a_s[:, j:j + 1] * b_cols[j]
            partials.append(acc)
    if k_split > 1:
        return torch.stack(partials).sum(dim=0).to(out_dtype)
    return partials[0].to(out_dtype)


def monolith_reference(a, b, a_scale, b_scale, *, out_dtype=torch.bfloat16):
    """Plain version of the single-block kernel: f32 dequant, one f32 dot."""
    a32, b32 = dequantize(a, b, a_scale, b_scale)
    with full_f32_matmul():
        return (a32 @ b32).to(out_dtype)


def scaled_gemm(a, b, a_scale, b_scale, *, block_m: int = 128,
                block_n: int = 128, block_k: int = 128,
                grid_order: str = "mn", scale_application: str = "scale_acc",
                compute_dtype=torch.bfloat16, acc_dtype=torch.float32,
                out_dtype=torch.bfloat16):
    """Blocked, scale-fused GEMM (K3).

    M, N, K must divide by the block sizes and ``block_n``/``block_k`` by 128
    (the quantization block): ``ops.scaled_gemm`` pads arbitrary shapes
    first.  The default tiles are 128, which take the wgmma path; the JAX
    kernel's 256^3 tiles are eight 64x128 sub-tiles, more sums than the
    wgmma kernel's consumers hold, and more bf16 slabs than the mma.sync
    kernel's shared memory holds."""
    m, n, k = check_operands(a, b, a_scale, b_scale)
    if m % block_m or n % block_n or k % block_k:
        raise ValueError(f"shape {(m, n, k)} does not divide by blocks "
                         f"{(block_m, block_n, block_k)}")
    if block_m % 16 or block_n % SCALE_BLOCK or block_k % SCALE_BLOCK:
        raise ValueError("block_m must divide by 16 and block_n, block_k "
                         f"by {SCALE_BLOCK}")
    if grid_order not in ("mn", "nm"):
        raise ValueError(f"grid_order={grid_order!r}")
    if scale_application not in ("scale_acc", "dequant_inputs"):
        raise ValueError(f"scale_application={scale_application!r}")
    if compute_dtype not in COMPUTE_DTYPES or out_dtype not in OUT_DTYPES:
        raise TypeError(f"compute {compute_dtype} / out {out_dtype} "
                        "not supported")
    if acc_dtype != torch.float32:
        raise TypeError("the accumulator is float32")
    if a.device.type == "cpu":
        return blocked_reference(a, b, a_scale, b_scale, block_k=block_k,
                                 scale_application=scale_application,
                                 compute_dtype=compute_dtype,
                                 out_dtype=out_dtype)
    lib = load_library(blocked_defines(
        block_m=block_m, block_n=block_n, block_k=block_k, storage=a.dtype,
        compute_dtype=compute_dtype, scale_application=scale_application,
        grid_order=grid_order, out_dtype=out_dtype))
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    _build.launch("scaled_gemm", lib, "sg_blocked",
                  [a.data_ptr(), b.data_ptr(), a_scale.data_ptr(),
                   b_scale.data_ptr(), out.data_ptr()],
                  [m, n, k, k // block_k, 1], a.device)
    return out


def naive_scaled_gemm(a, b, a_scale, b_scale, *, out_dtype=torch.bfloat16):
    """The 'naive translation' seed as a library call (K4): one block holds
    the whole problem in shared memory, dequantizes in f32 and writes C.
    Beyond a few hundred KiB of operands the card refuses the launch
    (``_build.LaunchRefusedError``), as the TPU refuses it for VMEM."""
    m, n, k = check_operands(a, b, a_scale, b_scale)
    if out_dtype != torch.bfloat16:
        raise TypeError("the single-block kernel writes bfloat16")
    if a.device.type == "cpu":
        return monolith_reference(a, b, a_scale, b_scale, out_dtype=out_dtype)
    lib = load_library(monolith_defines(a.dtype))
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    _build.launch("naive_scaled_gemm", lib, "sg_monolith",
                  [a.data_ptr(), b.data_ptr(), a_scale.data_ptr(),
                   b_scale.data_ptr(), out.data_ptr()],
                  [m, n, k], a.device)
    return out
