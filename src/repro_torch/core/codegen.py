"""Genome -> self-contained kernel module source.

Port of ``repro.core.codegen``.  The Kernel Writer stage emits complete,
runnable module text (as the paper's writer emits complete HIP files).  The
EvaluationService ``exec``s this text — nothing else — so a hosted-LLM
writer that emits hand-crafted source flows through the identical path.

Every module defines:
  GENOME : json string (submission metadata)
  run(a, b, a_scale, b_scale) -> C[bf16]

The ``blocked`` and ``naive`` styles embed the CUDA C++ kernel text of
``csrc/scaled_gemm.cu`` (the same text the library kernels K3/K4 build, so
each kernel exists once) with the genome's constants as ``#define``s;
``WGMMA_PATH`` among them picks the blocked kernel by the one path rule,
``kernels.scaled_gemm.wgmma_path``.  Their ``run`` builds that text with
nvcc through ``kernels.scaled_gemm.load_library``, which keeps the loaded
library per set of ``#define``s (a call neither rebuilds nor hashes the
kernel text), so a compiler error or a refused launch (too much shared
memory) is a real platform compile error.  On CPU tensors ``run`` calls
the kernel's plain version with the same numerics.  The ``library`` style
dequantizes in f32 and calls ``torch.matmul``, as the JAX package leaves
that dot to XLA.
"""
from __future__ import annotations

import string

from ..kernels import _build
from .genome import KernelGenome

_HEADER = '''\
"""Auto-generated by the GPU Kernel Scientist writer.

$description
"""
GENOME = $genome_json

import torch
import torch.nn.functional as F

SCALE_BLOCK = 128


def _pad_axis(x, multiple, axis):
    pad = (-x.shape[axis]) % multiple
    if pad == 0:
        return x
    widths = [0, 0] * x.ndim
    widths[2 * (x.ndim - 1 - axis) + 1] = pad
    if x.dtype in (torch.float8_e4m3fn, torch.int8):  # pad the raw bytes
        return F.pad(x.view(torch.uint8), widths).view(x.dtype)
    return F.pad(x, widths)
'''

_LIBRARY_BODY = '''

def run(a, b, a_scale, b_scale):
    """Library path: full f32 dequantization, then one torch.matmul."""
    m, k = a.shape
    n = b.shape[1]
    a32 = a.float() * a_scale.float().repeat_interleave(SCALE_BLOCK, 1)[:, :k]
    b_s = b_scale.float().repeat_interleave(SCALE_BLOCK, 0)
    b32 = b.float() * b_s.repeat_interleave(SCALE_BLOCK, 1)[:k, :n]
    return torch.matmul(a32, b32).to(torch.bfloat16)
'''

_CUDA = """
CUDA_SOURCE = r'''$cuda'''
"""

_MONOLITH_BODY = '''
from repro_torch.kernels import _build
from repro_torch.kernels.scaled_gemm import (check_operands, load_library,
                                            monolith_defines,
                                            monolith_reference)


def run(a, b, a_scale, b_scale):
    """Single-block kernel: whole problem resident in shared memory."""
    m, n, k = check_operands(a, b, a_scale, b_scale)
    if a.device.type == "cpu":
        return monolith_reference(a, b, a_scale, b_scale)
    lib = load_library(monolith_defines(a.dtype), CUDA_SOURCE)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
    _build.launch("monolith", lib, "sg_monolith",
                  [a.data_ptr(), b.data_ptr(), a_scale.data_ptr(),
                   b_scale.data_ptr(), out.data_ptr()], [m, n, k], a.device)
    return out
'''

_BLOCKED_BODY = '''
from repro_torch.kernels import _build
from repro_torch.kernels.scaled_gemm import (blocked_defines,
                                            blocked_reference,
                                            check_operands, load_library)

BLOCK_M = $bm
BLOCK_N = $bn
BLOCK_K = $bk
K_SPLIT = $ks
COMPUTE_DTYPE = torch.$cdtype
ACC_DTYPE = torch.$adtype
OUT_DTYPE = torch.$odtype
GRID_ORDER = $grid_order
SCALE_APPLICATION = $scale_application


def kernel_defines(m, n, k, storage):
    """The #defines of the kernel this module builds for an (M, N, K)
    problem: the genome's blocks clamped to the (128-padded) problem dims,
    with the path and the ring's depth by kernels.scaled_gemm's rule."""
    return blocked_defines(block_m=min(BLOCK_M, -(-m // 128) * 128),
                           block_n=min(BLOCK_N, -(-n // 128) * 128),
                           block_k=min(BLOCK_K, -(-k // 128) * 128),
                           storage=storage, compute_dtype=COMPUTE_DTYPE,
                           scale_application=SCALE_APPLICATION,
                           grid_order=GRID_ORDER, out_dtype=OUT_DTYPE)


def run(a, b, a_scale, b_scale):
    m_in, n_in, k_in = check_operands(a, b, a_scale, b_scale)
    defines = kernel_defines(m_in, n_in, k_in, a.dtype)
    bm, bn, bk = defines["BLOCK_M"], defines["BLOCK_N"], defines["BLOCK_K"]
    # pad to block multiples; the wgmma kernel reads B past N as zeros and
    # writes no column past N, so there N is padded only to the 16 bytes a
    # TMA row stride needs
    n_pad = 16 if defines["WGMMA_PATH"] else bn
    a = _pad_axis(_pad_axis(a, bm, 0), bk, 1)
    b = _pad_axis(_pad_axis(b, bk, 0), n_pad, 1)
    a_scale = _pad_axis(_pad_axis(a_scale, bm, 0), bk // SCALE_BLOCK, 1)
    b_scale = _pad_axis(_pad_axis(b_scale, bk // SCALE_BLOCK, 0),
                        -(-b.shape[1] // SCALE_BLOCK), 1)
    m, k = a.shape
    n = b.shape[1]
    gk_total = k // bk
    ks = min(K_SPLIT, gk_total)
    # split-K slices must tile the K loop evenly; fall back when they cannot
    while gk_total % ks:
        ks -= 1
    if a.device.type == "cpu":
        out = blocked_reference(a, b, a_scale, b_scale, block_k=bk,
                                k_split=ks,
                                scale_application=SCALE_APPLICATION,
                                compute_dtype=COMPUTE_DTYPE,
                                out_dtype=OUT_DTYPE)
        return out[:m_in, :n_in]
    lib = load_library(defines, CUDA_SOURCE)
    if ks > 1:   # f32 partials, summed in slice order below (no atomics)
        out = torch.empty((ks, m, n), dtype=torch.float32, device=a.device)
    else:
        out = torch.empty((m, n), dtype=OUT_DTYPE, device=a.device)
    _build.launch("blocked_splitk" if ks > 1 else "blocked", lib, "sg_blocked",
                  [a.data_ptr(), b.data_ptr(), a_scale.data_ptr(),
                   b_scale.data_ptr(), out.data_ptr()],
                  [m, n, k, gk_total // ks, ks], a.device)
    if ks > 1:
        out = out.sum(dim=0).to(OUT_DTYPE)
    return out[:m_in, :n_in]
'''


def _cuda_text() -> str:
    cuda = _build.read_csrc("scaled_gemm.cu")
    if "'''" in cuda:
        raise ValueError("kernel source must not contain ''' (it is embedded "
                         "in a raw triple-quoted string)")
    return string.Template(_CUDA).substitute(cuda=cuda)


def render_source(genome: KernelGenome, description: str = "") -> str:
    header = string.Template(_HEADER).substitute(
        description=description or genome.describe(),
        genome_json=repr(genome.to_json()))
    if genome.style == "library":
        return header + _LIBRARY_BODY
    if genome.style == "naive":
        return header + _cuda_text() + _MONOLITH_BODY
    return header + _cuda_text() + string.Template(_BLOCKED_BODY).substitute(
        bm=genome.block_m,
        bn=genome.block_n,
        bk=genome.block_k,
        ks=genome.k_split,
        cdtype=genome.compute_dtype,
        adtype=genome.acc_dtype,
        odtype=genome.out_dtype,
        grid_order=repr(genome.grid_order),
        scale_application=repr(genome.scale_application),
    )


def load_kernel(source: str):
    """'Compile' submitted source text: exec in a fresh namespace and return
    (run, genome_json).  Raises on any syntax/runtime error — the
    EvaluationService converts that into platform compile-error feedback.
    The CUDA kernel inside is compiled on the first call of ``run``."""
    ns: dict = {}
    exec(compile(source, "<submitted-kernel>", "exec"), ns)
    run = ns.get("run")
    if run is None:
        raise ValueError("submission defines no run(a, b, a_scale, b_scale)")
    return run, ns.get("GENOME")
