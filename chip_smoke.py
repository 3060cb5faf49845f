#!/usr/bin/env python3
"""Drive the port's main path on one NVIDIA H100 and check every kernel.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit and no
result line:

1. Device: the card's name and power limit (``nvidia-smi``) and SM count.
2. Build: every kernel variant of phase 3, one ``nvcc`` per source, all at
   once; prints the build seconds.
3. ``_build.stream_ptr`` against ``torch.cuda.current_stream`` on two
   streams.  Kernels against their plain versions on the card, within
   ``0.02 * max|plain|`` (the JAX tests' tolerance): K1 (the rendered
   blocked module, split-K and not), K2 (the rendered single-block module),
   K3 (``kernels.scaled_gemm.scaled_gemm``), K4 (``naive_scaled_gemm``).
   Every K1/K3 case prints which blocked kernel its library holds (the
   library's ``sg_blocked_path``) and the dynamic shared memory its launch
   asks for (``sg_blocked_smem``) beside ``KernelGenome.smem_bytes()``,
   and fails if either differs from what the genome says.  On the wgmma
   path: the MXU seed at 1024x1536x7168, 1024x576x7168 (N not padded: the
   kernel masks the last tile) and 6144x7168x2048, every wgmma tile
   (64x128, 256x128, 64x256, 128x256), block_k 256 and 512, k_split 2, 4
   and 8 at 1024x512x7168, grid_order nm, int8 storage; on the mma.sync
   path the naive seed (f32 dequant_inputs), dequant_inputs in bf16 and
   192x128;
   K2 and K4 at 128x128x256, 256^3, 128x384x256 (M != N) and 256^3 with
   int8 storage, and K4 refused at 1024x1536x7168 (before any launch);
   K5 (``kernels.flash_attention.flash_attention``, bf16, (1, 16, 2, S, 128)
   for S in 128, 1000, 2048: causal, causal with window 256, unmasked; and
   at the edges of its 128-query and 64-key tiles: causal S = 1, 127, 129,
   1918 (also as the model's transposed (B, S, H, D) views) and 4096, S =
   2048 with window 2048 (the RG-LRU prefill's), GQA 1 (Hq = Hkv = 16,
   S = 333); at head dim 256, recurrentgemma-9b's (1, 16, 1, S, 256)
   through the model's transposed views, window 2048, S = 1, 127, 129,
   2047, 2049 and 3000) and
   K6 (``decode_attention``, bf16, 8 rows of a (8, 4096, 2, 128) cache read
   through its strides: ragged kv_len with 4096 and one above 4096, short
   ones from 1, and at the edges of its key split: lengths on and beside a
   split boundary, kv_len = 1 beside full rows, kv_len far above S,
   kv_len = 0 among live rows; at head dim 256, 8 rows of a (8, 2048, 1,
   256) ring with the newest key written at len % 2048, n_valid =
   min(len + 1, 2048) from 1 to 2048 with wrapped writes, and 256 keys a
   block refused by the card for its shared memory) and K7
   (``kernels.ssd.ssd``, H 80, P 64,
   N 128, x, B and C bf16, dt and A f32: B 1 S 1920 and B 1 S 1999
   (ragged) with the model's decay, A from -1 to -16, x, B and C read as
   views of one tensor as the model hands them over; B 2 S 1000 with a slow
   decay, dt * |A| in [1e-3, 1e-2] per token; at the kernel's chunk L:
   S = 1, L - 1 and L + 1, B 2 S 777, and a slow decay over S = 16L + 100,
   whose state crosses 17 chunks).  For K5, K6 and K7 the max is taken per
   output row (one batch, head and query; for K7's y one batch, token and
   head, for its final state one batch, head and state index): a row that
   averages thousands of keys is a few hundredths in size, and a scale
   set by the largest row of the output would let a lost key block or
   warp pass.  K7's rows whose plain maximum is below 1e-6 of the
   output's are skipped and counted; the slow-decay cases must also tell
   the final state apart from one that dropped the carry.  K6 with
   kv_len = 0 gives zeros, and K6, K7 and K5 and K6 at head dim 256 give
   the same bytes on two calls with the same inputs.
4. Main paths, each with the launch counts set to 0 just before it and
   read just after:
   a. the campaign: ``repro_torch.launch.scientist.run_campaign`` for 2
      generations with the ScriptedLLM, through one subprocess worker
      (``transport="subprocess"``), timed on the 18 challenge shapes at
      full size (K1, counted in the worker and reported with each
      verdict); the worker's spawns and the verdicts; each blocked
      genome's path and its µs per shape, and the library each of its 18
      shapes loaded (``sg_blocked_path``), which must be the one its rule
      gives and the one the worker built; then the verdict latency of
      three of its sources through a fresh worker and in this process;
   b. the platform's compile-error path: the single-block seed passes the
      256^3 correctness check and is refused at the first challenge shape
      (K2), the Hopper form of the TPU's VMEM refusal;
   c. the library calls: ``kernels.ops.scaled_gemm`` on the 18 challenge
      shapes (K3) and ``naive_scaled_gemm`` at the sizes it fits (K4),
      against the oracle ``kernels.ref.scaled_gemm``;
   d. serving: ``serve.Engine`` on qwen2.5-3b at full width and depth
      (36 layers, random bf16 weights from seed 0), 8 slots of 4096
      positions, 16 requests with prompt lengths drawn from
      ``numpy.random.default_rng(0)`` in [100, 2000] and 32 new tokens
      each; K5 must launch 36 times per prompt and K6 36 times per tick.
      After the counts are read, the first request and the last (which
      lands in a reused slot) are decoded again alone, ``api.prefill`` at
      batch 1 and then ``api.decode_step`` fed the engine's tokens: each
      engine token's logit may fall short of that run's largest by at
      most ``0.02 * max|logits|``.  Then two windows traced with
      torch.profiler (3 decode ticks of 8 slots, one prefill of the
      longest prompt) give the device's busy share and its top kernels,
      and the prefill's K5 time (K7's in f);
   e. the model on the card against the model on the CPU: qwen2.5-3b at
      full width with 2 layers, one set of bf16 weights, one 333-token
      prompt; the prefill's last-token logits and those of 4 decode steps
      (fed the CPU's greedy tokens) within ``0.02 * max|cpu|``;
   f. serving mamba2-2.7b as in d (64 layers, d 2560, 80 heads of 64,
      state 128) with the same traces; K7 must launch 64 times per prompt
      (decode is plain PyTorch).  The witness's replay decodes 8 rows,
      each the request's own cache, so that its GEMMs sum as the engine's
      do: random-weight mamba2 amplifies the other rounding of a batch-1
      GEMM far past the gate.  That the batch-1 replay parts from it by
      rounding alone is checked layer by layer: decoded side by side,
      layer 0's state may differ by one bf16 step of its max and layer
      1's by four (the deeper layers' and the batch-1 tokens' shortfall
      are printed);
   g. mamba2-2.7b on the card against the CPU, as in e;
   h. fault containment: a subprocess pool without a cache gets a good
      genome, a submitted kernel that writes 2^40 bytes past its output,
      the good genome again and a second one: the bad one must come back
      ``runtime_error``, its worker must exit and come back as
      incarnation 1, the others must be ``ok`` and this process's CUDA
      context must still work.  Then, in a child process (``chip_smoke.py
      --inprocess-fault-check``), one in-process ``EvaluationService``
      gets the bad source and a good one: the second must raise
      ``PoisonedContextError``;
   i. serving recurrentgemma-9b as in d (38 layers, d 4096, 16 heads of
      256 on one KV head, 12 local-attention layers with window 2048),
      with two more requests of about 3,000 tokens, past the window (K5's
      window mask, the ring's roll, K6 over a wrapped ring); K5 must
      launch 12 times per prompt and K6 12 times per tick; requests 0 and
      17 (a long one) are replayed alone as in d, and traced as in d;
   j. recurrentgemma-9b on the card against the CPU as in e, with one
      recurrent and one attention layer.
5. Times: each kernel and its plain version at one main-path shape, with
   CUDA events, beside the least time the card could take and one library
   call computing the same function: the library seed (f32 dequant +
   ``torch.matmul``) for K1-K4 (K1 and K3 also with their device time from
   torch.profiler, and K1's shapes with ``torch._scaled_mm`` given 1x128
   and 128x128 block scales, timed where the installation takes them and
   its refusal printed where it does not; a K1/K3 row's bound is at the
   peak of the tensor cores that multiply its inputs exactly: fp8 or int8
   for scale_acc, bf16 for dequant_inputs in bf16, f32 for the f32 compute
   type; K1b must be faster than the library seed),
   ``scaled_dot_product_attention`` for K5
   (at the longest prompt of 4d, and in a line of its own at the
   shortest) and K6 (at 4d's cache and final lengths, one launch per layer
   in turn, as a decode tick reads the cache; also at each key split it
   takes; K6 must be faster than SDPA on the card); K7 at the longest
   prompt of 4f, for which no library call exists, with each stage kernel's
   device time, and at each chunk L it builds for; K5 at head dim 256 at
   4i's longest prompt (SDPA given the window as a mask) and K6 at head
   dim 256 at 4i's rings and final lengths.  K5, K6 and SDPA are
   timed over 100 calls.  K5, K6, SDPA and K7 also get their device time
   per call from torch.profiler (``device_ms``): the event time of a short
   kernel includes the host's launch overhead.

The last two lines are the ``{"kernels": [...]}`` record and
``{"ok": true, "device": {...}}``.
"""
import copy
import ctypes
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

TOL = 0.02                  # x max|plain|, as tests/test_kernels_scaled_gemm.py
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
# dense tensor-core (and f32 FMA) peaks, same source
PEAK_OPS = {"float8_e4m3fn": 1979e12, "int8": 1979e12, "bfloat16": 989e12,
            "float32": 67e12}
CSRC = "src/repro_torch/csrc/scaled_gemm.cu"
FA_CSRC = "src/repro_torch/csrc/flash_attention.cu"
SSD_CSRC = "src/repro_torch/csrc/ssd.cu"
REPLACES = {
    "K1a": "src/repro/core/codegen.py:183",
    "K1b": "src/repro/core/codegen.py:204",
    "K2": "src/repro/core/codegen.py:79",
    "K3": "src/repro/kernels/scaled_gemm.py:145",
    "K4": "src/repro/kernels/scaled_gemm.py:182",
    "K5": "src/repro/kernels/flash_attention.py:128",
    "K6": "src/repro/kernels/flash_attention.py:232",
    "K7": "src/repro/kernels/ssd.py:77",
}
# the head-dim-256 instantiations of K5 and K6 (recurrentgemma-9b)
REPLACES["K5-D256"], REPLACES["K6-D256"] = REPLACES["K5"], REPLACES["K6"]
COUNTER = {"K1a": "blocked_splitk", "K1b": "blocked", "K2": "monolith",
           "K3": "scaled_gemm", "K4": "naive_scaled_gemm",
           "K5": "flash_attention", "K6": "decode_attention", "K7": "ssd",
           "K5-D256": "flash_attention", "K6-D256": "decode_attention"}
INPROCESS_CHECK = "--inprocess-fault-check"
SERVE = dict(slots=8, max_seq=4096, requests=16, max_new=32,
             prompt_lens=(100, 2000))
# 4i's traffic beyond SERVE's: prompts past recurrentgemma-9b's 2048-token
# window, the only ones that wrap its ring
LONG_PROMPTS = ((2900, 3100), (2900, 3100))
# 4h: the shapes a fault-containment submission is timed on
FAULT_CONFIGS = 3

# A submission as the LLM writer could send it: its CUDA kernel writes 2^40
# bytes past its output, far outside any allocation, so the card reports an
# illegal address on every run, and the CUDA context of the process that
# launched it is unusable from then on.
OOB_KERNEL = '''"""A kernel that writes 2^40 bytes past its output."""
import torch

from repro_torch.kernels import _build

GENOME = None
CUDA_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void oob_kernel(float* out) { out[(1ull << 40) / sizeof(float)] = 1.f; }
extern "C" int oob(void* out, void* stream) {
  oob_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((float*)out);
  return (int)cudaGetLastError();
}
extern "C" const char* sg_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
"""


def run(a, b, a_scale, b_scale):
    out = torch.zeros(a.shape[0], b.shape[1], dtype=torch.bfloat16,
                      device=a.device)
    _build.launch("oob", _build.compile_source(CUDA_SOURCE), "oob",
                  [out.data_ptr()], [], a.device)
    return out
'''


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = pathlib.Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root / "src"))
    from repro_torch.core import codegen
    from repro_torch.core.genome import (SEED_LIBRARY, SEED_MONOLITH,
                                         SEED_MXU, SEED_NAIVE)
    from repro_torch.core import NO_WAIT_POLICY, EvalPool, EventLog
    from repro_torch.core.evaluator import EvaluationService, probe_context
    from repro_torch.core.population import BENCH_CONFIGS_18
    import numpy as np
    from repro_torch import configs
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import scaled_gemm as sg
    from repro_torch.kernels import ssd
    from repro_torch.launch.scientist import report, run_campaign
    from repro_torch.models import api, rglru
    from repro_torch.serve import Engine, Request

    dev = torch.device("cuda")
    fp8, i8, bf16, f32 = (torch.float8_e4m3fn, torch.int8, torch.bfloat16,
                          torch.float32)

    # ---------------------------------------------------------- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    props = torch.cuda.get_device_properties(0)
    print(f"device: {props.name}, {props.multi_processor_count} SMs, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    def problem(m, n, k, dtype=fp8, seed=0):
        g = torch.Generator(device=dev).manual_seed(seed)
        a = torch.randn(m, k, generator=g, device=dev)
        b = torch.randn(k, n, generator=g, device=dev)
        aq, a_s = ref.quantize_blockwise(a, dtype)
        bq, b_s = ref.quantize_blockwise_2d(b, dtype)
        return aq, bq, a_s, b_s

    def module(genome):
        return codegen.load_kernel(codegen.render_source(genome))[0]

    def rel_err(got, want):
        want = want.float()
        return ((got.float() - want).abs().max()
                / (want.abs().max().clamp_min(1e-30))).item()

    # A K1/K3 case knows its genome and the #defines (and kernel text) its
    # call builds at a shape: load_library gives back the very library the
    # call launched, which phase 3 asks for its path and shared memory.
    @dataclasses.dataclass
    class Blocked:
        genome: object
        defines: object        # (m, n, k, storage) -> #defines
        cuda: object = None    # a rendered module's copy of the text

        def library(self, m, n, k, dtype):
            return sg.load_library(self.defines(m, n, k, dtype), self.cuda)

    def k3(**kw):
        def kernel(*p):
            return sg.scaled_gemm(*p, **kw)

        def plain(*p):
            return sg.blocked_reference(
                *p, block_k=kw.get("block_k", 128),
                scale_application=kw.get("scale_application", "scale_acc"),
                compute_dtype=kw.get("compute_dtype", bf16))
        genome = SEED_MXU.replace(
            **{f: kw[f] for f in ("block_m", "block_n", "block_k",
                                  "scale_application", "grid_order")
               if f in kw},
            compute_dtype=str(kw.get("compute_dtype", bf16))[6:])
        return kernel, plain, Blocked(
            genome, lambda m, n, k, dt: sg.blocked_defines(**kw, storage=dt))

    def k1(genome, ks):
        run = module(genome)

        def plain(a, b, a_s, b_s):
            return sg.blocked_reference(
                a, b, a_s, b_s, block_k=genome.block_k, k_split=ks,
                scale_application=genome.scale_application,
                compute_dtype=getattr(torch, genome.compute_dtype))
        return run, plain, Blocked(genome, run.__globals__["kernel_defines"],
                                   run.__globals__["CUDA_SOURCE"])

    mxu = SEED_MXU
    mxu_split4 = mxu.replace(k_split=4)
    n576, n512 = (1024, 576, 7168), (1024, 512, 7168)
    full = (6144, 7168, 2048)
    cases = [
        # the wgmma path: the MXU seed's family
        ("K1b", "MXU seed", *k1(mxu, 1), (1024, 1536, 7168), fp8),
        ("K1b", "MXU seed, N 576 (not padded)", *k1(mxu, 1), n576, fp8),
        ("K1b", "MXU seed, full size", *k1(mxu, 1), full, fp8),
        ("K1b", "64x128", *k1(mxu.replace(block_m=64), 1), n576, fp8),
        ("K1b", "256x128", *k1(mxu.replace(block_m=256), 1), n576, fp8),
        ("K1b", "64x256", *k1(mxu.replace(block_m=64, block_n=256), 1),
         n576, fp8),
        ("K1b", "128x256", *k1(mxu.replace(block_n=256), 1), n576, fp8),
        ("K1b", "block_k 256", *k1(mxu.replace(block_k=256), 1),
         (1024, 1536, 7168), fp8),
        ("K1b", "block_k 512", *k1(mxu.replace(block_k=512), 1), n576, fp8),
        ("K1b", "grid_order nm", *k1(mxu.replace(grid_order="nm"), 1), n576,
         fp8),
        ("K1b", "int8 storage", *k1(mxu, 1), (1024, 1536, 7168), i8),
        ("K1a", "k_split 2", *k1(mxu.replace(k_split=2), 2), n512, fp8),
        ("K1a", "k_split 4", *k1(mxu_split4, 4), n512, fp8),
        ("K1a", "k_split 8", *k1(mxu.replace(k_split=8), 8), n512, fp8),
        ("K1a", "k_split 4", *k1(mxu_split4, 4), (1024, 1536, 7168), fp8),
        # the mma.sync path
        ("K1b", "naive seed (f32, dequant_inputs)", *k1(SEED_NAIVE, 1),
         (1024, 1536, 7168), fp8),
        ("K1b", "dequant_inputs bf16",
         *k1(mxu.replace(scale_application="dequant_inputs"), 1),
         (6144, 4096, 512), fp8),
        ("K1b", "192x128 (three sub-tiles)", *k1(mxu.replace(block_m=192), 1),
         (1152, 640, 2048), fp8),
        ("K3", "128^3 scale_acc", *k3(), (256, 384, 512), fp8),
        ("K3", "128^3 scale_acc int8", *k3(), (256, 384, 512), i8),
        ("K3", "256x128x128", *k3(block_m=256), (512, 256, 384), fp8),
        ("K3", "grid_order nm", *k3(grid_order="nm"), (384, 256, 256), fp8),
        ("K3", "f32 dequant_inputs",
         *k3(compute_dtype=f32, scale_application="dequant_inputs"),
         (256, 256, 256), fp8),
        ("K3", "full size", *k3(), full, fp8),
    ]

    # ----------------------------------------------------------- 2. build
    # every library of phase 3's blocked cases, the single-block kernel's
    # two and the attention and SSD kernels
    cuda = _build.read_csrc("scaled_gemm.cu")
    sources = {sg.with_defines(blk.defines(m, n, k, dtype), cuda)
               for _, _, _, _, blk, (m, n, k), dtype in cases}
    sources |= {sg.with_defines(sg.monolith_defines(dt), cuda)
                for dt in (fp8, i8)}
    sources = (sorted(sources) + [_build.read_csrc("flash_attention.cu")]
               + [ssd.source(ch) for ch in ssd.CHUNKS])
    t0 = time.perf_counter()
    _build.build_many(sources)
    print(f"build: {len(sources)} sources with nvcc in parallel, "
          f"{time.perf_counter() - t0:.1f} s")

    # ----------------------------------------- 3. kernels vs plain versions
    # every launcher takes its stream from _build.stream_ptr, which reads a
    # private torch call: hold it to the public stream, on two streams
    for stream in (torch.cuda.current_stream(dev), torch.cuda.Stream(dev)):
        with torch.cuda.stream(stream):
            want = torch.cuda.current_stream(dev).cuda_stream
            got = (_build.stream_ptr(dev), _build.stream_ptr(torch.device(
                "cuda", torch.cuda.current_device())))
            if got != (want, want):
                fail(f"stream_ptr gave {got}, the current stream is {want}")
    print("stream_ptr: the current stream's handle, on two streams")

    def path_of(lib):
        """Which blocked kernel a scaled_gemm.cu library holds."""
        fn = lib.sg_blocked_path
        fn.argtypes, fn.restype = [], ctypes.c_int
        return "wgmma" if fn() else "mma_sync"

    def smem_of(lib):
        """The dynamic shared memory its blocked kernel's launch asks for."""
        fn = lib.sg_blocked_smem
        fn.argtypes, fn.restype = [], ctypes.c_int
        return fn()

    for name, run in (("K2", module(SEED_MONOLITH)),
                      ("K4", sg.naive_scaled_gemm)):
        cases += [(name, "single block", run, sg.monolith_reference, None,
                   shape, fp8) for shape in ((128, 128, 256), (256, 256, 256))]
        cases += [(name, "single block, M != N", run, sg.monolith_reference,
                   None, (128, 384, 256), fp8),
                  (name, "single block, int8", run, sg.monolith_reference,
                   None, (256, 256, 256), i8)]
    worst = {}
    for name, what, kernel, plain, blk, (m, n, k), dtype in cases:
        p = problem(m, n, k, dtype)
        before = sum(_build.LAUNCHES.values())
        got = kernel(*p)
        torch.cuda.synchronize()
        launched = sum(_build.LAUNCHES.values()) - before
        want = plain(*p)
        err = rel_err(got, want)
        worst[name] = max(worst.get(name, 0.0), err)
        line = (f"{name} {what:34s} M,N,K={m},{n},{k} {str(dtype)[6:]:13s} "
                f"max_abs_err/max|plain| {err:.2e} launches {launched}")
        if blk is not None:
            lib = blk.library(m, n, k, dtype)
            path, smem = path_of(lib), smem_of(lib)
            line += (f" | {path} path, sg_blocked_smem {smem}, smem_bytes() "
                     f"{blk.genome.smem_bytes()}")
        print(line)
        if launched != 1:
            fail(f"{name} {what}: {launched} launches, expected 1")
        if not err <= TOL:
            fail(f"{name} {what}: error {err:.3e} above {TOL}")
        if blk is not None and (path, smem) != (blk.genome.kernel_path(),
                                                blk.genome.smem_bytes()):
            fail(f"{name} {what}: the library runs the {path} path with "
                 f"{smem} bytes; the genome says {blk.genome.kernel_path()} "
                 f"with {blk.genome.smem_bytes()}")
    p = problem(1024, 1536, 7168)
    try:
        sg.naive_scaled_gemm(*p)
        torch.cuda.synchronize()
        fail("K4 at 1024x1536x7168 was not refused")
    except _build.LaunchRefusedError as e:
        print(f"K4 at M,N,K=1024,1536,7168 refused as expected: {e}")

    def row_err(got, want):
        """Worst output row (one batch, head and query) of the attention
        kernels: max over D of |got - plain| over max over D of |plain|."""
        want = want.float()
        err = (got.float() - want).abs().amax(-1)
        return (err / want.abs().amax(-1).clamp_min(1e-30)).max().item()

    def attn_inputs(b, hq, hkv, s, d, seed, views=False):
        """q, k, v; with ``views`` as the model hands them over: (B, S, H,
        D) tensors transposed to (B, H, S, D)."""
        g = torch.Generator(device=dev).manual_seed(seed)
        if views:
            return [torch.randn(b, s, h, d, generator=g, device=dev).to(bf16)
                    .transpose(1, 2) for h in (hq, hkv, hkv)]
        return [torch.randn(shape, generator=g, device=dev).to(bf16)
                for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d))]

    def cache_inputs(lens, seed, smax=4096):
        """q (B, 16, 128) and a (B, Smax, 2, 128) cache as the engine keeps
        it, handed to K6 as (B, Hkv, S, D) views; kv_len int32."""
        g = torch.Generator(device=dev).manual_seed(seed)
        b = len(lens)
        ck, cv = (torch.randn(b, smax, 2, 128, generator=g, device=dev).to(bf16)
                  for _ in range(2))
        q = torch.randn(b, 16, 128, generator=g, device=dev).to(bf16)
        return (q, ck.transpose(1, 2), cv.transpose(1, 2),
                torch.tensor(lens, dtype=torch.int32, device=dev))

    attn_cases = []
    for s_len in (128, 1000, 2048):
        for causal, window in ((True, None), (True, 256), (False, None)):
            attn_cases.append((
                "K5", f"S={s_len} causal={causal} window={window}",
                lambda q, k, v, c=causal, w=window: fa.flash_attention(
                    q, k, v, causal=c, window=w),
                lambda q, k, v, c=causal, w=window: fa.attention_reference(
                    q, k, v, causal=c, window=w),
                attn_inputs(1, 16, 2, s_len, 128, s_len)))
    # the edges of K5's tiles (128 queries, 64 keys), the phase-5 shape, the
    # cache length, the RG-LRU prefill's window, and GQA 1
    for what, hq, hkv, s_len, window, views in (
            ("S=1 causal", 16, 2, 1, None, False),
            ("S=127 causal", 16, 2, 127, None, False),
            ("S=129 causal", 16, 2, 129, None, False),
            ("S=1918 causal", 16, 2, 1918, None, False),
            ("S=1918 causal, (B,S,H,D) views", 16, 2, 1918, None, True),
            ("S=4096 causal", 16, 2, 4096, None, False),
            ("S=2048 causal window=2048", 16, 2, 2048, 2048, False),
            ("Hq=Hkv=16 S=333 causal", 16, 16, 333, None, False)):
        attn_cases.append((
            "K5", what,
            lambda q, k, v, w=window: fa.flash_attention(q, k, v, window=w),
            lambda q, k, v, w=window: fa.attention_reference(q, k, v,
                                                             window=w),
            attn_inputs(1, hq, hkv, s_len, 128, s_len + 1, views)))
    attn_cases.append((
        "K6", "B=8 Smax=4096 kv_len ragged", fa.decode_attention,
        fa.decode_attention_reference,
        cache_inputs([4096, 4100, 1718, 218, 2704, 1272, 1991, 64], 1)))
    attn_cases.append((
        "K6", "B=8 Smax=4096 kv_len short", fa.decode_attention,
        fa.decode_attention_reference,
        cache_inputs([1, 2, 3, 5, 31, 32, 33, 63], 5)))
    # K6's split edges: lengths on and beside a split boundary, kv_len = 1
    # beside full rows (its row's other splits are empty), kv_len above S,
    # kv_len = 0 among live rows (a zero row: any other value fails it)
    sp = fa.DECODE_SPLIT
    for what, lens in (
            ("kv_len on split boundaries",
             [sp, 2 * sp, 3 * sp, sp + 1, 2 * sp - 1, 4096 - sp, 4095, 4096]),
            ("kv_len 1 beside full rows",
             [1, 4096, 1, 4096, 2, 4096, 1, 4096]),
            ("kv_len above S", [4097, 5000, 70000, 4096, 1, 2 * sp, 8191,
                                2**31 - 1]),
            ("kv_len 0 among live rows", [0, 4096, 0, 1, sp, 0, 777, 0])):
        attn_cases.append(("K6", f"B=8 Smax=4096 {what}", fa.decode_attention,
                           fa.decode_attention_reference,
                           cache_inputs(lens, 6)))
    # K5 and K6 at head dim 256 (recurrentgemma-9b: 16 query heads on one
    # KV head).  K5 at the edges of its 64-query and 64-key tiles and of
    # the 2048-token window, read through the model's transposed views.
    for s_len in (1, 127, 129, 2047, 2049, 3000):
        attn_cases.append((
            "K5-D256", f"S={s_len} window=2048 group 16, views",
            lambda q, k, v: fa.flash_attention(q, k, v, window=2048),
            lambda q, k, v: fa.attention_reference(q, k, v, window=2048),
            attn_inputs(1, 16, 1, s_len, 256, s_len + 7, views=True)))

    def ring_inputs(lens, seed, window=2048):
        """q (B, 16, 256) and a (B, W, 1, 256) ring as the rglru engine
        keeps it, the key and value of position len written at slot
        len % W as its decode writes them; K6 gets the ring's transposed
        views and n_valid = min(len + 1, W), as the model hands them."""
        g = torch.Generator(device=dev).manual_seed(seed)
        b = len(lens)
        ck, cv = (torch.randn(b, window, 1, 256, generator=g, device=dev)
                  .to(bf16) for _ in range(2))
        q = torch.randn(b, 16, 256, generator=g, device=dev).to(bf16)
        kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        rows, slot = torch.arange(b, device=dev), kv_len % window
        for c in (ck, cv):
            c[rows, slot] = 4 * torch.randn(b, 1, 256, generator=g,
                                            device=dev).to(bf16)
        return (q, ck.transpose(1, 2), cv.transpose(1, 2),
                torch.clamp(kv_len + 1, max=window))

    for what, lens in (
            ("n_valid 1", [0] * 8),
            ("n_valid 1 to 2048, wrapped writes",
             [0, 2047, 2048 + 37, 9000, 1, 100, 4095, 2048])):
        attn_cases.append(("K6-D256", f"B=8 ring of 2048 {what}",
                           fa.decode_attention, fa.decode_attention_reference,
                           ring_inputs(lens, 8)))
    for name, what, kernel, plain, args in attn_cases:
        before = sum(_build.LAUNCHES.values())
        got = kernel(*args)
        torch.cuda.synchronize()
        launched = sum(_build.LAUNCHES.values()) - before
        err = row_err(got, plain(*args))
        worst[name] = max(worst.get(name, 0.0), err)
        print(f"{name} {what:34s} bf16 worst row max_abs_err/max|plain| "
              f"{err:.2e} launches {launched}")
        if launched != 1:
            fail(f"{name} {what}: {launched} launches, expected 1")
        if not err <= TOL:
            fail(f"{name} {what}: error {err:.3e} above {TOL}")
    q, k, v, lens = cache_inputs([0, 7], 2)
    if fa.decode_attention(q, k, v, lens)[0].any():
        fail("K6 with kv_len = 0 did not give zeros")
    # two calls on the same inputs give the same bytes (no reduction order
    # set by which block finishes first)
    for name, what, kernel, plain, args in attn_cases:
        if what not in ("B=8 Smax=4096 kv_len on split boundaries",
                        "S=3000 window=2048 group 16, views",
                        "B=8 ring of 2048 n_valid 1 to 2048, wrapped writes"):
            continue
        first, second = kernel(*args), kernel(*args)
        torch.cuda.synchronize()
        if not torch.equal(first.view(torch.int16), second.view(torch.int16)):
            fail(f"{name} {what}: two calls on the same inputs differ")
    print("K6: kv_len = 0 gives zeros; K6, K5-D256 and K6-D256: two calls "
          "give the same bytes")
    # at head dim 256 a block of 256 keys would need more shared memory
    # than a block may have: the card refuses it, and K6 splits by 128
    q, k, v, lens = ring_inputs([5, 2047], 9)
    try:
        fa.decode_at_split(q, k, v, lens, 256)
        torch.cuda.synchronize()
        fail("K6 at D=256 with 256 keys a block was not refused")
    except _build.LaunchRefusedError as e:
        print(f"K6 at D=256, 256 keys a block "
              f"({fa.decode_smem_bytes(256, 256)} bytes of shared memory) "
              f"refused as expected: {e}; it runs at "
              f"{fa.decode_split(256)} keys a block "
              f"({fa.decode_smem_bytes(256, fa.decode_split(256))} bytes)")

    def ssd_row_err(got, want, what):
        """Worst row of an SSD output (y: one batch, token and head; the
        state: one batch, head and state index): max over P of
        |got - plain| over max over P of |plain|.  Rows whose plain
        maximum is below 1e-6 of the output's are skipped and counted."""
        want = want.float()
        den = want.abs().amax(-1)
        keep = den >= 1e-6 * den.max()
        err = (got.float() - want).abs().amax(-1) / den.clamp_min(1e-30)
        skipped = int((~keep).sum())
        if skipped:
            print(f"K7 {what}: {skipped} of {keep.numel()} rows skipped "
                  "(plain max below 1e-6 of the output's)")
        return err[keep].max().item()

    def ssd_inputs(bsz, s, seed, slow=False, view=True):
        """H 80, P 64, N 128.  With ``view``, x, B and C are views into one
        (B, S, H*P + 2N) tensor, the layout the model hands K7.  The
        model's decay: A from -1 to -16, dt = softplus(N(0, 1)); slow:
        dt * |A| in [1e-3, 1e-2] per token."""
        g = torch.Generator(device=dev).manual_seed(seed)
        h, p, n = 80, 64, 128
        if view:
            xbc = torch.randn(bsz, s, h * p + 2 * n, generator=g,
                              device=dev).to(bf16)
            x = xbc[..., :h * p].reshape(bsz, s, h, p)
            b, c = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
        else:
            x = torch.randn(bsz, s, h, p, generator=g, device=dev).to(bf16)
            b, c = (torch.randn(bsz, s, n, generator=g, device=dev).to(bf16)
                    for _ in range(2))
        if slow:
            a = -torch.linspace(2e-3, 1e-2, h, device=dev)
            dt = torch.rand(bsz, s, h, generator=g, device=dev) * 0.5 + 0.5
        else:
            a = -torch.linspace(1.0, 16.0, h, device=dev)
            dt = torch.nn.functional.softplus(
                torch.randn(bsz, s, h, generator=g, device=dev))
        return x, dt, a, b, c

    L = ssd.CHUNK
    ssd_cases = [("B=1 S=1920 model decay", ssd_inputs(1, 1920, 7)),
                 ("B=1 S=1999 ragged", ssd_inputs(1, 1999, 8)),
                 ("B=2 S=1000 slow decay", ssd_inputs(2, 1000, 9, slow=True,
                                                      view=False)),
                 # the edges of K7's chunk, batch 2, and a slow decay whose
                 # state crosses 16 chunks
                 ("B=1 S=1", ssd_inputs(1, 1, 11)),
                 (f"B=1 S=L-1={L - 1}", ssd_inputs(1, L - 1, 12)),
                 (f"B=1 S=L+1={L + 1}", ssd_inputs(1, L + 1, 13)),
                 ("B=2 S=777 model decay", ssd_inputs(2, 777, 14)),
                 (f"B=1 S=16L+100={16 * L + 100} slow decay",
                  ssd_inputs(1, 16 * L + 100, 15, slow=True))]
    for what, args in ssd_cases:
        before = sum(_build.LAUNCHES.values())
        y, st = ssd.ssd(*args)
        torch.cuda.synchronize()
        launched = sum(_build.LAUNCHES.values()) - before
        y_want, st_want = ssd.ssd_reference(*args)
        y_err = ssd_row_err(y, y_want, what + " y")
        st_err = ssd_row_err(st, st_want, what + " state")
        worst["K7"] = max(worst.get("K7", 0.0), y_err, st_err)
        print(f"K7 {what:34s} worst row max_abs_err/max|plain|: y {y_err:.2e}"
              f", final state {st_err:.2e}; launches {launched}")
        if launched != 1:
            fail(f"K7 {what}: {launched} launches, expected 1")
        if not (y_err <= TOL and st_err <= TOL):
            fail(f"K7 {what}: error y {y_err:.3e}, state {st_err:.3e} "
                 f"above {TOL}")
    # the last chunk's tokens alone: the final state a scan would give that
    # dropped the carry, which the slow-decay cases must tell apart
    for case in (ssd_cases[2], ssd_cases[-1]):
        x, dt, a, b, c = case[1]
        tail = [v[:, -ssd.CHUNK:] for v in (x, dt, b, c)]
        lost = ssd_row_err(ssd.ssd_reference(*tail[:2], a, *tail[2:])[1],
                           ssd.ssd_reference(x, dt, a, b, c)[1], "no carry")
        print(f"K7 {case[0]}: a scan that dropped the carry would miss the "
              f"final state by {lost:.2e} of a row (the gate is {TOL})")
        if not lost > 10 * TOL:
            fail(f"K7 {case[0]} does not hold the carry to account")
    args = ssd_cases[1][1]
    (y1, st1), (y2, st2) = ssd.ssd(*args), ssd.ssd(*args)
    torch.cuda.synchronize()
    if not (torch.equal(y1.view(torch.int16), y2.view(torch.int16))
            and torch.equal(st1.view(torch.int32), st2.view(torch.int32))):
        fail("K7: two calls on the same inputs differ")
    print("K7: two calls give the same bytes (y and the final state)")
    print("kernels: " + ", ".join(f"{n} (max err {e:.2e})"
                                  for n, e in worst.items()))

    # ------------------------------------------------------ 4a. campaign
    # through one subprocess worker, as the launcher runs it: the kernels
    # launch in the worker, whose counts come back with each verdict
    # (``SubprocessTransport.launches``); this process launches none
    so_before = set(_build.BUILD_DIR.glob("*.so"))
    _build.reset_launches()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as wd:
        sci = run_campaign(2, wd, seed=0, workers=1, transport="subprocess",
                           job_timeout_s=600)
        sci.pool.close()
    events = sci.events.records
    campaign_launches = dict(sci.pool.transport.launches)
    print(f"campaign: {time.perf_counter() - t0:.1f} s through "
          f"{sci.pool.stats()['transport']} workers; launches reported by "
          f"the worker {campaign_launches}, by this process "
          f"{dict(_build.LAUNCHES)}")
    print("campaign: worker spawns (incarnation, pid) " + str(
        [(e["incarnation"], e["pid"]) for e in events
         if e.get("event") == "worker_spawn"]) + "; verdicts " + " ".join(
        f"{e['rid']}:{e['status']}" for e in events
        if e.get("event") == "eval_result"))
    if sci.pool.stats()["transport"] != "subprocess" or _build.LAUNCHES:
        fail("the campaign did not run its kernels in a subprocess worker")
    for line in report(sci):
        print("  " + line)
    recs = list(sci.population)
    by_rid = {r.rid: r for r in recs}
    seeds = {r.genome.style if r.genome.style != "blocked" else
             ("naive" if r.genome == SEED_NAIVE else "mxu"): r
             for r in recs if r.generation == 0}
    for label in ("library", "naive", "mxu"):
        if seeds[label].status != "ok":
            fail(f"{label} seed is {seeds[label].status}: {seeds[label].error}")
    writers_ok = [r for r in recs if r.generation > 0 and r.status == "ok"]
    if not writers_ok:
        fail("no writer kernel is ok")
    for r in recs:
        if (r.genome is not None and not r.genome.validate()
                and r.status == "compile_error"):
            fail(f"{r.rid} passed validate() but came back compile_error: "
                 f"{r.error}")
    computed = [e for e in events if e.get("event") == "eval_result"
                and not e.get("cached") and e.get("status") == "ok"
                and by_rid[e["rid"]].genome is not None
                and by_rid[e["rid"]].genome.style == "blocked"]
    k1_launches = (campaign_launches.get("blocked", 0)
                   + campaign_launches.get("blocked_splitk", 0))
    need = 73 * len(computed)   # 1 correctness run + 18 shapes x 4 runs
    print(f"K1 launches {k1_launches} for {len(computed)} ok blocked "
          f"verdicts computed by the platform (need >= {need})")
    if k1_launches < need:
        fail(f"K1 launched {k1_launches} times, expected >= {need}")
    lib, best = seeds["library"], sci.population.best()
    print(f"best {best.rid} geomean {best.score:.1f} us vs library seed "
          f"{lib.score:.1f} us | {best.genome.describe()}")
    print("eval seconds per submission: " + ", ".join(
        f"{e['rid']}={e['duration_s']:.2f}{' (cached)' if e['cached'] else ''}"
        for e in events if e.get("event") == "eval_result"))
    for label, r in (("library", lib), ("mxu", seeds["mxu"]), ("best", best)):
        print(f"us per shape, {label} {r.rid}: " + " ".join(
            f"{key}={t:.1f}" for key, t in r.timings_us.items()))
    # Each blocked genome's path by its rule, and the path of the library
    # that each of its 18 shapes loaded: loading the same #defines and text
    # here must find on disk the library the worker built, and build none.
    on_disk = set(_build.BUILD_DIR.glob("*.so"))
    for r in recs:
        if r.genome is None or r.genome.style != "blocked":
            continue
        rule = r.genome.kernel_path()
        took = set()
        if r.status == "ok":
            run = module(r.genome)
            took = {path_of(sg.load_library(
                run.__globals__["kernel_defines"](*cfg, fp8),
                run.__globals__["CUDA_SOURCE"])) for cfg in BENCH_CONFIGS_18}
        print(f"  {r.rid} {rule} path, launched {'+'.join(sorted(took)) or '-'}"
              f" ({r.status}) | {r.genome.describe()}: " + " ".join(
                  f"{key}={t:.1f}" for key, t in r.timings_us.items()))
        if r.status == "ok" and took != {rule}:
            fail(f"{r.rid}: its rule gives the {rule} path, its libraries "
                 f"hold {sorted(took)}")
    if set(_build.BUILD_DIR.glob("*.so")) != on_disk:
        fail("a blocked genome's library was not the one the worker built")
    print(f"campaign: the worker built {len(on_disk - so_before)} libraries")
    if seeds["mxu"].genome.kernel_path() != "wgmma":
        fail("the MXU seed is not on the wgmma path")
    path_launches = {n: campaign_launches.get(COUNTER[n], 0)
                     for n in ("K1a", "K1b")}

    # verdict latency: three of the campaign's sources, their libraries on
    # disk, through a fresh subprocess worker and in this process; the
    # worker's first verdict includes its start (torch import, CUDA
    # context, the problem tensors)
    latency = {}
    for transport in ("subprocess", "inprocess"):
        pool = EvalPool.of(EvaluationService(seed=0), transport=transport,
                           retry_policy=NO_WAIT_POLICY)
        latency[transport] = []
        for r in (lib, seeds["mxu"], best):
            t0 = time.perf_counter()
            res = pool.submit_async(r.source).result(timeout=600)
            latency[transport].append(time.perf_counter() - t0)
            if res.status != "ok":
                fail(f"{transport}: {r.rid} came back {res.status}")
        pool.close()
    print("verdict latency, s per submission (library seed, MXU seed, "
          "best): " + "; ".join(f"{t} " + " ".join(f"{x:.2f}" for x in ts)
                                for t, ts in latency.items()))

    # ------------------------------------- 4b. platform compile-error path
    _build.reset_launches()
    svc = EvaluationService(bench_configs=BENCH_CONFIGS_18[:1])
    res = svc.submit(codegen.render_source(SEED_MONOLITH))
    path_launches["K2"] = _build.LAUNCHES[COUNTER["K2"]]
    print(f"single-block seed: {res.status} ({res.error[:120]}), "
          f"K2 launches {path_launches['K2']}")
    if res.status != "compile_error" or path_launches["K2"] != 1:
        fail("the single-block seed must pass at 256^3 and be refused at "
             "challenge size")

    # -------------------------------------------------- 4c. library calls
    _build.reset_launches()
    for cfg in BENCH_CONFIGS_18:
        p = problem(*cfg)
        err = rel_err(ops.scaled_gemm(*p), ref.scaled_gemm(*p))
        if not err <= TOL:
            fail(f"ops.scaled_gemm on {cfg}: error {err:.3e}")
    for cfg in ((128, 128, 256), (256, 256, 256)):
        p = problem(*cfg)
        err = rel_err(sg.naive_scaled_gemm(*p), ref.scaled_gemm(*p))
        if not err <= TOL:
            fail(f"naive_scaled_gemm on {cfg}: error {err:.3e}")
    torch.cuda.synchronize()
    path_launches["K3"] = _build.LAUNCHES[COUNTER["K3"]]
    path_launches["K4"] = _build.LAUNCHES[COUNTER["K4"]]
    print(f"library calls: ops.scaled_gemm on 18 challenge shapes, "
          f"naive_scaled_gemm at 128x128x256 and 256^3 agree with the "
          f"oracle; launches {path_launches}")
    for name, n in path_launches.items():
        if n < 1:
            fail(f"{name} was not launched on its path")

    # ------------------------------------------------ 4d-4g. serving, helpers
    def serve(cfg, label, long_prompts=()):
        """Serve SERVE's workload on ``cfg`` at full width with random bf16
        weights from seed 0, plus one prompt a (lo, hi) length range of
        ``long_prompts``; print what it took.  The launch counts are set
        to 0 just before ``engine.run`` and read just after."""
        t0 = time.perf_counter()
        model = api.init_params(cfg, 0)
        torch.cuda.synchronize()
        print(f"{label}: {cfg.param_count() / 1e9:.2f} B parameters "
              f"(param_count) initialised on the card in "
              f"{time.perf_counter() - t0:.1f} s")
        rng = np.random.default_rng(0)
        lo, hi = SERVE["prompt_lens"]
        ranges = [(lo, hi)] * SERVE["requests"] + list(long_prompts)
        prompts = [rng.integers(0, cfg.vocab, int(rng.integers(a, b + 1)))
                   .astype(np.int32) for a, b in ranges]
        engine = Engine(cfg, model, slots=SERVE["slots"],
                        max_seq=SERVE["max_seq"])
        for i, prompt in enumerate(prompts):
            engine.submit(Request(rid=i, prompt=prompt,
                                  max_new=SERVE["max_new"]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        finished = engine.run()
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        ticks = len(engine.decode_s)
        new_tokens = sum(len(r.generated) for r in finished)
        pf_ms = [1e3 * x for x in engine.prefill_s]
        dec_ms = [1e3 * x for x in engine.decode_s]
        print(f"serve {label}: {len(finished)} requests, prompt lengths "
              f"{[len(pr) for pr in prompts]}, {new_tokens} new tokens in "
              f"{serve_s:.2f} s = {new_tokens / serve_s:.1f} tokens/s, "
              f"{ticks} decode ticks; launches {launches}")
        print(f"serve {label}: ms per prefill mean {np.mean(pf_ms):.2f} "
              f"median {np.median(pf_ms):.2f} max {max(pf_ms):.2f} (first "
              f"{pf_ms[0]:.2f}); ms per decode tick mean {np.mean(dec_ms):.3f}"
              f" median {np.median(dec_ms):.3f}; prompt tokens/s "
              f"{sum(map(len, prompts)) / sum(engine.prefill_s):.0f}")
        print(f"serve {label}: card memory in use "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if len(finished) != len(prompts) or any(
                len(r.generated) != SERVE["max_new"]
                or not all(0 <= t < cfg.vocab_padded for t in r.generated)
                for r in finished):
            fail(f"{label}: serving did not return max_new valid tokens for "
                 "every request")
        return model, engine, prompts, finished, launches, ticks

    # the engine's tokens against the same model run alone: its own cache
    # from a batch-1 prefill, fed the engine's tokens, decoded at ``rows``
    # rows, every row this request.  A wrong slot copy or cache write would
    # pick tokens whose logits lie far below the top (~4 sigma over the
    # vocabulary).
    def replay(model, cfg, req, rows):
        """Yield (row 0's logits, cache) before each of req's tokens."""
        toks = torch.as_tensor(req.prompt, device=dev).long()[None]
        logits, cache = api.prefill(model, cfg, {"tokens": toks},
                                    SERVE["max_seq"])
        cache = {k: v.repeat_interleave(rows, dim=0 if k == "len" else 1)
                 for k, v in cache.items()}
        for step, tok in enumerate(req.generated):
            yield logits[0].float(), cache
            if step + 1 < len(req.generated):
                logits, cache = api.decode_step(
                    model, cfg, cache, torch.full((rows,), tok, device=dev))

    def shortfall(logits, tok):
        return ((logits.max() - logits[tok]) / logits.abs().max()).item()

    def replayed(finished, ids=(0, SERVE["requests"] - 1)):
        by_id = {r.rid: r for r in finished}
        return [by_id[i] for i in ids]

    def witness(model, cfg, label, finished, rows,
                ids=(0, SERVE["requests"] - 1)):
        for req in replayed(finished, ids):
            gaps, exact = [], 0
            for (logits, _), tok in zip(replay(model, cfg, req, rows),
                                        req.generated):
                gaps.append(shortfall(logits, tok))
                exact += int(logits.argmax().item() == tok)
            print(f"serve {label}: request {req.rid} (slot {req.slot}) "
                  f"alone, {rows} row(s): {exact}/{SERVE['max_new']} engine "
                  f"tokens are its argmax, largest shortfall {max(gaps):.2e} "
                  "of max|logits|")
            if not max(gaps) <= TOL:
                fail(f"{label} request {req.rid}: an engine token's logit is "
                     f"{max(gaps):.3e} of max|logits| below the top when "
                     "run alone")

    # At one row the GEMMs have other shapes than at the engine's 8 and may
    # sum in another order.  qwen2.5-3b shrugs that off (its witness runs
    # at batch 1), but random-weight mamba2-2.7b amplifies it through 64
    # layers and the recurrence past the witness's gate, so its witness
    # runs at 8 rows and this check shows that the batch-1 replay parts
    # from it by rounding: decoded side by side, fed the engine's tokens,
    # layer 0's state (one GEMM, w_in, before it) may differ by at most one
    # bf16 step (2^-8 of its max) and layer 1's (three GEMMs before it) by
    # four.
    def ssm_drift(model, cfg, label, finished, rows):
        limits = {0: 2.0**-8, 1: 2.0**-6}
        shown = [i for i in (0, 1, 2, 4, 8, 16, 32) if i < cfg.n_layers - 1]
        shown.append(cfg.n_layers - 1)
        for req in replayed(finished):
            worst = torch.zeros(cfg.n_layers, device=dev)
            gaps, exact = [], 0
            for (l1, c1), (_, c8), tok in zip(
                    replay(model, cfg, req, 1), replay(model, cfg, req, rows),
                    req.generated):
                s1, s8 = c1["state"][:, 0], c8["state"][:, 0]
                worst = torch.maximum(worst, (s1 - s8).abs().amax((1, 2, 3))
                                      / s8.abs().amax((1, 2, 3)))
                gaps.append(shortfall(l1, tok))
                exact += int(l1.argmax().item() == tok)
            worst = worst.tolist()
            print(f"serve {label}: request {req.rid} at 1 row against "
                  f"{rows}: max|state diff| / max|state| by layer "
                  + " ".join(f"{i}:{worst[i]:.1e}" for i in shown)
                  + f"; {exact}/{SERVE['max_new']} engine tokens are the "
                  f"1-row argmax, largest shortfall {max(gaps):.2e}")
            for i, limit in limits.items():
                if not worst[i] <= limit:
                    fail(f"{label} request {req.rid}: layer {i}'s state at "
                         f"1 row differs from {rows} rows by {worst[i]:.3e} "
                         f"of its max > {limit:.3e}")

    # where the time goes: traced windows after the counted run (the
    # profiler slows the host, so these walls are not the times above)
    def trace(what, fn, watch=None):
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.ones(1, device=dev).add_(1)   # the profiler's own start-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        busy, end, by_name = 0.0, float("-inf"), {}
        for a, b, name in spans:
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
            by_name[name[:48]] = by_name.get(name[:48], 0.0) + (b - a)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        mine = ""
        if watch:   # one of the port's kernels, named whether in the top or not
            hits = [b - a for a, b, name in spans if watch in name]
            mine = (f"; {watch} {sum(hits) / 1e3:.2f} ms in {len(hits)} "
                    f"launches ({100 * sum(hits) / busy:.1f}% of busy)")
        print(f"trace {what}: {len(spans)} kernels, device busy "
              f"{busy / 1e3:.2f} ms of {wall_us / 1e3:.2f} ms wall under "
              f"the profiler ({100 * busy / wall_us:.1f}%); top: "
              + "; ".join(f"{n} {t / 1e3:.2f} ms" for n, t in top) + mine)

    def trace_serving(model, cfg, label, engine, prompts, watch):
        for i, prompt in enumerate(prompts[:SERVE["slots"]]):
            engine.submit(Request(rid=100 + i, prompt=prompt, max_new=8))
        engine.tick()                      # admits all slots
        trace(f"{label}, 3 decode ticks, 8 slots",
              lambda: [engine.tick() for _ in range(3)])
        longest_toks = torch.as_tensor(max(prompts, key=len),
                                       device=dev).long()
        trace(f"{label}, prefill of {len(longest_toks)} tokens",
              lambda: api.prefill(model, cfg, {"tokens": longest_toks[None]},
                                  SERVE["max_seq"]), watch)

    # bf16 keeps 8 bits: the two paths round at other points (the kernels'
    # bf16 operands, the card's and the CPU's matmul sum orders), so a
    # hidden value may differ by a bf16 step (2^-8 relative) per rounding;
    # two layers compound a few such steps, well inside the kernels' own
    # 0.02 * max|plain|.
    def card_vs_cpu(cfg, label, small=None):
        small = small or dataclasses.replace(cfg, n_layers=2)
        card_model = api.init_params(small, 1)
        cpu_model = copy.deepcopy(card_model).to("cpu")
        prompt = torch.from_numpy(np.random.default_rng(1).integers(
            0, small.vocab, 333)).long()[None]
        t0 = time.perf_counter()
        _build.reset_launches()
        sides = {}
        for side, mdl, where in (("card", card_model, dev),
                                 ("cpu", cpu_model, torch.device("cpu"))):
            logits, cache = api.prefill(mdl, small,
                                        {"tokens": prompt.to(where)}, 512)
            sides[side] = [logits.float().cpu()]
            sides[side + "_cache"] = cache
        errs = [rel_err(sides["card"][0], sides["cpu"][0])]
        for _ in range(4):
            tok = sides["cpu"][-1].argmax(-1)
            for side, mdl, where in (("card", card_model, dev),
                                     ("cpu", cpu_model, torch.device("cpu"))):
                logits, sides[side + "_cache"] = api.decode_step(
                    mdl, small, sides[side + "_cache"], tok.to(where))
                sides[side].append(logits.float().cpu())
            errs.append(rel_err(sides["card"][-1], sides["cpu"][-1]))
        agree = sum(int(a.argmax() == b.argmax())
                    for a, b in zip(sides["card"], sides["cpu"]))
        print(f"card vs cpu, {label} full width 2 layers "
              f"({'+'.join(small.rglru.pattern) if small.rglru else small.family}), "
              "333-token prompt: "
              f"max|card - cpu| / max|cpu| of the logits, prefill then 4 "
              f"decode steps: {' '.join(f'{e:.2e}' for e in errs)}; argmax "
              f"agrees {agree}/5; launches {dict(_build.LAUNCHES)}; "
              f"{time.perf_counter() - t0:.1f} s")
        if not all(np.isfinite(x.numpy()).all() for x in sides["card"]):
            fail(f"{label}: the card's logits are not finite")
        if max(errs) > TOL:
            fail(f"{label}: card and CPU logits differ by {max(errs):.3e} "
                 f"> {TOL}")
        del card_model, cpu_model, sides
        torch.cuda.empty_cache()

    # ---------------------------------------------- 4d. serving qwen2.5-3b
    qwen = configs.get_config("qwen2.5-3b")
    model, engine, prompts, finished, serve_launches, ticks = serve(
        qwen, "qwen2.5-3b")
    path_launches["K5"] = serve_launches.get(COUNTER["K5"], 0)
    path_launches["K6"] = serve_launches.get(COUNTER["K6"], 0)
    if path_launches["K5"] != qwen.n_layers * SERVE["requests"]:
        fail(f"K5 launched {path_launches['K5']} times, expected "
             f"{qwen.n_layers} x {SERVE['requests']}")
    if path_launches["K6"] != qwen.n_layers * ticks:
        fail(f"K6 launched {path_launches['K6']} times, expected "
             f"{qwen.n_layers} x {ticks} ticks")
    longest, shortest = max(map(len, prompts)), min(map(len, prompts))
    final_lens = engine.cache["len"].clamp(max=SERVE["max_seq"]).tolist()
    cache_k = engine.cache["k"].clone()      # (L, B, Smax, Hkv, dh)
    cache_v = engine.cache["v"].clone()
    witness(model, qwen, "qwen2.5-3b", finished, rows=1)
    trace_serving(model, qwen, "qwen2.5-3b", engine, prompts,
                  "flash_prefill_kernel")
    del engine, model, finished
    torch.cuda.empty_cache()

    # ------------------------------------------- 4e. card against the CPU
    card_vs_cpu(qwen, "qwen2.5-3b")

    # --------------------------------------------- 4f. serving mamba2-2.7b
    mamba = configs.get_config("mamba2-2.7b")
    model, engine, m_prompts, finished, serve_launches, ticks = serve(
        mamba, "mamba2-2.7b")
    path_launches["K7"] = serve_launches.get(COUNTER["K7"], 0)
    if path_launches["K7"] != mamba.n_layers * SERVE["requests"]:
        fail(f"K7 launched {path_launches['K7']} times, expected "
             f"{mamba.n_layers} x {SERVE['requests']}")
    m_longest = max(map(len, m_prompts))
    witness(model, mamba, "mamba2-2.7b", finished, rows=SERVE["slots"])
    ssm_drift(model, mamba, "mamba2-2.7b", finished, rows=SERVE["slots"])
    trace_serving(model, mamba, "mamba2-2.7b", engine, m_prompts, "ssd_")
    del engine, model, finished
    torch.cuda.empty_cache()

    # ------------------------------------------- 4g. card against the CPU
    card_vs_cpu(mamba, "mamba2-2.7b")

    # ---------------------------------------------- 4h. fault containment
    # A subprocess pool, no eval cache: a good genome, a kernel that writes
    # far outside any allocation, the good genome again and a second one.
    # The bad source must get runtime_error, its worker must leave and come
    # back as incarnation 1, the later genomes must be ok, and this
    # process's own CUDA context must still work.
    fault_events = EventLog()
    pool = EvalPool.of(
        EvaluationService(bench_configs=BENCH_CONFIGS_18[:FAULT_CONFIGS]),
        transport="subprocess", retry_policy=NO_WAIT_POLICY,
        events=fault_events, transport_options={"job_timeout_s": 300})
    good = codegen.render_source(SEED_MXU)
    submissions = (("good genome", good), ("out-of-bounds kernel", OOB_KERNEL),
                   ("good genome again", good),
                   ("second good genome",
                    codegen.render_source(SEED_MXU.replace(block_m=64))))
    statuses = []
    for what, src in submissions:
        t0 = time.perf_counter()
        res = pool.submit_async(src).result(timeout=600)
        statuses.append(res.status)
        print(f"4h {what}: {res.status} in {time.perf_counter() - t0:.1f} s"
              + (f" ({res.error[:200]})" if res.error else ""))
    spawns = [(e["incarnation"], e["pid"])
              for e in fault_events.select("worker_spawn")]
    exits = fault_events.select("worker_exit")
    fault_launches = dict(pool.transport.launches)
    pool.close()
    print(f"4h: spawns (incarnation, pid) {spawns}; exits "
          f"{[(e['incarnation'], e['reason'][:120]) for e in exits]}; "
          f"launches reported {fault_launches}")
    if statuses != ["ok", "runtime_error", "ok", "ok"]:
        fail(f"fault containment: verdicts {statuses}, expected ok, "
             "runtime_error, ok, ok")
    if [i for i, _ in spawns] != [0, 1] or not exits or \
            "CUDA context unusable" not in exits[0]["reason"]:
        fail("fault containment: the worker did not leave after the fault "
             "and come back as incarnation 1")
    lost = probe_context(dev)
    x = torch.ones(64, 64, device=dev)
    if lost or (x @ x).sum().item() != 64.0 ** 3:
        fail(f"fault containment: this process's CUDA context broke: {lost}")
    print("4h: the bad kernel's worker exited and came back as incarnation "
          "1; this process's CUDA context still works")
    # the same two sources in one process, in a child of this one: the
    # service must refuse to go on after the fault
    child = subprocess.run(
        [sys.executable, str(root / "chip_smoke.py"), INPROCESS_CHECK],
        capture_output=True, text=True, timeout=600)
    out = (child.stdout.strip().splitlines() or [""])[-1]
    print(f"4h in-process, in a child process (exit {child.returncode}): "
          f"{out}")
    try:
        verdict = json.loads(out)
    except ValueError:
        fail(f"in-process fault check printed no result: "
             f"{child.stderr[-2000:]}")
    if verdict.get("bad") != "runtime_error" or \
            verdict.get("next") != "PoisonedContextError" or \
            "subprocess" not in verdict.get("message", ""):
        fail("in-process: the service went on after a poisoned context")

    # --------------------------------------- 4i. serving recurrentgemma-9b
    rg = configs.get_config("recurrentgemma-9b")
    n_attn = rglru.kinds(rg).count("attn")
    model, engine, rg_prompts, finished, serve_launches, ticks = serve(
        rg, "recurrentgemma-9b", LONG_PROMPTS)
    path_launches["K5-D256"] = serve_launches.get(COUNTER["K5-D256"], 0)
    path_launches["K6-D256"] = serve_launches.get(COUNTER["K6-D256"], 0)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"recurrentgemma-9b: {n_params / 1e9:.2f} B parameters in the "
          f"model; {n_attn} attention "
          f"layers, window {rg.rglru.window}; "
          f"{sum(len(p) > rg.rglru.window for p in rg_prompts)} prompts "
          "past the window")
    if path_launches["K5-D256"] != n_attn * len(rg_prompts):
        fail(f"K5 (D=256) launched {path_launches['K5-D256']} times, "
             f"expected {n_attn} x {len(rg_prompts)}")
    if path_launches["K6-D256"] != n_attn * ticks:
        fail(f"K6 (D=256) launched {path_launches['K6-D256']} times, "
             f"expected {n_attn} x {ticks} ticks")
    rg_longest = max(map(len, rg_prompts))
    rg_lens = engine.cache["len"].tolist()
    rg_k = engine.cache["k"].clone()       # (n_attn, B, W, 1, 256) rings
    rg_v = engine.cache["v"].clone()
    witness(model, rg, "recurrentgemma-9b", finished, rows=1,
            ids=(0, len(rg_prompts) - 1))
    trace_serving(model, rg, "recurrentgemma-9b", engine, rg_prompts,
                  "flash_prefill_kernel")
    del engine, model, finished
    torch.cuda.empty_cache()

    # ------------------------------------------- 4j. card against the CPU
    # one recurrent layer and one attention layer at full width
    card_vs_cpu(rg, "recurrentgemma-9b", dataclasses.replace(
        rg, n_layers=2, rglru=dataclasses.replace(
            rg.rglru, pattern=("rglru", "attn"))))

    # ------------------------------------------------------------ 5. times
    def time_ms(fn, args, reps):
        fn(*args)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def device_by_kernel(fn, args, reps=20):
        """Device ms per call of each kernel torch.profiler saw."""
        from torch.profiler import ProfilerActivity, profile
        fn(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn(*args)
            torch.cuda.synchronize()
        by = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                name = e.name.split("(")[0].split("<")[0]
                by[name] = (by.get(name, 0.0)
                            + (e.time_range.end - e.time_range.start) / reps / 1e3)
        return by

    def device_ms(fn, args, reps=20):
        """Device time per call, from the kernels torch.profiler saw."""
        return sum(device_by_kernel(fn, args, reps).values())

    def scaled_mm(aq, bq, a_s, b_s):
        """torch._scaled_mm with A's 1x128 and B's 128x128 block scales, in
        the layouts its checks ask for (B and both scales outer-dim-major):
        (the call, None), or (None, the installation's refusal).  The port
        never calls it."""
        args = (aq, bq.t().contiguous().t(), a_s.t().contiguous().t(),
                b_s.t().contiguous().t())

        def call(*_):
            return torch._scaled_mm(args[0], args[1], scale_a=args[2],
                                    scale_b=args[3], out_dtype=bf16)
        try:
            call()
            torch.cuda.synchronize()
            return call, None
        except RuntimeError as e:
            return None, str(e).strip().splitlines()[0]

    def peak_of(genome, storage):
        """The tensor cores that multiply a blocked genome's inputs exactly:
        the stored 8-bit values under scale_acc, rounded bf16 values under
        dequant_inputs in bf16, the FMA units for the f32 compute type."""
        if genome.compute_dtype == "float32":
            return "float32"
        if genome.scale_application == "dequant_inputs":
            return "bfloat16"
        return str(storage)[6:]

    library_run = module(SEED_LIBRARY)
    timed = [
        ("K1b", k1(SEED_MXU, 1), full),
        ("K1a", k1(mxu_split4, 4), (1024, 1536, 7168)),
        ("K2", (module(SEED_MONOLITH), sg.monolith_reference, None),
         (256, 256, 256)),
        ("K3", k3(), full),
        ("K4", (sg.naive_scaled_gemm, sg.monolith_reference, None),
         (256, 256, 256)),
    ]
    records = []
    for name, (kernel, plain, blk), (m, n, k) in timed:
        p = problem(m, n, k)
        reps = 20 if m * n * k > 2**30 else 5
        err = rel_err(kernel(*p), plain(*p))
        ms = time_ms(kernel, p, reps)
        plain_ms = time_ms(plain, p, reps)
        library_ms = time_ms(library_run, p, reps)
        nbytes = (m * k + k * n + 4 * (m * (k // 128) + (k // 128)
                  * -(-n // 128)) + 2 * m * n)
        peak = peak_of(blk.genome, fp8) if blk else "float32"
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * m * n * k / PEAK_OPS[peak] * 1e3
        max_abs = (kernel(*p).float() - plain(*p).float()).abs().max().item()
        rec = {
            "name": name, "route": "cuda", "source": CSRC,
            "replaces": REPLACES[name], "launches": path_launches[name],
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms, "shape_mnk": [m, n, k],
            "bound_peak": peak, "rel_err": err}
        line = (f"{name} at M,N,K={m},{n},{k}: {ms:.4f} ms (plain "
                f"{plain_ms:.4f}, library seed {library_ms:.4f}, bound "
                f"{max(t_bytes, t_ops):.4f} by {rec['bound_by']} at the "
                f"{peak} peak")
        if blk is not None:   # K1/K3: the path, and the device time
            rec["path"] = path_of(blk.library(m, n, k, fp8))
            rec["device_ms"] = device_ms(kernel, p)
            line += (f"; {rec['path']} path, device per call "
                     f"{rec['device_ms']:.4f} ms")
        if name in ("K1b", "K1a"):
            call, refusal = scaled_mm(*p)
            if call is None:
                rec["scaled_mm"] = {"refused": refusal}
                line += f"; torch._scaled_mm refuses: {refusal}"
            else:
                rec["scaled_mm"] = {"ms": time_ms(call, (), reps),
                                    "rel_err": rel_err(call(), plain(*p))}
                line += (f"; torch._scaled_mm {rec['scaled_mm']['ms']:.4f} ms"
                         f" (rel err {rec['scaled_mm']['rel_err']:.2e})")
        records.append(rec)
        print(line + ")")
    if not records[0]["ms"] < records[0]["library_ms"]:
        fail("K1b is not faster than the library seed")

    # K5 at the longest prompt of 4d.  K6 at 4d's cache, read through its
    # strides as the engine reads it, with the lengths the slots ended at;
    # one launch per layer in turn, as a decode tick reads the cache, so
    # each launch finds its 33 MB cold in the 50 MB L2 as on the path.
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def k5_at(s_len):
        q, k, v = attn_inputs(1, 16, 2, s_len, 128, 3)
        pairs = s_len * (s_len + 1) // 2          # causal (q, k) pairs
        return dict(sets=[(q, k, v)], kernel=fa.flash_attention,
                    plain=fa.attention_reference,
                    library=lambda q, k, v: sdpa(q, k, v, is_causal=True,
                                                 enable_gqa=True),
                    ops=4 * 16 * 128 * pairs,
                    nbytes=(2 * 16 + 2 * 2) * s_len * 128 * 2,
                    shape=f"B,Hq,Hkv,S,D=1,16,2,{s_len},128 causal")

    k5 = k5_at(longest)
    g = torch.Generator(device=dev).manual_seed(4)
    q6 = torch.randn(SERVE["slots"], 16, 128, generator=g, device=dev).to(bf16)
    lens6 = torch.tensor(final_lens, dtype=torch.int32, device=dev)
    k6_sets = [(q6, cache_k[i].transpose(1, 2), cache_v[i].transpose(1, 2),
                lens6) for i in range(qwen.n_layers)]
    valid = (torch.arange(SERVE["max_seq"], device=dev)[None, :]
             < lens6[:, None])[:, None, None, :]
    k6 = dict(sets=k6_sets, kernel=fa.decode_attention,
              plain=fa.decode_attention_reference,
              library=lambda q, k, v, n: sdpa(q[:, :, None], k, v,
                                              attn_mask=valid,
                                              enable_gqa=True)[:, :, 0],
              ops=4 * 16 * 128 * sum(final_lens),
              nbytes=(sum(final_lens) * 2 * 128 * 2 * 2
                      + 2 * SERVE["slots"] * 16 * 128 * 2 + 4 * SERVE["slots"]),
              shape=f"B,Hq,Hkv,Smax,D=8,16,2,4096,128 kv_len={final_lens}")
    def time_sets(fn, sets, reps):
        return time_ms(lambda: [fn(*a) for a in sets], (), reps) / len(sets)

    def attn_record(name, t):
        got = t["kernel"](*t["sets"][0])
        want = t["plain"](*t["sets"][0])
        lib_err = row_err(t["library"](*t["sets"][0]), want)
        # 100 calls: a call that the host's launch overhead bounds is noisy
        ms = time_sets(t["kernel"], t["sets"], 100)
        plain_ms = time_sets(t["plain"], t["sets"], 3)
        library_ms = time_sets(t["library"], t["sets"], 100)
        t_bytes = t["nbytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = t["ops"] / PEAK_OPS["bfloat16"] * 1e3
        rec = {
            "name": name, "route": "cuda", "source": FA_CSRC,
            "replaces": REPLACES[name], "launches": path_launches[name],
            "max_abs_err": (got.float() - want.float()).abs().max().item(),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms, "shape": t["shape"],
            "row_rel_err": row_err(got, want),
            "library_row_rel_err": lib_err}
        line = (f"{name} at {t['shape']}: {ms:.4f} ms (plain {plain_ms:.4f}, "
                f"sdpa {library_ms:.4f}, bound {max(t_bytes, t_ops):.4f} by "
                f"{rec['bound_by']}")
        # device time per call, over the same sets in turn
        sets, reps = t["sets"], max(10, 200 // len(t["sets"]))
        rec["device_ms"] = device_ms(
            lambda: [t["kernel"](*a) for a in sets], (), reps) / len(sets)
        rec["library_device_ms"] = device_ms(
            lambda: [t["library"](*a) for a in sets], (), reps) / len(sets)
        line += (f"; device per call {rec['device_ms']:.4f}, sdpa "
                 f"{rec['library_device_ms']:.4f}")
        print(line + ")")
        return rec

    records.append(attn_record("K5", k5))
    # K5 at the shortest prompt of 4d, in a line of its own and kept in
    # K5's record: a few blocks, where launch latency and the host count
    short = attn_record("K5", k5_at(shortest))
    records[-1]["at_shortest_prompt"] = {
        key: short[key] for key in ("shape", "ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms", "device_ms",
                                    "library_device_ms", "max_abs_err",
                                    "row_rel_err")}
    records.append(attn_record("K6", k6))
    # K6 at each split it takes, in turn, over 4d's cache layers
    records[-1]["splits"] = {}
    for split in fa.DECODE_SPLITS:
        def at_split(q, k, v, n, split=split):
            return fa.decode_at_split(q, k, v, n, split)
        ev = time_sets(at_split, k6_sets, 100)
        dev_ms = device_ms(lambda: [at_split(*a) for a in k6_sets], (), 10
                           ) / len(k6_sets)
        err = row_err(at_split(*k6_sets[0]), k6["plain"](*k6_sets[0]))
        records[-1]["splits"][split] = {"ms": ev, "device_ms": dev_ms,
                                        "row_rel_err": err}
        print(f"K6 split {split} keys a block: {ev:.4f} ms, device per call "
              f"{dev_ms:.4f} (worst row {err:.2e})"
              + (" <- kept" if split == fa.DECODE_SPLIT else ""))
    if not records[-1]["device_ms"] < records[-1]["library_device_ms"]:
        fail("K6 is not faster than SDPA on the card")

    # K5 at head dim 256 at the longest prompt of 4i, window 2048 and GQA
    # group 16, through the model's transposed views; SDPA gets the window
    # as a mask.  K6 at head dim 256 at 4i's rings and final lengths, one
    # launch per attention layer in turn.  Their bounds count the (query,
    # key) pairs and the ring slots this run's lengths make valid.
    window = rg.rglru.window
    q, k, v = attn_inputs(1, 16, 1, rg_longest, 256, 6, views=True)
    pos = torch.arange(rg_longest, device=dev)
    win_mask = ((pos[None, :] <= pos[:, None])
                & (pos[None, :] > pos[:, None] - window))
    pairs = sum(min(t + 1, window) for t in range(rg_longest))
    records.append(attn_record("K5-D256", dict(
        sets=[(q, k, v)],
        kernel=lambda q, k, v: fa.flash_attention(q, k, v, window=window),
        plain=lambda q, k, v: fa.attention_reference(q, k, v, window=window),
        library=lambda q, k, v: sdpa(q, k, v, attn_mask=win_mask,
                                     enable_gqa=True),
        ops=4 * 16 * 256 * pairs, nbytes=(2 * 16 + 2) * rg_longest * 256 * 2,
        shape=f"B,Hq,Hkv,S,D=1,16,1,{rg_longest},256 causal window "
              f"{window}")))
    w_ring = rg_k.shape[2]
    n_valid = [min(n, w_ring) for n in rg_lens]
    q6 = torch.randn(SERVE["slots"], 16, 256, generator=g,
                     device=dev).to(bf16)
    nv6 = torch.tensor(n_valid, dtype=torch.int32, device=dev)
    ring_sets = [(q6, rg_k[i].transpose(1, 2), rg_v[i].transpose(1, 2), nv6)
                 for i in range(n_attn)]
    ring_valid = (torch.arange(w_ring, device=dev)[None, :]
                  < nv6[:, None])[:, None, None, :]
    records.append(attn_record("K6-D256", dict(
        sets=ring_sets, kernel=fa.decode_attention,
        plain=fa.decode_attention_reference,
        library=lambda q, k, v, n: sdpa(q[:, :, None], k, v,
                                        attn_mask=ring_valid,
                                        enable_gqa=True)[:, :, 0],
        ops=4 * 16 * 256 * sum(n_valid),
        nbytes=(sum(n_valid) * 256 * 2 * 2 + 2 * SERVE["slots"] * 16 * 256 * 2
                + 4 * SERVE["slots"]),
        shape=f"B,Hq,Hkv,W,D=8,16,1,{w_ring},256 ring, n_valid={n_valid}")))
    records[-1]["split"] = fa.decode_split(256)
    print(f"K6-D256 runs {fa.decode_split(256)} keys a block; 256 keys a "
          "block is refused (phase 3)")

    # K7 at the longest prompt of 4f, x, B and C read as views of one
    # (1, S, H*P + 2N) tensor, as the model hands them over.  No PyTorch
    # call computes the SSD scan, so there is no library time.  Its bound
    # counts each input and output once and, in bf16, the multiply-adds of
    # the chunked form: per head and chunk of c tokens, c(c+1)/2 * (N + P)
    # inside the chunk and 2*c*N*P for the state.
    h7, p7, n7 = 80, 64, 128
    args = ssd_inputs(1, m_longest, 10)
    got, got_state = ssd.ssd(*args)
    want, want_state = ssd.ssd_reference(*args)
    ms = time_ms(ssd.ssd, args, 20)
    plain_ms = time_ms(ssd.ssd_reference, args, 3)
    stages = device_by_kernel(ssd.ssd, args)
    # per head and chunk of c tokens c(c+1)/2 * P inside the chunk, c*N*P
    # for C . s_in and c*N*P for the state; per chunk c(c+1)/2 * N for C B^T
    chunks = [min(ssd.CHUNK, m_longest - i)
              for i in range(0, m_longest, ssd.CHUNK)]
    macs = sum(h7 * (c * (c + 1) // 2 * p7 + 2 * c * n7 * p7)
               + c * (c + 1) // 2 * n7 for c in chunks)
    nbytes = (2 * m_longest * h7 * p7 * 2 + m_longest * h7 * 4
              + 2 * m_longest * n7 * 2 + h7 * 4 + h7 * n7 * p7 * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * macs / PEAK_OPS["bfloat16"] * 1e3
    records.append({
        "name": "K7", "route": "cuda", "source": SSD_CSRC,
        "replaces": REPLACES["K7"], "launches": path_launches["K7"],
        "max_abs_err": (got.float() - want.float()).abs().max().item(),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
        "shape": f"B,S,H,P,N=1,{m_longest},{h7},{p7},{n7} model decay",
        "row_rel_err": ssd_row_err(got, want, "phase 5 y"),
        "state_row_rel_err": ssd_row_err(got_state, want_state,
                                         "phase 5 state"),
        "device_ms": sum(stages.values()), "stages_device_ms": stages,
        "chunk": ssd.CHUNK})
    print(f"K7 at {records[-1]['shape']}: {ms:.4f} ms (plain {plain_ms:.4f}, "
          f"library none, bound {max(t_bytes, t_ops):.4f} by "
          f"{records[-1]['bound_by']}: {nbytes / 1e6:.1f} MB, "
          f"{2 * macs / 1e9:.2f} GFLOP; device per call "
          f"{records[-1]['device_ms']:.4f}: " + ", ".join(
              f"{k} {v:.4f}" for k, v in stages.items()) + ")")
    # K7 at each chunk it builds for, the plain version at the same chunk
    records[-1]["chunks"] = {}
    for ch in ssd.CHUNKS:
        def at_chunk(*a, ch=ch):
            return ssd.scan(*a, chunk=ch)
        ev = time_ms(at_chunk, args, 20)
        by = device_by_kernel(at_chunk, args)
        err = ssd_row_err(at_chunk(*args)[0],
                          ssd.ssd_reference(*args, chunk=ch)[0], f"L={ch} y")
        records[-1]["chunks"][ch] = {"ms": ev, "device_ms": sum(by.values()),
                                     "stages_device_ms": by,
                                     "row_rel_err": err}
        print(f"K7 chunk L={ch}: {ev:.4f} ms, device per call "
              f"{sum(by.values()):.4f}: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in by.items())
              + f" (worst row {err:.2e})"
              + (" <- kept" if ch == ssd.CHUNK else ""))
    torch.cuda.synchronize()
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def inprocess_fault_check() -> int:
    """4h's in-process half, run by chip_smoke.py in a child process (its
    CUDA context ends unusable): the out-of-bounds kernel and then a good
    genome through one ``EvaluationService`` in this process.  Prints one
    JSON line: the bad source's verdict, and what the next submission
    gave or raised."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))
    from repro_torch.core import codegen
    from repro_torch.core.evaluator import (EvaluationService,
                                            PoisonedContextError)
    from repro_torch.core.genome import SEED_MXU
    from repro_torch.core.population import BENCH_CONFIGS_18
    svc = EvaluationService(bench_configs=BENCH_CONFIGS_18[:FAULT_CONFIGS])
    out = {"bad": svc.submit(OOB_KERNEL).status,
           "context_lost": svc.context_lost}
    try:
        out["next"] = svc.submit(codegen.render_source(SEED_MXU)).status
    except PoisonedContextError as e:
        out["next"], out["message"] = type(e).__name__, str(e)
    print(json.dumps(out), flush=True)
    # no teardown in a poisoned context
    os._exit(0)


if __name__ == "__main__":
    if sys.argv[1:] == [INPROCESS_CHECK]:
        sys.exit(inprocess_fault_check())
    sys.exit(main())
