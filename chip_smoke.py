#!/usr/bin/env python3
"""Drive the port's main path on one NVIDIA H100 and check every kernel.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit and no
result line:

1. Device: the card's name and power limit (``nvidia-smi``) and SM count.
2. Build: every kernel variant of phase 3, one ``nvcc`` per source, all at
   once; prints the build seconds.
3. Kernels against their plain versions on the card, within
   ``0.02 * max|plain|`` (the JAX tests' tolerance): K1 (the rendered
   blocked module, split-K and not), K2 (the rendered single-block module),
   K3 (``kernels.scaled_gemm.scaled_gemm``), K4 (``naive_scaled_gemm``).
4. Main paths, each with the launch counts set to 0 just before it and
   read just after:
   a. the campaign: ``repro_torch.launch.scientist.run_campaign`` for 2
      generations with the ScriptedLLM, one worker, timed on the 18
      challenge shapes at full size (K1);
   b. the platform's compile-error path: the single-block seed passes the
      256^3 correctness check and is refused at the first challenge shape
      (K2), the Hopper form of the TPU's VMEM refusal;
   c. the library calls: ``kernels.ops.scaled_gemm`` on the 18 challenge
      shapes (K3) and ``naive_scaled_gemm`` at the sizes it fits (K4),
      against the oracle ``kernels.ref.scaled_gemm``.
5. Times: each kernel, its plain version and the library seed (f32
   dequant + ``torch.matmul``) at one main-path shape, with CUDA events,
   beside the least time the card could take.

The last two lines are the ``{"kernels": [...]}`` record and
``{"ok": true, "device": {...}}``.
"""
import json
import pathlib
import subprocess
import sys
import tempfile
import time

TOL = 0.02                  # x max|plain|, as tests/test_kernels_scaled_gemm.py
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, same source
CSRC = "src/repro_torch/csrc/scaled_gemm.cu"
REPLACES = {
    "K1a": "src/repro/core/codegen.py:183",
    "K1b": "src/repro/core/codegen.py:204",
    "K2": "src/repro/core/codegen.py:79",
    "K3": "src/repro/kernels/scaled_gemm.py:145",
    "K4": "src/repro/kernels/scaled_gemm.py:182",
}
COUNTER = {"K1a": "blocked_splitk", "K1b": "blocked", "K2": "monolith",
           "K3": "scaled_gemm", "K4": "naive_scaled_gemm"}


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
    from repro_torch.core.evaluator import EvaluationService
    from repro_torch.core.population import BENCH_CONFIGS_18
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import scaled_gemm as sg
    from repro_torch.launch.scientist import report, run_campaign

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

    # ----------------------------------------------------------- 2. build
    variants = [
        dict(), dict(compute_dtype=f32, scale_application="dequant_inputs"),
        dict(scale_application="dequant_inputs"), dict(grid_order="nm"),
        dict(storage=i8), dict(block_m=256),
    ]
    sources = [sg.kernel_source(**v) for v in variants]
    sources.append("#define STORAGE_INT8 0\n" + _build.read_csrc("scaled_gemm.cu"))
    t0 = time.perf_counter()
    _build.build_many(sources)
    print(f"build: {len(sources)} sources with nvcc in parallel, "
          f"{time.perf_counter() - t0:.1f} s")

    # ----------------------------------------- 3. kernels vs plain versions
    def rel_err(got, want):
        want = want.float()
        return ((got.float() - want).abs().max()
                / (want.abs().max().clamp_min(1e-30))).item()

    def k3(**kw):
        def kernel(*p):
            return sg.scaled_gemm(*p, **kw)

        def plain(*p):
            return sg.blocked_reference(
                *p, block_k=kw.get("block_k", 128),
                scale_application=kw.get("scale_application", "scale_acc"),
                compute_dtype=kw.get("compute_dtype", bf16))
        return kernel, plain

    def k1(genome, ks):
        run = module(genome)

        def plain(a, b, a_s, b_s):
            return sg.blocked_reference(
                a, b, a_s, b_s, block_k=genome.block_k, k_split=ks,
                scale_application=genome.scale_application,
                compute_dtype=getattr(torch, genome.compute_dtype))
        return run, plain

    mxu_split4 = SEED_MXU.replace(k_split=4)
    cases = [
        ("K1b", "MXU seed", *k1(SEED_MXU, 1), (1024, 1536, 7168), fp8),
        ("K1b", "naive seed (f32, dequant_inputs)", *k1(SEED_NAIVE, 1),
         (1024, 1536, 7168), fp8),
        ("K1b", "grid_order nm", *k1(SEED_MXU.replace(grid_order="nm"), 1),
         (1024, 576, 7168), fp8),
        ("K1b", "dequant_inputs bf16",
         *k1(SEED_MXU.replace(scale_application="dequant_inputs"), 1),
         (6144, 4096, 512), fp8),
        ("K1b", "MXU seed, full size", *k1(SEED_MXU, 1), (6144, 7168, 2048),
         fp8),
        ("K1a", "k_split 4", *k1(mxu_split4, 4), (1024, 1536, 7168), fp8),
        ("K2", "single block", module(SEED_MONOLITH), sg.monolith_reference,
         (128, 128, 256), fp8),
        ("K2", "single block", module(SEED_MONOLITH), sg.monolith_reference,
         (256, 256, 256), fp8),
        ("K3", "128^3 scale_acc", *k3(), (256, 384, 512), fp8),
        ("K3", "128^3 scale_acc int8", *k3(), (256, 384, 512), i8),
        ("K3", "256x128x128", *k3(block_m=256), (512, 256, 384), fp8),
        ("K3", "grid_order nm", *k3(grid_order="nm"), (384, 256, 256), fp8),
        ("K3", "f32 dequant_inputs",
         *k3(compute_dtype=f32, scale_application="dequant_inputs"),
         (256, 256, 256), fp8),
        ("K3", "full size", *k3(), (6144, 7168, 2048), fp8),
        ("K4", "single block", lambda *p: sg.naive_scaled_gemm(*p),
         sg.monolith_reference, (128, 128, 256), fp8),
        ("K4", "single block", lambda *p: sg.naive_scaled_gemm(*p),
         sg.monolith_reference, (256, 256, 256), fp8),
    ]
    worst = {}
    for name, what, kernel, plain, (m, n, k), dtype in cases:
        p = problem(m, n, k, dtype)
        before = sum(_build.LAUNCHES.values())
        got = kernel(*p)
        torch.cuda.synchronize()
        launched = sum(_build.LAUNCHES.values()) - before
        want = plain(*p)
        err = rel_err(got, want)
        worst[name] = max(worst.get(name, 0.0), err)
        print(f"{name} {what:34s} M,N,K={m},{n},{k} {str(dtype)[6:]:13s} "
              f"max_abs_err/max|plain| {err:.2e} launches {launched}")
        if launched != 1:
            fail(f"{name} {what}: {launched} launches, expected 1")
        if not err <= TOL:
            fail(f"{name} {what}: error {err:.3e} above {TOL}")
    p = problem(1024, 1536, 7168)
    try:
        sg.naive_scaled_gemm(*p)
        torch.cuda.synchronize()
        fail("K4 at 1024x1536x7168 was not refused")
    except _build.LaunchRefusedError as e:
        print(f"K4 at M,N,K=1024,1536,7168 refused as expected: {e}")
    print("kernels: " + ", ".join(f"{n} (max err {e:.2e})"
                                  for n, e in worst.items()))

    # ------------------------------------------------------ 4a. campaign
    _build.reset_launches()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as wd:
        sci = run_campaign(2, wd, seed=0, workers=1)
        sci.pool.close()
    events = sci.events.records
    campaign_launches = dict(_build.LAUNCHES)
    print(f"campaign: {time.perf_counter() - t0:.1f} s, launches "
          f"{campaign_launches}")
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
    path_launches = {n: campaign_launches.get(COUNTER[n], 0)
                     for n in ("K1a", "K1b")}

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

    library_run = module(SEED_LIBRARY)
    timed = [
        ("K1b", module(SEED_MXU), k1(SEED_MXU, 1)[1], (6144, 7168, 2048),
         "bfloat16"),
        ("K1a", module(mxu_split4), k1(mxu_split4, 4)[1], (1024, 1536, 7168),
         "bfloat16"),
        ("K2", module(SEED_MONOLITH), sg.monolith_reference, (256, 256, 256),
         "float32"),
        ("K3", k3()[0], k3()[1], (6144, 7168, 2048), "bfloat16"),
        ("K4", lambda *p: sg.naive_scaled_gemm(*p), sg.monolith_reference,
         (256, 256, 256), "float32"),
    ]
    records = []
    for name, kernel, plain, (m, n, k), cdtype in timed:
        p = problem(m, n, k)
        reps = 20 if m * n * k > 2**30 else 5
        err = rel_err(kernel(*p), plain(*p))
        ms = time_ms(kernel, p, reps)
        plain_ms = time_ms(plain, p, reps)
        library_ms = time_ms(library_run, p, reps)
        nbytes = (m * k + k * n + 4 * (m * (k // 128) + (k // 128)
                  * -(-n // 128)) + 2 * m * n)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * m * n * k / PEAK_OPS[cdtype] * 1e3
        max_abs = (kernel(*p).float() - plain(*p).float()).abs().max().item()
        records.append({
            "name": name, "route": "cuda", "source": CSRC,
            "replaces": REPLACES[name], "launches": path_launches[name],
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms, "shape_mnk": [m, n, k],
            "compute_dtype": cdtype, "rel_err": err})
        print(f"{name} at M,N,K={m},{n},{k}: {ms:.4f} ms (plain {plain_ms:.4f}, "
              f"library seed {library_ms:.4f}, bound {max(t_bytes, t_ops):.4f} "
              f"by {records[-1]['bound_by']})")
    torch.cuda.synchronize()
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
