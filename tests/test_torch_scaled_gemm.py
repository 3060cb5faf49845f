"""The block-scaled GEMM kernels' plain versions against the JAX kernels.

On a CPU tensor every wrapper of the port runs its kernel's plain version;
these tests hold that version, with the kernel's numerics, against the JAX
Pallas kernels run as the JAX tests run them (``interpret=True``):

  K1  core.codegen blocked module   vs repro.core.codegen blocked module
  K2  core.codegen single block     vs repro.core.codegen single program
  K3  kernels.scaled_gemm / ops     vs repro.kernels.ops.scaled_gemm
  K4  kernels.naive_scaled_gemm     vs repro.kernels.scaled_gemm.naive_scaled_gemm

Inputs are numpy normals from fixed seeds, quantized by the JAX oracle and
handed byte for byte to both sides.  Tolerance: 0.01 * |jax| + 1e-3 *
max|jax| — the two sides round the same f32 sums to bf16, so they differ by
at most one bf16 step (2^-8 relative) where the f32 summation order tips a
rounding.  The kernels themselves are compared with these plain versions on
the card by chip_smoke.py.
"""
import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codegen as jcodegen
from repro.core import genome as jgenome
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.scaled_gemm import naive_scaled_gemm as j_naive
from repro_torch.core import codegen
from repro_torch.core.genome import (SEED_LIBRARY, SEED_MONOLITH, SEED_MXU,
                                     SEED_NAIVE, KernelGenome)
from repro_torch.kernels import _build, ops
from repro_torch.kernels import scaled_gemm as sg

DTYPES = {"fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
          "int8": (jnp.int8, torch.int8)}


def _problem(seed, m, k, n, storage="fp8"):
    jdt, tdt = DTYPES[storage]
    rng = np.random.default_rng(seed)
    a = jnp.asarray(rng.standard_normal((m, k)), jnp.float32)
    b = jnp.asarray(rng.standard_normal((k, n)), jnp.float32)
    aq, a_s = jref.quantize_blockwise(a, jdt)
    bq, b_s = jref.quantize_blockwise_2d(b, jdt)
    jp = (aq, bq, a_s, b_s)
    tp = (torch.from_numpy(np.asarray(aq).view(np.uint8).copy()).view(tdt),
          torch.from_numpy(np.asarray(bq).view(np.uint8).copy()).view(tdt),
          torch.from_numpy(np.asarray(a_s).copy()),
          torch.from_numpy(np.asarray(b_s).copy()))
    return jp, tp


def _close(got, want):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0.01,
                               atol=1e-3 * np.abs(want).max())


def _jax_genome(g: KernelGenome):
    d = json.loads(g.to_json())
    return jgenome.KernelGenome(**d)


# ------------------------------------------------------------------ K3 / K4
@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 384, 128),
                                   (128, 512, 256), (384, 256, 384)])
@pytest.mark.parametrize("storage", ["fp8", "int8"])
def test_k3_plain_matches_jax_kernel(m, k, n, storage):
    jp, tp = _problem(0, m, k, n, storage)
    want = jops.scaled_gemm(*jp, block_m=128, block_n=128, block_k=128,
                            interpret=True)
    _close(sg.scaled_gemm(*tp), want)


@pytest.mark.parametrize("grid_order", ["mn", "nm"])
@pytest.mark.parametrize("scale_application", ["scale_acc", "dequant_inputs"])
def test_k3_genome_axes_match_jax(grid_order, scale_application):
    jp, tp = _problem(1, 256, 256, 256)
    want = jops.scaled_gemm(*jp, block_m=128, block_n=128, block_k=128,
                            grid_order=grid_order,
                            scale_application=scale_application,
                            interpret=True)
    _close(sg.scaled_gemm(*tp, grid_order=grid_order,
                          scale_application=scale_application), want)


def test_ops_unaligned_m_padded_like_jax():
    jp, tp = _problem(2, 256, 384, 256)
    jp = (jp[0][:200], jp[1], jp[2][:200], jp[3])
    tp = (tp[0][:200], tp[1], tp[2][:200].contiguous(), tp[3])
    want = jops.scaled_gemm(*jp, block_m=128, block_n=256, block_k=128,
                            interpret=True)
    got = ops.scaled_gemm(*tp, block_m=128, block_n=256, block_k=128)
    assert tuple(got.shape) == (200, 256)
    _close(got, want)


@pytest.mark.parametrize("m,k,n", [(128, 256, 128), (256, 256, 256)])
def test_k4_plain_matches_jax_naive(m, k, n):
    jp, tp = _problem(3, m, k, n)
    _close(sg.naive_scaled_gemm(*tp), j_naive(*jp))


# ------------------------------------------------------------------ K1 / K2
K1_GENOMES = [
    SEED_NAIVE,
    SEED_MXU,
    SEED_MXU.replace(k_split=2),
    SEED_MXU.replace(k_split=4),
    SEED_MXU.replace(grid_order="nm", scale_application="dequant_inputs"),
    SEED_MXU.replace(block_m=256, k_split=2, scale_application="dequant_inputs"),
    SEED_NAIVE.replace(scale_application="scale_acc", k_split=2),
]


@pytest.mark.parametrize("g", K1_GENOMES, ids=lambda g: g.describe())
@pytest.mark.parametrize("m,k,n", [(256, 512, 256), (200, 512, 384)])
def test_k1_module_matches_jax_module(g, m, k, n):
    jp, tp = _problem(4, m, k, n)
    jrun, _ = jcodegen.load_kernel(jcodegen.render_source(_jax_genome(g)))
    run, _ = codegen.load_kernel(codegen.render_source(g))
    _close(run(*tp), jrun(*jp, interpret=True))


def test_k1_module_int8_matches_jax_module():
    jp, tp = _problem(5, 256, 256, 256, "int8")
    jrun, _ = jcodegen.load_kernel(jcodegen.render_source(_jax_genome(SEED_MXU)))
    run, _ = codegen.load_kernel(codegen.render_source(SEED_MXU))
    _close(run(*tp), jrun(*jp, interpret=True))


@pytest.mark.parametrize("g", [SEED_MONOLITH, SEED_LIBRARY], ids=["K2", "library"])
def test_single_block_and_library_modules_match_jax(g):
    jp, tp = _problem(6, 128, 256, 128)
    jrun, _ = jcodegen.load_kernel(jcodegen.render_source(_jax_genome(g)))
    run, _ = codegen.load_kernel(codegen.render_source(g))
    _close(run(*tp), jrun(*jp, interpret=True))


def test_split_k_plain_sums_partials_in_slice_order():
    _, tp = _problem(7, 128, 512, 128)
    whole = sg.blocked_reference(*tp, block_k=128, k_split=1)
    split = sg.blocked_reference(*tp, block_k=128, k_split=4)
    np.testing.assert_allclose(split.float().numpy(), whole.float().numpy(),
                               rtol=0.01, atol=1e-3 * whole.abs().max().item())


# ------------------------------------------------- wrappers, sources, build
def test_cpu_tensors_take_the_plain_version_without_launching():
    _, tp = _problem(8, 128, 128, 128)
    before = dict(_build.LAUNCHES)
    sg.scaled_gemm(*tp)
    sg.naive_scaled_gemm(*tp)
    for g in (SEED_MXU, SEED_MXU.replace(k_split=2), SEED_MONOLITH):
        codegen.load_kernel(codegen.render_source(g))[0](*tp)
    assert dict(_build.LAUNCHES) == before


@pytest.mark.parametrize("bad", ["dtype", "scale_dtype", "shape", "contiguity",
                                 "blocks", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    _, (a, b, a_s, b_s) = _problem(9, 256, 256, 256)
    kw = {}
    if bad == "dtype":
        a = a.float()
    elif bad == "scale_dtype":
        a_s = a_s.double()
    elif bad == "shape":
        b = b[:128]
    elif bad == "contiguity":
        a = a.view(torch.uint8).t().contiguous().t().view(a.dtype)
    elif bad == "blocks":
        kw = {"block_m": 96}
    elif bad == "device":
        a, b, a_s, b_s = (t.to("meta") for t in (a, b, a_s, b_s))
    with pytest.raises((TypeError, ValueError)):
        sg.scaled_gemm(a, b, a_s, b_s, **kw)


def _source(**config):
    return sg.with_defines(sg.blocked_defines(**config),
                           _build.read_csrc("scaled_gemm.cu"))


def test_kernel_source_is_the_one_csrc_file():
    cuda = _build.read_csrc("scaled_gemm.cu")
    assert _source().endswith(cuda)
    for g in (SEED_MXU, SEED_MONOLITH):
        assert cuda in codegen.render_source(g)
    src = _source(block_m=256, storage=torch.int8, grid_order="nm")
    assert "#define BLOCK_M 256\n" in src and "#define STORAGE_INT8 1\n" in src
    assert "#define GRID_NM 1\n" in src


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.nvcc_path()


def test_stream_ptr_is_the_current_raw_stream_of_the_device(monkeypatch):
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 1000 + index, raising=False)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert _build.stream_ptr(torch.device("cuda", 1)) == 1001
    assert _build.stream_ptr(torch.device("cuda")) == 1003


def test_launch_codes_map_to_refused_or_fault():
    class Lib:
        @staticmethod
        def sg_error_string(rc):
            return b"message"

    _build.check(Lib, 0, "x")
    for rc in (1, 9, 701):
        with pytest.raises(_build.LaunchRefusedError):
            _build.check(Lib, rc, "x")
    with pytest.raises(_build.CudaError):
        _build.check(Lib, 700, "x")


# ------------------------------------------------------------------- genome
def test_smem_bytes_is_the_kernel_formula():
    # wgmma path: stages * (128 * (BM + 2 * BN) + 24 bytes of mbarriers)
    # + 16 KB of output staging per consumer + 1 KB of alignment; 128x128
    # holds 4 stages in 227 KB, whatever BK
    assert SEED_MXU.smem_bytes() == 4 * (128 * 384 + 24) + 2 * 16384 + 1024
    assert SEED_MXU.replace(block_k=512).smem_bytes() == SEED_MXU.smem_bytes()
    # mma.sync path: (BM + BN) * (BK + pad) * esize + scales; pad 8 bf16 / 1 f32
    dequant = SEED_MXU.replace(scale_application="dequant_inputs")
    assert dequant.smem_bytes() == 256 * 136 * 2 + (128 + 1) * 4
    assert SEED_NAIVE.smem_bytes() == 256 * 129 * 4 + (128 + 1) * 4
    big = KernelGenome()     # 256^3 bf16 needs more than a block may have
    assert big.smem_bytes() > 232448
    assert any("shared memory" in e for e in big.validate())
    for g in (SEED_LIBRARY, SEED_NAIVE, SEED_MXU, SEED_MONOLITH):
        assert g.validate() == []


# ---------------------------------------------------------------- path rule
WGMMA_FAMILY = [SEED_MXU.replace(block_m=bm, block_n=bn, **kw)
                for bm, bn in sg.WGMMA_TILES
                for kw in ({}, {"block_k": 512, "k_split": 4},
                           {"grid_order": "nm", "out_dtype": "float32"})]
MMA_SYNC_GENOMES = [
    SEED_NAIVE,                                            # f32 compute
    SEED_MXU.replace(compute_dtype="float32"),             # f32, scale_acc
    SEED_MXU.replace(scale_application="dequant_inputs"),  # bf16 dequant
    SEED_MXU.replace(block_m=192),                         # three sub-tiles
    SEED_MXU.replace(block_m=48),
    SEED_MXU.replace(block_m=256, block_n=256),
    SEED_MXU.replace(block_n=384),
]


@pytest.mark.parametrize("g", WGMMA_FAMILY, ids=lambda g: g.describe())
def test_path_rule_sends_the_mxu_family_to_wgmma(g):
    assert g.kernel_path() == "wgmma" and g.validate() == []
    d = sg.blocked_defines(block_m=g.block_m, block_n=g.block_n,
                           block_k=g.block_k, grid_order=g.grid_order)
    assert d["WGMMA_PATH"] == 1 and d["RING_STAGES"] >= 2
    # the ring is as deep as fits, whatever block_k
    assert g.smem_bytes() <= sg.SMEM_OPTIN
    assert g.smem_bytes() == g.replace(block_k=128).smem_bytes()


@pytest.mark.parametrize("g", MMA_SYNC_GENOMES, ids=lambda g: g.describe())
def test_path_rule_keeps_the_rest_on_mma_sync(g):
    assert g.kernel_path() == "mma_sync"
    d = sg.blocked_defines(
        block_m=g.block_m, block_n=g.block_n, block_k=g.block_k,
        compute_dtype=getattr(torch, g.compute_dtype),
        scale_application=g.scale_application)
    assert d["WGMMA_PATH"] == 0 and "RING_STAGES" not in d


def test_rendered_module_builds_with_the_rule_defines():
    ns: dict = {}
    exec(codegen.render_source(SEED_MXU.replace(block_m=256, k_split=2)), ns)
    d = ns["kernel_defines"](6144, 576, 7168, torch.float8_e4m3fn)
    assert d == sg.blocked_defines(block_m=256, block_n=128, block_k=128)
    assert (d["WGMMA_PATH"], d["RING_STAGES"]) == (1, 3)
    # the blocks are clamped to the problem before the rule is applied
    d = ns["kernel_defines"](256, 256, 256, torch.int8)
    assert (d["BLOCK_M"], d["STORAGE_INT8"], d["WGMMA_PATH"]) == (256, 1, 1)
    ns = {}
    exec(codegen.render_source(SEED_MXU.replace(block_m=192)), ns)
    assert ns["kernel_defines"](1024, 576, 7168, torch.float8_e4m3fn)[
        "WGMMA_PATH"] == 0
    src = _source(block_m=64)
    assert src.startswith("#define BLOCK_M 64\n")
    assert "#define WGMMA_PATH 1\n#define RING_STAGES 5\n" in src


def test_cuda_text_holds_no_copy_of_the_rule():
    """The kernel text reads the path and the ring's depth from the
    defines; it decides neither, and only refuses a wgmma build it cannot
    run."""
    code = "\n".join(line.split("//")[0] for line in
                     _build.read_csrc("scaled_gemm.cu").splitlines())
    assert not re.search(r"#\s*define\s+(WGMMA_PATH|RING_STAGES)\b", code)
    uses = [line.strip() for line in code.splitlines()
            if re.search(r"\bWGMMA_PATH\b", line)]
    assert uses == ["#ifndef WGMMA_PATH",
                    '#error "WGMMA_PATH (which blocked kernel) comes from the '
                    'caller"',
                    "#if WGMMA_PATH",
                    '#error "RING_STAGES (the ring\'s depth) comes with '
                    'WGMMA_PATH from the caller"',
                    "extern \"C\" int sg_blocked_path() { return WGMMA_PATH; }",
                    "#if WGMMA_PATH", "#if WGMMA_PATH"]
    for refusal in ("static_assert(COMPUTE_BF16 && SCALE_ACC",
                    "static_assert(WG_SUBS == 1 || WG_SUBS == 2 || WG_SUBS == 4",
                    "static_assert(RING_STAGES >= 2",
                    "static_assert(SMEM_BYTES <= SMEM_OPTIN",
                    "#ifndef RING_STAGES"):
        assert refusal in code


def test_load_library_is_keyed_by_the_defines(monkeypatch):
    built = []

    def fake_compile(source):
        built.append(source)
        return object()

    monkeypatch.setattr(_build, "compile_source", fake_compile)
    monkeypatch.setattr(sg, "_LIBRARIES", {})
    d128 = sg.blocked_defines()
    d256 = sg.blocked_defines(block_m=256)
    lib = sg.load_library(d128)
    assert sg.load_library(dict(d128)) is lib
    assert sg.load_library(dict(reversed(list(d128.items())))) is lib
    assert len(built) == 1 and built[0] == _source()
    assert sg.load_library(d256) is not lib and len(built) == 2
    mono = sg.load_library(sg.monolith_defines(torch.int8))
    assert mono is not lib and len(built) == 3
    # a module's own copy of the text is built as it is
    own = sg.load_library(d128, "// edited\n")
    assert own is not lib and built[-1].endswith("// edited\n")
    # a call rebuilds nothing: the rendered modules go through the same dict
    for g in (SEED_MXU, SEED_MONOLITH):
        assert codegen.render_source(g).count("load_library(") == 1
    assert len(built) == 4


def test_k1_module_unpadded_n_matches_jax_module():
    # N = 320 divides by 16, not by 128: the wgmma path leaves B unpadded.
    # The last 128-column block keeps its scale from the 384-wide draw.
    jp, tp = _problem(10, 256, 256, 384)
    jp = (jp[0], jp[1][:, :320], jp[2], jp[3])
    tp = (tp[0], tp[1][:, :320].contiguous(), tp[2], tp[3])
    for g in (SEED_MXU, SEED_NAIVE):
        jrun, _ = jcodegen.load_kernel(jcodegen.render_source(_jax_genome(g)))
        run, _ = codegen.load_kernel(codegen.render_source(g))
        _close(run(*tp), jrun(*jp, interpret=True))


def test_genome_has_no_tpu_axis_and_round_trips():
    assert "dimension_semantics" not in json.loads(SEED_MXU.to_json())
    g = SEED_MXU.replace(k_split=4, grid_order="nm")
    assert KernelGenome.from_json(g.to_json()) == g
    assert KernelGenome(block_m=120).validate()    # not a multiple of 16
