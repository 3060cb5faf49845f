"""The 'findings' knowledge base (paper §3: the LLM-digested hardware notes).

Port of ``repro.core.knowledge``, re-derived for one NVIDIA H100.  The
paper bootstraps from an LLM-authored findings document that summarises
hardware quirks, external blog posts, and vendor manuals into a form the
Experiment Designer can consume.  This module is that document for the
H100 and the kernel template of ``csrc/scaled_gemm.cu``, plus the **avenue
catalog**: the menu of optimization directions, each with the MI300 avenue
it descends from (paper A.2) and its genome edits.  The TPU-only
``dimension_semantics`` avenue has no Hopper counterpart and is gone.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from .genome import H100, SCALE_BLOCK, KernelGenome

FINDINGS_DOCUMENT = f"""\
# Findings: NVIDIA H100 SXM for block-scaled GEMM (digested hardware notes)

Target: C[bf16][M,N] = dequant(A[fp8][M,K]) @ dequant(B[fp8][K,N]),
a_scale per (row, 128-K-block), b_scale per (128x128)-block, f32 accumulate.
(Numbers from the H100 SXM data sheet.)

## Memory hierarchy
- HBM3: 80 GB @ {H100['hbm_bytes_per_s'] / 1e12:.2f} TB/s; L2 50 MB shared by
  all {H100['sms']} SMs.
- Shared memory: up to {H100['smem_per_block_optin']} bytes per block (opt-in
  above 48 KB), carved from each SM's 256 KB with L1.
- Two blocked kernels; the genome picks one at compile time.
  * The wgmma path, the MXU seed's family: compute_dtype bfloat16,
    scale_application scale_acc, and a tile of one, two or four 64x128
    sub-tiles (64x128, 128x128, 256x128, 64x256, 128x256).  TMA brings raw
    fp8 (or int8) bytes, one 128-K block of A and of B per stage, into a
    ring as deep as fits (at most 8 stages of 128*(block_m + 2*block_n)
    bytes: B is kept as it came and transposed in shared memory into the
    K-major layout that wgmma needs for 8-bit operands).  Its shared memory
    does not depend on block_k; block_k only sets the split-K slicing and
    the padding of K.
  * The mma.sync path, every other genome: compute_dtype float32 (the
    naive seed), dequant_inputs, and every other tile (192x128, 256x256,
    tiles not made of 64x128 sub-tiles).  It stages one (block_m x
    block_k) A slab and one (block_k x block_n) B slab per K step in the
    compute dtype (bf16: 2 bytes, f32: 4 bytes); a configuration whose
    slabs do not fit is refused at launch (the LDS-capacity analogue).
- Registers: a wgmma-path consumer warpgroup keeps the f32 sums of at most
  two 64x128 sub-tiles and one 128-K partial, 232 registers a thread; a
  larger tile, or three sub-tiles (192x128) that do not divide between two
  consumers, runs the mma.sync path, whose 256 threads hold
  block_m*block_n/256 sums each (beyond 128x128 they spill).

## Compute
- Tensor cores: {H100['fp8_flops'] / 1e12:.0f} TFLOP/s dense fp8 and int8,
  {H100['bf16_flops'] / 1e12:.0f} bf16.  fp8 e4m3 and int8 values are exact
  inputs of the fp8/int8 tensor cores, so under scale_acc the wgmma path
  multiplies the stored bytes directly (wgmma m64n128k32 e4m3, or s8 with
  an exact s32 sum) and its least time is 2MNK / {H100['fp8_flops'] / 1e12:.0f}
  TFLOP/s; the Matrix-Core-fragment analogue of MI300's MFMA 32x32x16 fp8.
- 'scale_acc' adds each 128-K partial, times its row scale and column-block
  scale, to the f32 sums in registers: the tensor cores' short internal
  accumulation is promoted every 128 K.  'dequant_inputs' multiplies every
  staged element by its scale and rounds it to the compute dtype before the
  product: bf16 mma.sync m16n8k16, at half the fp8 rate at best.
- An f32 compute dtype runs on the FMA units
  ({H100['f32_flops'] / 1e12:.0f} TFLOP/s): ~30x below the fp8 tensor cores.

## Grid
- wgmma path: a persistent grid of at most {H100['sms']} blocks walks the
  work units (output tile x split-K slice); one producer warp issues the
  TMA loads, three warps transpose B, one or two consumer warpgroups
  multiply.  Fewer units than SMs leave SMs idle: at M=1024 and 128x128
  tiles a narrow N gives only a few dozen tiles, which split-K multiplies.
- mma.sync path: one block per (block_m, block_n) output tile, 256
  threads; split-K adds slices of the K loop as more blocks.
- Split-K writes f32 partials that a second pass sums in slice order (no
  atomics): M*N*4 bytes written and read again per slice.
- grid_order mn walks N fastest, nm walks M fastest; which operand
  neighbouring tiles share in L2 changes with it.
- Device and L2 traffic: A is read (N/block_n) times, B (M/block_m) times,
  less what L2 catches => bytes ~ M*K*(N/bn) + K*N*(M/bm) + 2*M*N.  On the
  wgmma path the work per 128-K block bounds it more than this traffic:
  the transpose of B in shared memory, the scaling of each partial, the
  stage handoffs and the epilogue.  A taller tile (256x128) spreads the
  transpose of B over twice the products.
"""


@dataclasses.dataclass(frozen=True)
class Avenue:
    """One optimization direction: MI300 origin -> Hopper genome edit."""

    name: str
    mi300_origin: str       # the paper-avenue this descends from (A.2)
    description: str        # what the Designer writes in its avenue list
    innovation_prior: int   # 0-100, how structurally novel the change is
    edits: Callable[[KernelGenome], list]   # genome -> [(rubric, new_genome)]


def _tile_edits(g: KernelGenome) -> list:
    out = []
    if g.style != "blocked":
        base = KernelGenome(style="blocked", block_m=128, block_n=128, block_k=128)
        return [("Re-structure as a blocked tensor-core kernel with 128^3 "
                 "tiles: fp8 wgmma fed by a TMA ring, f32 sums in registers, "
                 "K loop inside the block.", base)]
    for attr in ("block_m", "block_n", "block_k"):
        cur = getattr(g, attr)
        for nxt in (cur * 2, cur // 2):
            if nxt < 128 or nxt > 2048:
                continue
            cand = g.replace(**{attr: nxt})
            if not cand.validate():
                out.append((
                    f"Change {attr} from {cur} to {nxt}, keeping the other tile "
                    f"dims fixed; re-check which kernel path the tile takes, "
                    f"that its stages or slabs stay within the shared memory "
                    f"of one block and all tile dims remain multiples of "
                    f"{SCALE_BLOCK}.",
                    cand))
    return out


def _grid_order_edits(g: KernelGenome) -> list:
    if g.style != "blocked":
        return []
    nxt = "nm" if g.grid_order == "mn" else "mn"
    return [(
        f"Swap the block walk order from {g.grid_order!r} to {nxt!r} so "
        f"neighbouring blocks share {'A' if nxt == 'mn' else 'B'} tiles in L2 "
        "instead; isolate the traffic effect with unchanged tile sizes.",
        g.replace(grid_order=nxt))]


def _scale_edits(g: KernelGenome) -> list:
    if g.style != "blocked":
        return []
    nxt = ("dequant_inputs" if g.scale_application == "scale_acc" else "scale_acc")
    return [(
        f"Move scale application from {g.scale_application!r} to {nxt!r}: "
        + ("dequantize A/B elements while staging them in shared memory, "
           "before the tensor-core products."
           if nxt == "dequant_inputs" else
           "multiply the raw (exactly-representable) fp8 values on the fp8 "
           "tensor cores (the wgmma path) and apply a_scale (per row) and "
           "b_scale (per column-block) to the f32 partial sums in registers "
           "once per 128-wide K sub-block."),
        g.replace(scale_application=nxt))]


def _dtype_edits(g: KernelGenome) -> list:
    if g.style != "blocked":
        return []
    nxt = "float32" if g.compute_dtype == "bfloat16" else "bfloat16"
    return [(
        f"Switch the compute dtype to {nxt}: "
        + ("full-precision FMA products remove any bf16 rounding concern at "
           "a large throughput cost." if nxt == "float32" else
           "fp8 e4m3 values are exact tensor-core inputs, so the "
           "tensor-core path (fp8 wgmma under scale_acc, bf16 mma.sync "
           "under dequant_inputs) is numerically free."),
        g.replace(compute_dtype=nxt))]


def _ksplit_edits(g: KernelGenome) -> list:
    if g.style != "blocked":
        return []
    out = []
    for nxt in (g.k_split * 2, max(1, g.k_split // 2)):
        if nxt == g.k_split or nxt > 8:
            continue
        cand = g.replace(k_split=nxt)
        if not cand.validate():
            out.append((
                f"Set split-K factor to {nxt}: partition the K loop over "
                f"{nxt} slices of blocks with a separate f32 partial-sum "
                "buffer and a final reduction pass, trading an extra M*N*4-byte "
                "round-trip per slice for more blocks on small-M shapes.",
                cand))
    return out


AVENUES: tuple = (
    Avenue(
        name="tile_sizes",
        mi300_origin="Fine-tune Tile Sizes (TB_M, TB_N, TB_K)",
        description="Systematically vary the block tile sizes; bigger output "
                    "tiles cut device-memory re-reads until shared memory or "
                    "registers run out.",
        innovation_prior=25,
        edits=_tile_edits,
    ),
    Avenue(
        name="grid_order",
        mi300_origin="Optimized LDS Layout / iteration order",
        description="Swap which output axis neighbouring blocks walk, "
                    "changing which operand they share in L2.",
        innovation_prior=40,
        edits=_grid_order_edits,
    ),
    Avenue(
        name="scale_application",
        mi300_origin="Optimize Scale Application Loop / LDS scale caching",
        description="Apply quantization scales to the register sums per "
                    "128-K sub-block instead of dequantizing every staged "
                    "element (or vice versa).",
        innovation_prior=70,
        edits=_scale_edits,
    ),
    Avenue(
        name="compute_dtype",
        mi300_origin="MFMA fragment dtype selection (fp8 32x32x16)",
        description="Choose the product dtype: bf16 through the tensor cores "
                    "(exact for e4m3) vs f32 on the FMA units (slow path).",
        innovation_prior=55,
        edits=_dtype_edits,
    ),
    Avenue(
        name="split_k",
        mi300_origin="Increase Thread Block Occupancy",
        description="Split the K loop across more blocks to fill the "
                    f"{H100['sms']} SMs on small-M shapes.",
        innovation_prior=85,
        edits=_ksplit_edits,
    ),
)

# Static avenue ideas that the Designer lists but whose edits are covered by
# the catalog above (kept for prompt fidelity: the paper always lists ~10).
EXTRA_AVENUE_TEXTS = (
    "Pad global inputs so M/N/K are multiples of the tiles before the kernel "
    "(the module's run() pads and slices back).",
    "Vectorized global loads: 16 bytes per thread, neighbouring threads on "
    "neighbouring addresses.",
    "Fuse the bf16 output cast into the register epilogue instead of a "
    "separate pass.",
    "Store the output tile with TMA so that the epilogue overlaps the next "
    "tile's products.",
    "Overlap the scaling of one 128-K partial with the next block's wgmma "
    "(a second partial accumulator in registers).",
)
