"""Flash attention for Hopper: prefill (K5) and one-token decode (K6).

Port of ``repro.kernels.flash_attention``.  Both kernels live in
``csrc/flash_attention.cu``, whose header note says what each replaces,
what bounds it on the card and how its design answers that; ``_build``
compiles it with nvcc for ``sm_90a``.

* :func:`flash_attention` (K5) — causal, sliding-window or unmasked
  attention over a prompt; any S (the ragged edge is masked in the kernel).
* :func:`decode_attention` (K6) — one new token per row against a KV cache
  given by strides, of which the first ``kv_len[b]`` positions are valid.
  ``kv_len`` is clamped to ``[0, S]``; ``kv_len = 0`` gives zeros, as the
  Pallas kernel does.  The kernel splits each row's keys across blocks
  (:func:`decode_split_plan`) and merges their partials in a second kernel
  of the same launch; the wrapper allocates the partials
  (:func:`decode_scratch_shapes`).

Each has its plain PyTorch version here (:func:`attention_reference`,
:func:`decode_attention_reference`): the f32 oracles of ``ref`` (TF32 off)
with the kernels' treatment of ``kv_len``.  The kernels round the
probabilities to bf16 for the PV product; the plain versions do not, which
the JAX tests' bf16 tolerance (2e-2) covers.  A wrapper takes the plain version only for
tensors on the CPU; for a CUDA tensor it launches the kernel or raises, and
counts the launch in ``_build.LAUNCHES``.  On the card both kernels take
bf16 only (an f32 input raises ``TypeError``) and the head dims of the
served configs, 128 (the dense family) and 256 (recurrentgemma-9b);
another head dim raises ``ValueError``.  K6 splits the keys by the largest
of :data:`DECODE_SPLITS` up to :data:`DECODE_SPLIT` whose tiles fit a
block's shared memory (:func:`decode_split`): 256 at D = 128, 128 at
D = 256.
"""
from __future__ import annotations

import functools
import math

import torch

from . import _build, ref
from . import scaled_gemm as _sg

HEAD_DIMS = (128, 256)    # the kernels' instantiations
MAX_GROUP = 16            # GQA group rows of one mma.sync tile (K6)
DECODE_SPLIT = 256        # keys per K6 block (timed against 128: PERF.md)
DECODE_SPLITS = (128, 256)    # the splits K6 takes (4 warps x 32 keys, smem)
_INT_MAX = 2**31 - 1


def decode_smem_bytes(d: int, split: int) -> int:
    """K6's dynamic shared memory for one block: the K and V tiles of its
    ``split`` keys (rows of D + 8 bf16), or the warps' merge buffers if
    larger (``launch_decode`` in the CUDA text)."""
    tiles = split * 2 * (d + 8) * 2
    merge = 4 * 16 * (d + 2) * 4
    return max(tiles, merge)


def decode_split(d: int) -> int:
    """The split K6 runs at head dim ``d``: the largest of
    ``DECODE_SPLITS`` up to ``DECODE_SPLIT`` whose block fits."""
    fits = [s for s in DECODE_SPLITS
            if s <= DECODE_SPLIT
            and decode_smem_bytes(d, s) <= _sg.SMEM_OPTIN]
    if not fits:
        raise ValueError(f"no K6 split fits a block at head dim {d}")
    return max(fits)


def _scale(d: int, scale) -> float:
    return float(scale) if scale is not None else 1.0 / math.sqrt(d)


def _check_card_operands(tensors: dict, d: int) -> None:
    """What the CUDA kernels need: bf16, unit stride along D, 16-byte rows
    and strides that fit the kernels' 32-bit stride arguments."""
    for name, t in tensors.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} is {t.dtype}: the attention kernels take "
                            "bfloat16 on the card")
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1]):
            raise ValueError(f"{name} needs unit stride along D and other "
                             f"strides divisible by 8, got {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
        if max(t.stride()) > _INT_MAX:
            raise ValueError(f"{name} has a stride above 2^31 - 1")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported on the card "
                         f"(kernels for {HEAD_DIMS})")


@functools.lru_cache(maxsize=None)
def _library():
    """The built library, looked up once per process: a decode tick
    launches K6 once per layer, and hashing the source each time costs."""
    return _build.compile_source(_build.read_csrc("flash_attention.cu"))


# ---------------------------------------------------------------- prefill
def attention_reference(q, k, v, *, causal: bool = True, window=None,
                        scale=None):
    """Plain version of K5: the oracle ``ref.attention``.  Every row of a
    prompt sees at least its own key (causal or not, windowed or not), so
    no row is empty and the oracle needs no zero guard here."""
    return ref.attention(q, k, v, causal=causal, window=window, scale=scale)


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    scale=None):
    """Prefill attention (K5).  q: (B, Hq, S, D); k, v: (B, Hkv, S, D) with
    Hq % Hkv == 0 (GQA); ``window``: token i sees keys (i - window, i]."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: want (B, H, S, D)")
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, s, d) or hq % hkv:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window={window} must be >= 1")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must be on one device")
    if q.device.type == "cpu":
        return attention_reference(q, k, v, causal=causal, window=window,
                                   scale=scale)
    _check_card_operands({"q": q, "k": k, "v": v}, d)
    out = torch.empty((b, hq, s, d), dtype=q.dtype, device=q.device)
    _build.launch("flash_attention", _library(), "fa_prefill",
                  [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()],
                  [b, hq, hkv, s, d, int(causal), window or 0,
                   *q.stride()[:3], *k.stride()[:3], *v.stride()[:3]],
                  q.device, floats=[_scale(d, scale)])
    return out


# ----------------------------------------------------------------- decode
def decode_attention_reference(q, k, v, kv_len, *, scale=None):
    """Plain version of K6: the oracle ``ref.decode_attention`` with
    ``kv_len`` clamped to [0, S] and zeros where ``kv_len = 0`` (the
    oracle's NaN there), as the kernel and the Pallas kernel give."""
    lens = kv_len.to(q.device).long().clamp(0, k.shape[2])
    out = ref.decode_attention(q, k, v, lens, scale=scale)
    return torch.where((lens > 0)[:, None, None], out, 0.0)


def decode_split_plan(s: int, split: int = DECODE_SPLIT) -> list:
    """K6's blocks along a cache of ``s`` positions: the key range [lo, hi)
    of each, in the order its partials are merged.  A block takes the
    positions of its range below its row's ``kv_len``."""
    if split not in DECODE_SPLITS:
        raise ValueError(f"split {split}: K6 takes {DECODE_SPLITS}")
    return [(lo, min(lo + split, s)) for lo in range(0, s, split)]


def decode_scratch_shapes(b: int, hq: int, hkv: int, s: int, d: int,
                          split: int = DECODE_SPLIT) -> dict:
    """K6's f32 partials for one call: per (row, KV head) and block, the
    group's unnormalised output rows (``o``) and their max and sum
    (``ml``)."""
    n = len(decode_split_plan(s, split))
    return {"o": (b * hkv, n, hq // hkv, d), "ml": (b * hkv, n, hq // hkv, 2)}


def decode_at_split(q, k, v, kv_len, split: int, *, scale=None):
    """Launch K6 with ``split`` keys per block on CUDA operands that
    :func:`decode_attention` has checked; counted as one launch of
    ``decode_attention``, which calls it with :func:`decode_split`.  A
    split whose tiles exceed the block's shared memory is refused by the
    card (``_build.LaunchRefusedError``)."""
    if q.device.type != "cuda":
        raise ValueError("decode_at_split launches the CUDA kernel: the "
                         "operands must be on the card")
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    _check_card_operands({"q": q, "k": k, "v": v}, d)
    shapes = decode_scratch_shapes(b, hq, hkv, s, d, split)
    lens = kv_len.to(torch.int32).contiguous()
    out = torch.empty((b, hq, d), dtype=q.dtype, device=q.device)
    part_o = torch.empty(shapes["o"], dtype=torch.float32, device=q.device)
    part_ml = torch.empty(shapes["ml"], dtype=torch.float32, device=q.device)
    _build.launch("decode_attention", _library(), "fa_decode",
                  [q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
                   out.data_ptr(), part_o.data_ptr(), part_ml.data_ptr()],
                  [b, hq, hkv, s, d, split, *q.stride()[:2], *k.stride()[:3],
                   *v.stride()[:3]],
                  q.device, floats=[_scale(d, scale)])
    return out


def decode_attention(q, k, v, kv_len, *, scale=None):
    """One-token decode attention (K6).  q: (B, Hq, D); k, v: (B, Hkv, S, D),
    any strides with unit stride along D; kv_len: (B,) integer lengths."""
    if q.ndim != 3 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: want (B, Hq, D), (B, Hkv, S, D)")
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    if (k.shape[0], k.shape[3]) != (b, d) or hq % hkv:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if tuple(kv_len.shape) != (b,) or kv_len.is_floating_point():
        raise ValueError(f"kv_len must be (B,) integers, got "
                         f"{tuple(kv_len.shape)} {kv_len.dtype}")
    if (k.device != q.device or v.device != q.device
            or kv_len.device != q.device):
        raise ValueError("q, k, v and kv_len must be on one device")
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, kv_len, scale=scale)
    if hq // hkv > MAX_GROUP:
        raise ValueError(f"GQA group {hq // hkv} above {MAX_GROUP}")
    return decode_at_split(q, k, v, kv_len, decode_split(d), scale=scale)
