"""Mamba-2 SSD chunked scan for Hopper (K7).

Port of ``repro.kernels.ssd`` together with the pre-fusion its wrapper
does in ``repro.kernels.ops.ssd``: the kernel lives in ``csrc/ssd.cu``,
whose header note says what it replaces, what bounds it on the card and
how its design answers that; ``_build`` compiles it with nvcc for
``sm_90a``.  The kernel runs the scan as the four stages of the SSD
algorithm (the chunks' C Bᵀ, each chunk's own state, a pass that carries
the state across the chunks in order, the chunks' outputs), launched by
one call; the wrapper allocates their scratch (:func:`scratch_shapes`).

:func:`ssd` takes the model's operands as they come, x (B, S, H, P),
dt (B, S, H), A (H,), B and C (B, S, N), and returns ``(y, state)``: y
(B, S, H, P) in x's dtype and the final state (B, H, N, P) f32, which the
model's prefill keeps in its cache.  Its plain version,
:func:`ssd_reference`, is the port of ``repro.models.ssm.ssd_chunked``
(the decomposition the JAX model runs): chunks of :data:`CHUNK` tokens,
the last one ragged and zero-padded (dt = 0 there, so the decay stays
flat and padded tokens add nothing), instead of the JAX gcd of the prompt
length, which is 1 for a prime length.  Any chunking gives the same scan
up to f32 rounding.  The decay matrix is masked before ``exp``.

A CPU tensor runs the plain version; on a CUDA tensor the wrapper
launches the kernel or raises, and counts the launch in
``_build.LAUNCHES["ssd"]``.  On the card the kernel takes x, B and C in
bf16, dt and A in f32, P = 64 and N = 128 (mamba2-2.7b); anything else
raises.
"""
from __future__ import annotations

import functools
import math

import torch

from . import _build
from .ref import full_f32_matmul

CHUNK = 256               # tokens per chunk, the kernel's and the plain version's
CHUNKS = (64, 128, 256)   # the chunks the kernel text builds for
HEAD_DIM, D_STATE = 64, 128   # the kernel's instantiation
_INT_MAX = 2**31 - 1


def source(chunk: int = CHUNK) -> str:
    """The kernel text built for chunks of ``chunk`` tokens."""
    if chunk not in CHUNKS:
        raise ValueError(f"chunk {chunk}: the SSD kernel builds for {CHUNKS}")
    return f"#define SSD_CHUNK {chunk}\n" + _build.read_csrc("ssd.cu")


@functools.lru_cache(maxsize=None)
def _library(chunk: int = CHUNK):
    return _build.compile_source(source(chunk))


def scratch_shapes(bsz: int, s: int, h: int, chunk: int = CHUNK,
                   n: int = D_STATE, p: int = HEAD_DIM) -> dict:
    """The kernel's f32 scratch for one call: each chunk's state, overwritten
    in place by the state entering it (B, H, nc, N, P); the cumsum of dt * A
    in log2 units (B, H, nc * L); the chunks' C Bᵀ, its 16 x 16 blocks on or
    below the diagonal, 256 values each (B, nc, T(T+1)/2, 256) with T = L /
    16; and the chunks' C rows as bf16 A fragments, 16 rows by N per block
    (B, nc, T, N * 8), kept as f32 words."""
    nc = -(-s // chunk)
    t16 = chunk // 16
    return {"states": (bsz, h, nc, n, p),
            "cums": (bsz, h, nc * chunk),
            "cb": (bsz, nc, t16 * (t16 + 1) // 2, 256),
            "cfrag": (bsz, nc, t16, n * 8)}


def ssd_reference(x, dt, a, b, c, *, chunk: int = CHUNK):
    """Plain version of K7: the chunked scan in f32 (TF32 off), in chunks
    of ``chunk`` tokens.  Returns (y in x's dtype, final state (B, H, N, P)
    f32)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    nc = -(-s // chunk)
    pad = nc * chunk - s
    xf = x.float() * dt.float()[..., None]                       # dtx
    la = dt.float() * a.float()[None, None, :]                   # log-decay
    bf, cf = b.float(), c.float()
    if pad:
        xf = torch.nn.functional.pad(xf, (0, 0, 0, 0, 0, pad))
        la = torch.nn.functional.pad(la, (0, 0, 0, pad))
        bf = torch.nn.functional.pad(bf, (0, 0, 0, pad))
        cf = torch.nn.functional.pad(cf, (0, 0, 0, pad))
    xs = xf.view(bsz, nc, chunk, h, p)
    las = la.view(bsz, nc, chunk, h)
    bs = bf.view(bsz, nc, chunk, n)
    cs = cf.view(bsz, nc, chunk, n)
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    state = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    ys = []
    with full_f32_matmul():
        for i in range(nc):
            xc, bc, cc = xs[:, i], bs[:, i], cs[:, i]
            cum = las[:, i].cumsum(1)                            # (B, L, H)
            seg = cum[:, :, None, :] - cum[:, None, :, :]        # (B, L, L, H)
            # mask BEFORE exp: above the diagonal seg is large and positive
            lmat = torch.exp(seg.masked_fill(~tri[None, :, :, None],
                                             -math.inf))
            scores = torch.einsum("bln,bmn->blm", cc, bc)        # (B, L, L)
            w_intra = scores[..., None] * lmat                   # (B, L, L, H)
            y = torch.einsum("blmh,bmhp->blhp", w_intra, xc)
            y = y + torch.exp(cum)[..., None] * torch.einsum(
                "bln,bhnp->blhp", cc, state)
            decay_all = torch.exp(cum[:, -1])                    # (B, H)
            w = torch.exp(cum[:, -1:, :] - cum)                  # (B, L, H)
            state = (state * decay_all[..., None, None]
                     + torch.einsum("bln,blhp->bhnp", bc,
                                    xc * w[..., None]))
            ys.append(y)
    y = torch.cat(ys, 1)[:, :s]
    return y.to(x.dtype), state


def _check_card_operands(x, dt, a, b, c) -> None:
    """What the CUDA kernel takes: bf16 x, B, C with unit stride along
    P or N, 16-byte rows and strides that fit 32 bits; f32 dt and A."""
    for name, t in (("x", x), ("b", b), ("c", c)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} is {t.dtype}: the SSD kernel takes "
                            "bfloat16 x, b and c on the card")
        if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:-1]):
            raise ValueError(f"{name} needs unit stride along its last axis "
                             f"and other strides divisible by 8, got "
                             f"{t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    for name, t in (("dt", dt), ("a", a)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}: the SSD kernel takes "
                            "float32 dt and a")
    if a.stride(0) != 1:
        raise ValueError("a must be contiguous")
    if max(max(t.stride()) for t in (x, dt, b, c)) > _INT_MAX:
        raise ValueError("a stride above 2^31 - 1")
    p, n = x.shape[-1], b.shape[-1]
    if (p, n) != (HEAD_DIM, D_STATE):
        raise ValueError(f"head dim {p}, state {n}: the SSD kernel is built "
                         f"for P = {HEAD_DIM}, N = {D_STATE}")


def scan(x, dt, a, b, c, chunk: int = CHUNK):
    """Launch the kernel built for chunks of ``chunk`` tokens on CUDA
    operands that :func:`ssd` has checked; counted as one launch of
    ``ssd``.  :func:`ssd` calls it with :data:`CHUNK`."""
    if x.device.type != "cuda":
        raise ValueError("scan launches the CUDA kernel: the operands must "
                         "be on the card")
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    _check_card_operands(x, dt, a, b, c)
    y = torch.empty((bsz, s, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((bsz, h, n, p), dtype=torch.float32, device=x.device)
    scratch = [torch.empty(shape, dtype=torch.float32, device=x.device)
               for shape in scratch_shapes(bsz, s, h, chunk).values()]
    _build.launch("ssd", _library(chunk), "ssd_scan",
                  [x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                   c.data_ptr(), y.data_ptr(), state.data_ptr(),
                   *(t.data_ptr() for t in scratch)],
                  [bsz, s, h, p, n, chunk, x.stride(0), x.stride(1),
                   x.stride(2), *dt.stride(), b.stride(0), b.stride(1),
                   c.stride(0), c.stride(1)],
                  x.device)
    return y, state


def ssd(x, dt, a, b, c):
    """The SSD scan (K7).  x: (B, S, H, P); dt: (B, S, H) (softplus'd);
    a: (H,) negative; b, c: (B, S, N).  Returns (y (B, S, H, P) in x's
    dtype, final state (B, H, N, P) f32)."""
    if x.ndim != 4 or dt.ndim != 3 or a.ndim != 1 or b.ndim != 3:
        raise ValueError(f"shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"a {tuple(a.shape)}, b {tuple(b.shape)}: want "
                         "(B, S, H, P), (B, S, H), (H,), (B, S, N)")
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if (tuple(dt.shape) != (bsz, s, h) or tuple(a.shape) != (h,)
            or tuple(b.shape) != (bsz, s, n) or c.shape != b.shape):
        raise ValueError(f"dt {tuple(dt.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, c {tuple(c.shape)} do not fit "
                         f"x {tuple(x.shape)}")
    if s < 1:
        raise ValueError("an empty sequence has no scan")
    if any(t.device != x.device for t in (dt, a, b, c)):
        raise ValueError("x, dt, a, b and c must be on one device")
    if x.device.type == "cpu":
        return ssd_reference(x, dt, a, b, c)
    return scan(x, dt, a, b, c)
