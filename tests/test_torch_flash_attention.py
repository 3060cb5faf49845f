"""The attention kernels' plain versions (K5, K6) against the JAX package.

On a CPU tensor the port's ``kernels.ops.attention`` and
``ops.decode_attention`` run the kernels' plain versions; these tests hold
them against the JAX Pallas kernels run as the JAX tests run them
(``interpret=True``) and against the JAX oracles ``ref.*``, with the sweeps
of ``tests/test_kernels_flash_attention.py`` plus GQA, window and
non-causal cases, a ragged S (which the Pallas kernel cannot take), a
``kv_len`` above S and ``kv_len = 0``, and recurrentgemma-9b's head dim
256 (K5 with its window and GQA group 16, K6 over a ring cache read
through strides).  Tolerances are the JAX tests':
``2e-5`` in f32, ``2e-2`` in bf16 (the parity contract of ROADMAP.md).
The CUDA kernels themselves are held against these plain versions on the
card by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import scaled_gemm as sg

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(x, dtype):
    """One numpy array as a JAX and a torch array of the same values."""
    jdt, tdt, _ = DTYPES[dtype]
    j = jnp.asarray(x, jnp.float32).astype(jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _qkv(rng, b, hq, hkv, s, d, dtype, q_shape=None):
    return [_pair(rng.standard_normal(shape), dtype) for shape in
            (q_shape or (b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d))]


def _close(got, want, atol):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol)


@pytest.mark.parametrize("b,hq,hkv,s,d", [
    (1, 2, 1, 128, 64), (2, 4, 2, 256, 64), (1, 4, 4, 128, 128),
    (1, 8, 1, 128, 64),
])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 64),
                                           (False, None)])
def test_prefill_matches_jax_kernel(rng, b, hq, hkv, s, d, dtype, causal,
                                    window):
    (jq, q), (jk, k), (jv, v) = _qkv(rng, b, hq, hkv, s, d, dtype)
    want = jops.attention(jq, jk, jv, causal=causal, window=window,
                          block_q=64, block_k=64, interpret=True)
    got = ops.attention(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("s,window", [(1, None), (77, None), (200, 50),
                                      (333, None)])
def test_prefill_ragged_s_matches_oracle(rng, s, window):
    """Prompts have any length: S need not divide a block."""
    (jq, q), (jk, k), (jv, v) = _qkv(rng, 1, 4, 2, s, 64, "f32")
    want = jref.attention(jq, jk, jv, causal=True, window=window)
    _close(ops.attention(q, k, v, causal=True, window=window), want, 2e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("lens", [[100, 384, 7], [1, 383, 384]])
def test_decode_matches_jax_kernel(rng, dtype, lens):
    b, hq, hkv, s, d = 3, 4, 2, 384, 64
    (jq, q), (jk, k), (jv, v) = _qkv(rng, b, hq, hkv, s, d, dtype,
                                     q_shape=(b, hq, d))
    kv_len = np.array(lens, np.int32)
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(kv_len), block_k=128,
                                 interpret=True)
    got = ops.decode_attention(q, k, v, torch.from_numpy(kv_len))
    _close(got, want, DTYPES[dtype][2])
    _close(got, jref.decode_attention(jq, jk, jv, jnp.asarray(kv_len)),
           DTYPES[dtype][2])


def test_decode_reads_a_strided_cache(rng):
    """The engine hands K6 its (B, Smax, Hkv, D) cache transposed, as a
    view; the answer is that of the contiguous (B, Hkv, S, D) array."""
    b, hq, hkv, s, d = 2, 8, 2, 96, 64
    (jq, q), (jk, k), (jv, v) = _qkv(rng, b, hq, hkv, s, d, "f32",
                                     q_shape=(b, hq, d))
    kv_len = np.array([96, 40], np.int32)
    cache_k = k.transpose(1, 2).contiguous()          # (B, S, Hkv, D)
    cache_v = v.transpose(1, 2).contiguous()
    got = ops.decode_attention(q, cache_k.transpose(1, 2),
                               cache_v.transpose(1, 2),
                               torch.from_numpy(kv_len))
    _close(got, jref.decode_attention(jq, jk, jv, jnp.asarray(kv_len)), 2e-5)


def test_decode_kv_len_above_s_sees_every_position(rng):
    """An idle serving slot counts past S: the length is clamped to S, as
    the JAX oracle's ``arange(S) < kv_len`` and the Pallas kernel give."""
    b, hq, hkv, s, d = 2, 4, 2, 128, 64
    (jq, q), (jk, k), (jv, v) = _qkv(rng, b, hq, hkv, s, d, "f32",
                                     q_shape=(b, hq, d))
    kv_len = np.array([129, 4000], np.int32)
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(kv_len), block_k=64,
                                 interpret=True)
    _close(ops.decode_attention(q, k, v, torch.from_numpy(kv_len)), want, 2e-5)
    full = jref.decode_attention(jq, jk, jv, jnp.full((b,), s, jnp.int32))
    _close(ops.decode_attention(q, k, v, torch.from_numpy(kv_len)), full, 2e-5)


def test_decode_kv_len_zero_gives_zeros_as_the_pallas_kernel(rng):
    b, hq, hkv, s, d = 2, 4, 2, 128, 64
    (jq, q), (jk, k), (jv, v) = _qkv(rng, b, hq, hkv, s, d, "f32",
                                     q_shape=(b, hq, d))
    kv_len = np.array([0, 50], np.int32)
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(kv_len), block_k=64,
                                 interpret=True)
    got = ops.decode_attention(q, k, v, torch.from_numpy(kv_len))
    assert not got[0].any()
    _close(got, want, 2e-5)
    # the oracle, as the JAX one, has no key to attend to there: NaN
    assert torch.isnan(ref.decode_attention(q, k, v,
                                            torch.from_numpy(kv_len))[0]).all()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("window", [48, 128])
def test_prefill_head_dim_256_window_group_16_matches_jax_kernel(rng, dtype,
                                                                 window):
    """recurrentgemma-9b's local attention: 16 query heads on one KV head
    of 256, causal, a sliding window shorter and no shorter than S."""
    (jq, q), (jk, k), (jv, v) = _qkv(rng, 1, 16, 1, 128, 256, dtype)
    want = jops.attention(jq, jk, jv, causal=True, window=window,
                          block_q=64, block_k=64, interpret=True)
    got = ops.attention(q, k, v, causal=True, window=window)
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_head_dim_256_over_a_strided_ring_matches_jax_kernel(rng,
                                                                    dtype):
    """recurrentgemma-9b's decode: a (B, W, Hkv, D) ring handed over
    transposed, as a view; valid counts of 1, a partial ring and the whole
    ring."""
    b, hq, hkv, w, d = 3, 16, 1, 128, 256
    (jq, q), (jk, k), (jv, v) = _qkv(rng, b, hq, hkv, w, d, dtype,
                                     q_shape=(b, hq, d))
    ring_k = k.transpose(1, 2).contiguous()            # (B, W, Hkv, D)
    ring_v = v.transpose(1, 2).contiguous()
    n_valid = np.array([1, 77, w], np.int32)
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(n_valid),
                                 block_k=64, interpret=True)
    got = ops.decode_attention(q, ring_k.transpose(1, 2),
                               ring_v.transpose(1, 2),
                               torch.from_numpy(n_valid))
    _close(got, want, DTYPES[dtype][2])


def test_decode_split_follows_the_block_shared_memory():
    """256 keys a block at D = 128; at D = 256 their tiles would need
    270,336 bytes, above the 232,448 a block may have, so 128."""
    assert fa.decode_smem_bytes(128, 256) == 139264
    assert fa.decode_smem_bytes(256, 256) == 270336 > sg.SMEM_OPTIN
    assert fa.decode_smem_bytes(256, 128) == 135168
    assert fa.decode_split(128) == 256 and fa.decode_split(256) == 128
    with pytest.raises(ValueError, match="no K6 split"):
        fa.decode_split(1024)


def test_oracles_match_jax_oracles(rng):
    (jq, q), (jk, k), (jv, v) = _qkv(rng, 2, 4, 2, 100, 32, "f32")
    _close(ref.attention(q, k, v, causal=True, window=30),
           jref.attention(jq, jk, jv, causal=True, window=30), 2e-5)
    _close(ref.attention(q, k, v, causal=False),
           jref.attention(jq, jk, jv, causal=False), 2e-5)


def test_cpu_tensors_launch_nothing(rng):
    (_, q), (_, k), (_, v) = _qkv(rng, 1, 2, 1, 64, 64, "bf16")
    _build.reset_launches()
    ops.attention(q, k, v)
    ops.decode_attention(q[:, :, 0], k, v, torch.tensor([5]))
    assert sum(_build.LAUNCHES.values()) == 0


@pytest.mark.parametrize("bad", ["q_rank", "gqa", "window", "kv_len_shape",
                                 "kv_len_float"])
def test_wrappers_refuse_malformed_operands(bad):
    q = torch.zeros(1, 4, 16, 64)
    k = torch.zeros(1, 2, 16, 64)
    if bad == "q_rank":
        with pytest.raises(ValueError):
            fa.flash_attention(q[0], k, k)
    elif bad == "gqa":
        with pytest.raises(ValueError):
            fa.flash_attention(torch.zeros(1, 3, 16, 64), k, k)
    elif bad == "window":
        with pytest.raises(ValueError):
            fa.flash_attention(q, k, k, window=0)
    elif bad == "kv_len_shape":
        with pytest.raises(ValueError):
            fa.decode_attention(q[:, :, 0], k, k, torch.tensor([1, 2]))
    else:
        with pytest.raises(ValueError):
            fa.decode_attention(q[:, :, 0], k, k, torch.tensor([1.0]))


@pytest.mark.parametrize("bad,exc", [("f32", TypeError),
                                     ("d_stride", ValueError),
                                     ("odd_stride", ValueError),
                                     ("head_dim", ValueError)])
def test_card_operand_contract(bad, exc):
    """What a CUDA tensor must satisfy before a launch (checked here on
    CPU tensors, as the wrappers check it before calling the card)."""
    x = torch.zeros(1, 2, 32, 128, dtype=torch.bfloat16)
    d = 128
    if bad == "f32":
        x = x.float()
    elif bad == "d_stride":
        x = torch.zeros(1, 2, 128, 32, dtype=torch.bfloat16).transpose(2, 3)
    elif bad == "odd_stride":
        x = torch.zeros(1, 2, 32, 132, dtype=torch.bfloat16)[..., :128]
    else:
        x, d = x[..., :80].contiguous(), 80
    with pytest.raises(exc):
        fa._check_card_operands({"q": x}, d)
    for ok in (128, 256):       # the head dims the kernels are built for
        fa._check_card_operands(
            {"q": torch.zeros(1, 2, 32, ok, dtype=torch.bfloat16)}, ok)


@pytest.mark.parametrize("s", [1, 31, 128, 4096, 4097])
@pytest.mark.parametrize("split", fa.DECODE_SPLITS)
def test_decode_split_plan_covers_every_position_once(s, split):
    plan = fa.decode_split_plan(s, split)
    covered = [pos for lo, hi in plan for pos in range(lo, hi)]
    assert covered == list(range(s))           # each once, in merge order
    assert all(hi - lo <= split for lo, hi in plan)
    shapes = fa.decode_scratch_shapes(8, 16, 2, s, 128, split)
    assert shapes == {"o": (16, len(plan), 8, 128), "ml": (16, len(plan), 8, 2)}


def test_decode_split_merge_matches_the_plain_version(rng):
    """K6's arithmetic on the CPU: each split's (max, sum, unnormalised
    rows) over the keys of its range below kv_len, empty splits as (-inf,
    0), merged in split order."""
    b, hq, hkv, s, d, split = 3, 8, 2, 300, 32, 128
    (_, q), (_, k), (_, v) = _qkv(rng, b, hq, hkv, s, d, "f32",
                                  q_shape=(b, hq, d))
    kv_len = torch.tensor([129, 0, 300])
    group = hq // hkv
    out = torch.zeros(b, hq, d)
    for bi in range(b):
        for h in range(hq):
            n = min(int(kv_len[bi]), s)
            parts = []
            for lo, hi in fa.decode_split_plan(s, split):
                hi = min(hi, n)
                if lo >= hi:
                    parts.append((-np.inf, 0.0, torch.zeros(d)))
                    continue
                sc = (k[bi, h // group, lo:hi] @ q[bi, h]) / np.sqrt(d)
                m = sc.max()
                p = torch.exp(sc - m)
                parts.append((m, p.sum(), p @ v[bi, h // group, lo:hi]))
            mx = max(m for m, _, _ in parts)
            num, den = torch.zeros(d), 0.0
            for m, l, o in parts:
                if l > 0:
                    num, den = num + o * torch.exp(m - mx), den + l * torch.exp(m - mx)
            out[bi, h] = num / den if den > 0 else 0.0
    want = fa.decode_attention_reference(q, k, v, kv_len)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=2e-5)


def test_decode_card_launcher_refuses_cpu_tensors(rng):
    (_, q), (_, k), (_, v) = _qkv(rng, 1, 2, 1, 64, 128, "bf16",
                                  q_shape=(1, 2, 128))
    _build.reset_launches()
    with pytest.raises(ValueError, match="on the card"):
        fa.decode_at_split(q, k, v, torch.tensor([5]), fa.DECODE_SPLIT)
    with pytest.raises(ValueError, match="K6 takes"):
        fa.decode_split_plan(64, 64)
    assert sum(_build.LAUNCHES.values()) == 0
