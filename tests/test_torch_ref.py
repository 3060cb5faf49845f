"""Port oracles (repro_torch.kernels.ref) against the JAX oracles.

Inputs are numpy normals from a fixed seed, handed to both frameworks.
Tolerances:
  * quantization: byte for byte (compared as uint8) and scales exactly;
  * the scaled-GEMM oracle: 0.02 * max|ref|, the JAX tests' tolerance
    (tests/test_kernels_scaled_gemm.py); both sides are f32 products
    rounded to bf16, so they agree to a bf16 rounding step in practice;
  * ragged shapes: exactly equal to the zero-padded aligned computation
    sliced back (same arithmetic on the same numbers).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref

DTYPES = [(jnp.float8_e4m3fn, torch.float8_e4m3fn), (jnp.int8, torch.int8)]


def _bytes(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(128, 128), (256, 512), (384, 256)])
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_quantize_blockwise_bytes_match_jax(shape, jdt, tdt):
    x = _normal(1, *shape)
    jq, js = jref.quantize_blockwise(jnp.asarray(x), jdt)
    tq, ts = ref.quantize_blockwise(torch.from_numpy(x), tdt)
    np.testing.assert_array_equal(_bytes(tq), _bytes(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("shape", [(128, 128), (256, 512), (384, 256)])
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_quantize_blockwise_2d_bytes_match_jax(shape, jdt, tdt):
    x = _normal(2, *shape)
    jq, js = jref.quantize_blockwise_2d(jnp.asarray(x), jdt)
    tq, ts = ref.quantize_blockwise_2d(torch.from_numpy(x), tdt)
    np.testing.assert_array_equal(_bytes(tq), _bytes(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _both_problems(seed, m, k, n, jdt, tdt):
    a, b = _normal(seed, m, k), _normal(seed + 1, k, n)
    jp = (*jref.quantize_blockwise(jnp.asarray(a), jdt),
          *jref.quantize_blockwise_2d(jnp.asarray(b), jdt))
    tp = (*ref.quantize_blockwise(torch.from_numpy(a), tdt),
          *ref.quantize_blockwise_2d(torch.from_numpy(b), tdt))
    # (aq, a_s, bq, b_s) -> (aq, bq, a_s, b_s)
    return (jp[0], jp[2], jp[1], jp[3]), (tp[0], tp[2], tp[1], tp[3])


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 384, 128),
                                   (128, 512, 256), (384, 256, 384)])
@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_oracle_matches_jax(m, k, n, jdt, tdt):
    jp, tp = _both_problems(3, m, k, n, jdt, tdt)
    want = np.asarray(jref.scaled_gemm(*jp).astype(jnp.float32))
    got = ref.scaled_gemm(*tp).float().numpy()
    assert got.shape == want.shape == (m, n)
    np.testing.assert_allclose(got, want, atol=0.02 * np.abs(want).max())


def test_ragged_n_equals_padded_aligned_computation():
    k, n = 256, 192
    a, b = _normal(4, 128, k), _normal(5, k, n)
    b_pad = np.zeros((k, 256), np.float32)
    b_pad[:, :n] = b
    bq, b_s = ref.quantize_blockwise_2d(torch.from_numpy(b))
    bq_pad, b_s_pad = ref.quantize_blockwise_2d(torch.from_numpy(b_pad))
    assert tuple(b_s.shape) == (2, 2)
    np.testing.assert_array_equal(_bytes(bq), _bytes(bq_pad[:, :n]))
    np.testing.assert_array_equal(b_s.numpy(), b_s_pad.numpy())
    aq, a_s = ref.quantize_blockwise(torch.from_numpy(a))
    got = ref.scaled_gemm(aq, bq, a_s, b_s)
    want = ref.scaled_gemm(aq, bq_pad.contiguous(), a_s, b_s_pad)[:, :n]
    np.testing.assert_array_equal(got.float().numpy(), want.float().numpy())


def test_ragged_challenge_width_576_quantizes():
    x = _normal(6, 256, 576)
    q, s = ref.quantize_blockwise_2d(torch.from_numpy(x))
    assert tuple(q.shape) == (256, 576) and tuple(s.shape) == (2, 5)
    # the last scale block covers 64 real columns: its scale is their max
    want = np.abs(x[:128, 512:]).max() / 448.0
    np.testing.assert_allclose(s[0, 4].item(), want, rtol=1e-6)
