"""The SSD scan's plain version (K7) against the JAX package.

On a CPU tensor the port's ``kernels.ops.ssd`` and ``kernels.ssd.ssd``
run the kernel's plain version (the port of ``repro.models.ssm.
ssd_chunked``, chunked by ``ssd.CHUNK`` with a ragged last chunk).  These
tests hold it against the JAX Pallas kernel run as the JAX tests run it
(``interpret=True``, the shapes of ``tests/test_kernels_ssd.py``), against
the JAX sequential oracle ``ref.ssd`` for ragged lengths and for a slow
decay, whose state spans many chunks, and hold its final state against
``ssd_chunked``'s.  Tolerance: the JAX tests' ``atol 5e-4, rtol 1e-3``
(the parity contract of ROADMAP.md).  The CUDA kernel itself is held
against this plain version on the card by chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.ssm import ssd_chunked
from repro_torch.kernels import _build, ops, ref, ssd

TOL = dict(atol=5e-4, rtol=1e-3)


def _inputs(rng, b, s, h, p, n, slow=False):
    """Numpy inputs drawn as ``tests/test_kernels_ssd.py`` draws them; with
    ``slow``, dt * |A| lies in [1e-3, 1e-2] per token, so the state carries
    across many chunks."""
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    if slow:
        dt = rng.uniform(0.5, 1.0, (b, s, h)).astype(np.float32)
        a = -np.linspace(2e-3, 1e-2, h).astype(np.float32)
    else:
        dt = np.asarray(jax.nn.softplus(jnp.asarray(
            rng.standard_normal((b, s, h)), jnp.float32)))
        a = -np.exp(rng.standard_normal((h,)).astype(np.float32) * 0.5)
    bm = (rng.standard_normal((b, s, n)) / np.sqrt(n)).astype(np.float32)
    cm = (rng.standard_normal((b, s, n)) / np.sqrt(n)).astype(np.float32)
    return x, dt, a, bm, cm


def _both(arrays):
    return ([jnp.asarray(v) for v in arrays],
            [torch.from_numpy(np.array(v)) for v in arrays])


def _no_carry(t):
    """The scan with the state dropped between chunks of ``ssd.CHUNK``:
    what a kernel that lost its carry would give (y, last chunk's state)."""
    x, dt, a, b, c = t
    parts = [ssd.ssd_reference(x[:, i:i + ssd.CHUNK], dt[:, i:i + ssd.CHUNK],
                               a, b[:, i:i + ssd.CHUNK], c[:, i:i + ssd.CHUNK])
             for i in range(0, x.shape[1], ssd.CHUNK)]
    return torch.cat([y for y, _ in parts], 1), parts[-1][1]


def _far(got, want):
    """got misses want by far more than the tolerance."""
    err = np.abs(got.numpy() - np.asarray(want))
    assert (err > 20 * (TOL["atol"] + TOL["rtol"] * np.abs(want))).any()


def _close(got, want):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 128, 2, 32, 32, 32), (2, 256, 4, 32, 64, 64), (1, 64, 2, 64, 16, 64),
])
def test_ssd_matches_jax_kernel(rng, b, s, h, p, n, chunk):
    j, t = _both(_inputs(rng, b, s, h, p, n))
    want = jops.ssd(*j, chunk=chunk, interpret=True)
    got = ops.ssd(*t)
    assert got.dtype == torch.float32
    _close(got, want)


def test_ssd_with_skip_matches_jax_kernel(rng):
    j, t = _both(_inputs(rng, 1, 128, 2, 32, 32))
    d_skip = rng.standard_normal((2,)).astype(np.float32)
    want = jops.ssd(*j, d_skip=jnp.asarray(d_skip), chunk=64, interpret=True)
    _close(ops.ssd(*t, d_skip=torch.from_numpy(d_skip)), want)


@pytest.mark.parametrize("s,slow", [(100, False), (257, False), (1, False),
                                    (700, True)])
def test_ragged_and_slow_decay_match_oracle(rng, s, slow):
    """S that no chunk divides (the Pallas kernel asserts it does), and a
    decay slow enough that the state crosses all 11 chunks of S = 700."""
    j, t = _both(_inputs(rng, 2, s, 3, 16, 32, slow=slow))
    want = jref.ssd(*j)
    got, _ = ssd.ssd(*t)
    _close(got, want)
    if slow:      # a scan that dropped the carry would fail here
        _far(_no_carry(t)[0], want)


@pytest.mark.parametrize("s,slow", [(128, False), (200, False), (640, True)])
def test_final_state_matches_ssd_chunked(rng, s, slow):
    j, t = _both(_inputs(rng, 2, s, 2, 16, 16, slow=slow))
    want_y, want_state = ssd_chunked(*j, chunk=32)
    got_y, got_state = ssd.ssd(*t)
    assert got_state.dtype == torch.float32
    assert tuple(got_state.shape) == (2, 2, 16, 16)
    _close(got_state, want_state)
    _close(got_y, want_y)
    if slow:      # a scan that dropped the carry would fail here
        _far(_no_carry(t)[1], want_state)


def test_port_oracle_matches_jax_oracle(rng):
    j, t = _both(_inputs(rng, 2, 77, 3, 8, 16))
    d_skip = rng.standard_normal((3,)).astype(np.float32)
    want = jref.ssd(*j, d_skip=jnp.asarray(d_skip))
    _close(ref.ssd(*t, d_skip=torch.from_numpy(d_skip)), want)


def test_bf16_inputs_keep_the_dtype(rng):
    x, dt, a, bm, cm = _inputs(rng, 1, 70, 2, 16, 16)
    args = [torch.tensor(x).bfloat16(), torch.tensor(dt),
            torch.from_numpy(a), torch.from_numpy(bm).bfloat16(),
            torch.from_numpy(cm).bfloat16()]
    y, state = ssd.ssd(*args)
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    want = jref.ssd(*[jnp.asarray(np.asarray(v.float())) for v in args])
    np.testing.assert_allclose(y.float().numpy(), np.asarray(want),
                               atol=2e-2, rtol=2e-2)


def test_cpu_tensors_launch_nothing(rng):
    _build.reset_launches()
    _, t = _both(_inputs(rng, 1, 100, 2, 16, 16))
    ops.ssd(*t)
    ssd.ssd(*t)
    assert sum(_build.LAUNCHES.values()) == 0


def test_malformed_operands_raise(rng):
    _, (x, dt, a, b, c) = _both(_inputs(rng, 1, 10, 2, 8, 16))
    with pytest.raises(ValueError, match="shapes"):
        ssd.ssd(x[0], dt, a, b, c)
    with pytest.raises(ValueError, match="do not fit"):
        ssd.ssd(x, dt[:, :5], a, b, c)
    with pytest.raises(ValueError, match="do not fit"):
        ssd.ssd(x, dt, a, b, c[..., :8])
    with pytest.raises(ValueError, match="empty"):
        ssd.ssd(x[:, :0], dt[:, :0], a, b[:, :0], c[:, :0])
    with pytest.raises(ValueError, match="one device"):
        ssd.ssd(x, dt, a.to("meta"), b, c)


def test_card_operand_checks():
    """What the wrapper refuses before a launch (run on CPU tensors here:
    the checks read only dtypes, shapes and strides)."""
    def ok(**kw):
        t = dict(x=torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16),
                 dt=torch.zeros(1, 8, 2), a=torch.zeros(2),
                 b=torch.zeros(1, 8, 128, dtype=torch.bfloat16),
                 c=torch.zeros(1, 8, 128, dtype=torch.bfloat16))
        t.update(kw)
        ssd._check_card_operands(**t)
    ok()
    with pytest.raises(TypeError, match="bfloat16"):
        ok(x=torch.zeros(1, 8, 2, 64))
    with pytest.raises(TypeError, match="float32"):
        ok(dt=torch.zeros(1, 8, 2, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="unit stride"):
        ok(b=torch.zeros(1, 128, 8, dtype=torch.bfloat16).transpose(1, 2))
    with pytest.raises(ValueError, match="P = 64"):
        ok(x=torch.zeros(1, 8, 4, 32, dtype=torch.bfloat16))


def _staged(x, dt, a, b, c, chunk):
    """K7's four stages written out in torch (f64, natural-log decays), in
    the kernel's scratch layouts (``ssd.scratch_shapes``): (a) C Bᵀ once per
    chunk, (b) the cumsum of dt * A and each chunk's own state, (c) the
    state pass in chunk order, overwriting each chunk's state with the one
    entering it, (d) the chunks' outputs.  Returns (y, final state)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    shapes = ssd.scratch_shapes(bsz, s, h, chunk, n=n, p=p)
    nc = shapes["states"][2]
    pad = nc * chunk - s
    xf = torch.nn.functional.pad(x.double(), (0, 0, 0, 0, 0, pad))
    dtf = torch.nn.functional.pad(dt.double(), (0, 0, 0, pad))
    bf = torch.nn.functional.pad(b.double(), (0, 0, 0, pad))
    cf = torch.nn.functional.pad(c.double(), (0, 0, 0, pad))
    tri = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    states = torch.empty(shapes["states"], dtype=torch.float64)
    cums = torch.empty(shapes["cums"], dtype=torch.float64)
    cb = torch.empty((bsz, nc, chunk, chunk), dtype=torch.float64)
    for ci in range(nc):                                  # (a) per (b, chunk)
        rows = slice(ci * chunk, (ci + 1) * chunk)
        cb[:, ci] = cf[:, rows] @ bf[:, rows].transpose(1, 2)
    for ci in range(nc):                        # (b) per (b, chunk, head)
        rows = slice(ci * chunk, (ci + 1) * chunk)
        for hh in range(h):
            cum = (dtf[:, rows, hh] * float(a[hh])).cumsum(1)     # (B, L)
            cums[:, hh, rows] = cum
            w = torch.exp(cum[:, -1:] - cum) * dtf[:, rows, hh]
            states[:, hh, ci] = bf[:, rows].transpose(1, 2) @ (
                xf[:, rows, hh] * w[..., None])
    carry = torch.zeros((bsz, h, n, p), dtype=torch.float64)
    for ci in range(nc):                                  # (c) in chunk order
        local = states[:, :, ci].clone()
        states[:, :, ci] = carry
        carry = (torch.exp(cums[:, :, (ci + 1) * chunk - 1])[..., None, None]
                 * carry + local)
    y = torch.empty((bsz, nc * chunk, h, p), dtype=torch.float64)
    for ci in range(nc):                  # (d) per (b, chunk, head)
        rows = slice(ci * chunk, (ci + 1) * chunk)
        for hh in range(h):
            cum = cums[:, hh, rows]
            seg = (cum[:, :, None] - cum[:, None, :]).masked_fill(~tri,
                                                                  -np.inf)
            dtx = xf[:, rows, hh] * dtf[:, rows, hh, None]
            y[:, rows, hh] = ((cb[:, ci] * torch.exp(seg)) @ dtx
                              + torch.exp(cum)[..., None]
                              * (cf[:, rows] @ states[:, hh, ci]))
    return y[:, :s].float(), carry.float()


def _pallas_chunk(s):
    """The largest chunk up to 128 that divides S (the Pallas kernel asks
    S % chunk == 0)."""
    return max(d for d in range(1, min(s, 128) + 1) if s % d == 0)


@pytest.mark.parametrize("s,slow", [
    (ssd.CHUNK + 44, False),          # ragged: a full chunk and a part
    (ssd.CHUNK // 2, False),          # S < L: one ragged chunk
    (1, False),
    (4 * ssd.CHUNK + 64, True),       # a slow decay across all 5 chunks
])
def test_staged_form_matches_jax(rng, s, slow):
    """The kernel's decomposition, stage by stage, at its chunk, against
    ``ssd_chunked`` (y and the final state) and the Pallas kernel in
    interpret mode (y): the only check of the state pass's order that runs
    without a card."""
    arrays = _inputs(rng, 1, s, 2, 16, 32, slow=slow)
    j, t = _both(arrays)
    got_y, got_state = _staged(*t, ssd.CHUNK)
    want_y, want_state = ssd_chunked(*j, chunk=ssd.CHUNK)
    _close(got_y, want_y)
    _close(got_state, want_state)
    _close(got_y, jops.ssd(*j, chunk=_pallas_chunk(s), interpret=True))
    if slow:      # a pass that dropped the carry would fail here
        _far(_no_carry(t)[1], want_state)


def test_scratch_shapes_follow_the_chunk():
    shapes = ssd.scratch_shapes(2, 1918, 80, 256)
    assert shapes == {"states": (2, 80, 8, 128, 64), "cums": (2, 80, 2048),
                      "cb": (2, 8, 136, 256), "cfrag": (2, 8, 16, 1024)}
    assert ssd.scratch_shapes(1, 64, 3, 64, n=16, p=8)["states"] == (
        1, 3, 1, 16, 8)
    with pytest.raises(ValueError, match="builds for"):
        ssd.source(96)


def test_card_launcher_refuses_cpu_tensors(rng):
    _, t = _both(_inputs(rng, 1, 10, 2, 64, 128))
    _build.reset_launches()
    with pytest.raises(ValueError, match="on the card"):
        ssd.scan(*t)
    assert sum(_build.LAUNCHES.values()) == 0
