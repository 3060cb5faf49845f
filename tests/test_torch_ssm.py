"""The port's Mamba-2 model (ssm family) against the JAX package on the CPU.

The reduced mamba2-2.7b at float32, with the JAX weights carried across by
``repro_torch.models.convert``: prefill logits and cache (``state``,
``conv``, ``len``) and three ``decode_step`` logits and caches against
JAX ``api.*`` (the XLA model path, ``ssd_chunked``, as the JAX tests run
it), at ``1e-4`` relative to the largest value, the dense test's
tolerance.  Prompt lengths of 37 and 70 tokens: the JAX model chunks them
by gcd (37 gives chunk 1, a sequential scan), the port by 64 with a
ragged last chunk.  Also: ``init_params`` draws as the JAX init does,
decode updates the cache in place, and a prompt shorter than
``d_conv - 1`` tokens raises.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro_torch import configs
from repro_torch.kernels import _build
from repro_torch.models import api, convert, ssm

ARCH = "mamba2-2.7b"


def _f32():
    jcfg = dataclasses.replace(jconfigs.get_reduced(ARCH),
                               param_dtype="float32")
    cfg = dataclasses.replace(configs.get_reduced(ARCH),
                              param_dtype="float32")
    return jcfg, cfg


def _port_params(jcfg, cfg, seed):
    jparams = japi.init_params(jcfg, jax.random.key(seed))
    return jparams, convert.from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                     device="cpu")


def _close(got, want, rel=1e-4):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("s", [37, 70])
def test_prefill_and_decode_match_jax(s):
    jcfg, cfg = _f32()
    jparams, model = _port_params(jcfg, cfg, seed=1)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (2, s)).astype(np.int32)
    jlogits, jcache = japi.prefill(jparams, jcfg,
                                   {"tokens": jnp.asarray(toks)}, 96)
    logits, cache = api.prefill(model, cfg,
                                {"tokens": torch.from_numpy(toks).long()}, 96)
    assert logits.dtype == torch.float32
    _close(logits, jlogits)
    assert set(cache) == set(jcache) == {"state", "conv", "len"}
    for key in ("state", "conv"):
        assert cache[key].dtype == torch.float32
        _close(cache[key], jcache[key])
    assert cache["len"].tolist() == np.asarray(jcache["len"]).tolist()
    state, conv = cache["state"], cache["conv"]
    for _ in range(3):
        nxt = rng.integers(0, cfg.vocab, 2).astype(np.int32)
        jlogits, jcache = japi.decode_step(jparams, jcfg, jcache,
                                           jnp.asarray(nxt))
        logits, cache = api.decode_step(model, cfg, cache,
                                        torch.from_numpy(nxt).long())
        _close(logits, jlogits)
        assert cache["len"].tolist() == np.asarray(jcache["len"]).tolist()
    assert cache["state"] is state and cache["conv"] is conv   # in place
    _close(cache["state"], jcache["state"])
    _close(cache["conv"], jcache["conv"])


def test_bf16_model_runs_and_keeps_f32_leaves():
    cfg = configs.get_reduced(ARCH)
    model = api.init_params(cfg, 0, device="cpu")
    lp = model.layers[0]
    assert lp.w_in.dtype == torch.bfloat16
    assert {p.dtype for p in (lp.dt_bias, lp.a_log, lp.d_skip)} == \
        {torch.float32}
    toks = torch.arange(1, 20)[None]
    logits, cache = api.prefill(model, cfg, {"tokens": toks}, 32)
    assert cache["state"].dtype == torch.float32
    assert cache["conv"].dtype == torch.bfloat16
    logits, cache = api.decode_step(model, cfg, cache, torch.tensor([3]))
    assert torch.isfinite(logits).all() and cache["len"].tolist() == [20]


def test_init_params_draws_like_the_jax_init():
    """Fixed leaves as in JAX; weights a truncated normal on +-2 standard
    deviations of 1/sqrt(fan_in): d for w_in, d_inner for w_out, d_conv
    for conv_w; the parameter count is ``param_count``'s and what it
    leaves out."""
    cfg = configs.get_reduced(ARCH)
    a = api.init_params(cfg, 7, device="cpu")
    b = api.init_params(cfg, 7, device="cpu")
    assert torch.equal(a.layers[1].w_in, b.layers[1].w_in)
    jparams = japi.init_params(jconfigs.get_reduced(ARCH), jax.random.key(0))
    jl = jax.tree.map(np.asarray, jparams["layers"])
    lp = a.layers[0]
    for name in ("dt_bias", "a_log", "d_skip", "ln", "gn", "conv_b"):
        want = jl[name][0]
        assert str(getattr(lp, name).dtype) == f"torch.{want.dtype}"
        np.testing.assert_allclose(getattr(lp, name).float().numpy(),
                                   want.astype(np.float32), rtol=1e-6)
    d_in, h, conv_ch = ssm._dims(cfg)
    for w, fan_in in ((lp.w_in, cfg.d_model), (lp.w_out, d_in),
                      (lp.conv_w, cfg.ssm.d_conv)):
        w = w.float()
        std = 1.0 / np.sqrt(fan_in)
        assert w.abs().max().item() <= 2 * std * 1.01
        assert 0.7 * std < w.std().item() < 1.0 * std
    assert tuple(lp.conv_w.shape) == jl["conv_w"].shape[1:]
    # param_count leaves out conv_b, dt_bias and ln_f
    extra = cfg.n_layers * (conv_ch + h) + cfg.d_model
    assert sum(p.numel() for p in a.parameters()) == \
        cfg.param_count() + extra


def test_short_prompt_raises():
    cfg = configs.get_reduced(ARCH)
    model = api.init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="d_conv - 1"):
        api.prefill(model, cfg, {"tokens": torch.tensor([[1, 2]])}, 8)


def test_cpu_model_launches_no_kernel():
    cfg = configs.get_reduced(ARCH)
    model = api.init_params(cfg, 0, device="cpu")
    _build.reset_launches()
    _, cache = api.prefill(model, cfg, {"tokens": torch.arange(5)[None]}, 8)
    api.decode_step(model, cfg, cache, torch.tensor([1]))
    assert sum(_build.LAUNCHES.values()) == 0
