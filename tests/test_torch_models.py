"""The port's model zoo (dense family) against the JAX package on the CPU.

The configs are compared field by field for all ten archs; ``rms_norm``,
``apply_rope`` and ``apply_mrope`` on the same numpy inputs; then the
reduced qwen2.5-3b at float32, with the JAX weights carried across by
``repro_torch.models.convert``: prefill logits and cache, and three
``decode_step`` logits, against JAX ``api.*`` (the XLA model path, as the
JAX tests run it).  Tolerances: ``2e-5`` for the f32 elementwise functions
(the parity contract's f32 attention tolerance), ``1e-4`` relative to the
largest logit for the model (a few f32 roundings per layer, summed in
another order, across three layers).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro.models import common as jcommon
from repro_torch import configs
from repro_torch.models import api, common, convert


def _f32(arch="qwen2.5-3b"):
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch),
                               param_dtype="float32")
    cfg = dataclasses.replace(configs.get_reduced(arch),
                              param_dtype="float32")
    return jcfg, cfg


def _port_params(jcfg, cfg, seed):
    jparams = japi.init_params(jcfg, jax.random.key(seed))
    return jparams, convert.from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                     device="cpu")


def _close(got, want, rel):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_equal_field_by_field(arch):
    for get in ("get_config", "get_reduced"):
        want = dataclasses.asdict(getattr(jconfigs, get)(arch))
        got = dataclasses.asdict(getattr(configs, get)(arch))
        assert got == want
    cfg = configs.get_config(arch)
    assert cfg.param_count() == jconfigs.get_config(arch).param_count()


def test_model_holds_the_analytic_parameter_count():
    """``param_count`` leaves out the QKV biases and the final norm."""
    cfg = configs.get_reduced("qwen2.5-3b")
    model = api.init_params(cfg, 0, device="cpu")
    extra = (cfg.n_layers * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim_
             + cfg.d_model)
    assert sum(p.numel() for p in model.parameters()) == \
        cfg.param_count() + extra


def test_rms_norm(rng):
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32) * 0.1
    want = jcommon.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)
    got = common.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_apply_rope_rotates_split_halves(rng):
    x = rng.standard_normal((2, 3, 7, 32)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 7)).astype(np.int32)
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_apply_mrope(rng):
    x = rng.standard_normal((2, 3, 5, 32)).astype(np.float32)
    pos = rng.integers(0, 64, (3, 2, 5)).astype(np.int32)
    want = jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = common.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_prefill_and_decode_match_jax():
    jcfg, cfg = _f32()
    jparams, model = _port_params(jcfg, cfg, seed=1)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (2, 37)).astype(np.int32)
    max_seq = 48
    jlogits, jcache = japi.prefill(jparams, jcfg,
                                   {"tokens": jnp.asarray(toks)}, max_seq)
    logits, cache = api.prefill(model, cfg,
                                {"tokens": torch.from_numpy(toks).long()},
                                max_seq)
    assert logits.dtype == torch.float32
    _close(logits, jlogits, 1e-4)
    for key in ("k", "v"):
        assert tuple(cache[key].shape) == jcache[key].shape
        _close(cache[key], jcache[key], 1e-4)
    assert cache["len"].tolist() == np.asarray(jcache["len"]).tolist()
    for _ in range(3):
        nxt = rng.integers(0, cfg.vocab, 2).astype(np.int32)
        jlogits, jcache = japi.decode_step(jparams, jcfg, jcache,
                                           jnp.asarray(nxt))
        logits, cache = api.decode_step(model, cfg, cache,
                                        torch.from_numpy(nxt).long())
        _close(logits, jlogits, 1e-4)
        assert cache["len"].tolist() == np.asarray(jcache["len"]).tolist()
    _close(cache["k"], jcache["k"], 1e-4)


def test_decode_past_max_seq_matches_jax():
    """A row whose length reaches max_seq: the write index clamps to the
    last position and every position is attended, as in JAX."""
    jcfg, cfg = _f32()
    jparams, model = _port_params(jcfg, cfg, seed=2)
    toks = np.arange(1, 7, dtype=np.int32)[None]
    max_seq = 8
    _, jcache = japi.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                             max_seq)
    _, cache = api.prefill(model, cfg, {"tokens": torch.from_numpy(toks)},
                           max_seq)
    for step in range(5):         # lengths 6..10 against max_seq 8
        nxt = np.array([step + 3], np.int32)
        jlogits, jcache = japi.decode_step(jparams, jcfg, jcache,
                                           jnp.asarray(nxt))
        logits, cache = api.decode_step(model, cfg, cache,
                                        torch.from_numpy(nxt))
        assert np.isfinite(logits.numpy()).all()
        _close(logits, jlogits, 1e-4)
    assert cache["len"].item() == 11
    _close(cache["v"], jcache["v"], 1e-4)


def test_mrope_embeddings_model_matches_jax():
    """qwen2-vl (dense, M-RoPE, embedding inputs) through prefill and one
    decode step."""
    jcfg, cfg = _f32("qwen2-vl-72b")
    jparams, model = _port_params(jcfg, cfg, seed=3)
    rng = np.random.default_rng(1)
    emb = (rng.standard_normal((1, 9, cfg.d_model)) * 0.02).astype(np.float32)
    jlogits, jcache = japi.prefill(jparams, jcfg,
                                   {"embeds": jnp.asarray(emb)}, 16)
    logits, cache = api.prefill(model, cfg, {"embeds": torch.from_numpy(emb)},
                                16)
    _close(logits, jlogits, 1e-4)
    step = (rng.standard_normal((1, cfg.d_model)) * 0.02).astype(np.float32)
    jlogits, _ = japi.decode_step(jparams, jcfg, jcache, jnp.asarray(step))
    logits, _ = api.decode_step(model, cfg, cache, torch.from_numpy(step))
    _close(logits, jlogits, 1e-4)


def test_encoder_only_prefill_matches_jax_and_has_no_decode():
    jcfg, cfg = _f32("hubert-xlarge")
    jparams, model = _port_params(jcfg, cfg, seed=4)
    emb = np.random.default_rng(2).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    jlogits, _ = japi.prefill(jparams, jcfg, {"embeds": jnp.asarray(emb)}, 12)
    logits, cache = api.prefill(model, cfg, {"embeds": torch.from_numpy(emb)},
                                12)
    assert cache is None
    _close(logits, jlogits, 1e-4)
    with pytest.raises(ValueError, match="encoder-only"):
        api.decode_step(model, cfg, None, torch.zeros(2, dtype=torch.long))


@pytest.mark.parametrize("arch,family", [("qwen3-moe-235b-a22b", "moe"),
                                         ("deepseek-v2-236b", "mla"),
                                         ("recurrentgemma-9b", "rglru")])
def test_unported_families_raise(arch, family):
    cfg = configs.get_reduced(arch)
    assert cfg.family == family
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        api.init_params(cfg, 0, device="cpu")


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_reduced("qwen2.5-3b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init_cache(cfg, 1, 8)
    model = api.init_params(cfg, 0, device="cpu")
    assert model.embed.device.type == "cpu"
    assert model.embed.dtype == torch.bfloat16


def test_init_params_draws_like_dense_init():
    """Norms and biases start at zero; a weight is a truncated normal on
    +-2 standard deviations of 1/sqrt(fan_in), reproducible from the seed."""
    cfg = configs.get_reduced("qwen2.5-3b")
    a = api.init_params(cfg, 7, device="cpu")
    b = api.init_params(cfg, 7, device="cpu")
    assert torch.equal(a.layers[1].ffn.w_down, b.layers[1].ffn.w_down)
    assert not a.layers[0].ln1.any() and not a.layers[0].attn.bq.any()
    w = a.layers[0].ffn.w_down.float()          # (d, d_ff): fan_in d_ff
    std = 1.0 / np.sqrt(cfg.d_ff)
    assert w.abs().max().item() <= 2 * std * 1.01
    assert 0.7 * std < w.std().item() < 1.0 * std
