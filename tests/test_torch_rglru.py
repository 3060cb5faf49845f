"""The port's RecurrentGemma (rglru family) against the JAX package on the CPU.

The reduced recurrentgemma-9b (5 layers: one super-block of rglru, rglru,
attn and a tail of two rglru; window 32, LRU width 64) at float32, with the
JAX weights carried across by ``repro_torch.models.convert``: prefill
logits and every cache entry (the ring ``k``/``v``, ``state``, ``conv``,
``len``) and decode steps against JAX ``api.*`` (the XLA model path, as
the JAX tests run it), at ``1e-4`` relative to the largest value, the
dense and ssm tests' tolerance.  Prompts of 20 tokens (below the window)
and 45 (past it: the ring is rolled), and decode steps that carry a short
prompt's ring past its window.  The doubling scan is held against the JAX
``rglru_seq`` (``lax.associative_scan``) and a sequential loop in f32 at
``1e-5`` relative (each sums the same products in another order); an idle
serving slot that ticks past the window against the JAX engine; a prompt
shorter than ``conv_width - 1`` raises ``ValueError`` where the JAX engine
fails on its slot write (as the ssm port does).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro.models import rglru as jrglru
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro_torch import configs
from repro_torch.kernels import _build
from repro_torch.models import api, convert, rglru
from repro_torch.serve import Engine, Request

ARCH = "recurrentgemma-9b"


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


def test_layer_kinds_follow_the_jax_stacks():
    cfg = configs.get_config(ARCH)
    kinds = rglru.kinds(cfg)
    assert kinds.count("attn") == 12 and kinds.count("rglru") == 26
    assert kinds[-2:] == ["rglru", "rglru"]          # the tail
    n_super, apb, rpb, tail_a, tail_r = jrglru._counts(
        jconfigs.get_config(ARCH))
    assert kinds.count("attn") == n_super * apb + tail_a
    assert kinds.count("rglru") == n_super * rpb + tail_r
    cache = rglru.init_cache(configs.get_reduced(ARCH), 2, 24,
                             device="cpu")
    assert cache["k"].shape == (1, 2, 24, 1, 16)     # min(window, max_seq)
    assert cache["state"].shape == (4, 2, 64)
    assert cache["conv"].shape == (4, 2, 3, 64)


@pytest.mark.parametrize("s", [20, 45])
def test_prefill_and_decode_match_jax(s):
    """20 tokens fill the ring from slot 0; 45 pass the window of 32, so
    the ring holds the last 32 rolled by 45 % 32.  Fifteen decode steps carry
    the 20-token prompt's ring past its window too."""
    jcfg, cfg = _f32()
    jparams, model = _port_params(jcfg, cfg, seed=1)
    rng = np.random.default_rng(s)
    toks = rng.integers(0, cfg.vocab, (2, s)).astype(np.int32)
    jlogits, jcache = japi.prefill(jparams, jcfg,
                                   {"tokens": jnp.asarray(toks)}, 64)
    logits, cache = api.prefill(model, cfg,
                                {"tokens": torch.from_numpy(toks).long()}, 64)
    assert logits.dtype == torch.float32
    _close(logits, jlogits)
    assert set(cache) == set(jcache) == {"k", "v", "state", "conv", "len"}
    for key in ("k", "v", "state", "conv"):
        _close(cache[key], jcache[key])
    assert cache["len"].tolist() == np.asarray(jcache["len"]).tolist()
    held = {key: cache[key] for key in ("k", "v", "state", "conv")}
    for _ in range(15):
        nxt = rng.integers(0, cfg.vocab, 2).astype(np.int32)
        jlogits, jcache = japi.decode_step(jparams, jcfg, jcache,
                                           jnp.asarray(nxt))
        logits, cache = api.decode_step(model, cfg, cache,
                                        torch.from_numpy(nxt).long())
        _close(logits, jlogits)
        assert cache["len"].tolist() == np.asarray(jcache["len"]).tolist()
    for key, t in held.items():
        assert cache[key] is t                       # written in place
        _close(cache[key], jcache[key])
    assert int(cache["len"][0]) == s + 15 and s + 15 > 32


def test_doubling_scan_matches_the_associative_scan():
    """f32, tolerance 1e-5 of the largest state: the doubling scan, the
    JAX ``associative_scan`` and a loop over the tokens multiply and add
    the same terms in three orders."""
    jcfg, cfg = _f32()
    jparams, model = _port_params(jcfg, cfg, seed=2)
    rec = model.layers[0].rec
    jrec = jax.tree.map(lambda a: a[0], jparams["super"]["rglru_0"]["rec"])
    x = np.random.default_rng(3).standard_normal((2, 77, 64)).astype(
        np.float32)
    jy, jh = jrglru.rglru_seq(jrec, jnp.asarray(x))
    y, h = rglru.rglru_seq(rec, torch.from_numpy(x))
    assert h.dtype == torch.float32
    _close(y, jy, 1e-5)
    _close(h, jh, 1e-5)
    a, b = rglru._rglru_coeffs(rec, torch.from_numpy(x))
    state, seq = torch.zeros(2, 64), []
    for t in range(x.shape[1]):
        state = a[:, t] * state + b[:, t]
        seq.append(state)
    _close(rglru.linear_scan(a, b), torch.stack(seq, 1).numpy(), 1e-5)


@pytest.mark.parametrize("s", [1, 2, 3, 4, 5, 16, 17])
def test_linear_scan_at_every_doubling_edge(s):
    g = torch.Generator().manual_seed(s)
    a = torch.rand(3, s, 8, generator=g)
    b = torch.randn(3, s, 8, generator=g)
    h, want = torch.zeros(3, 8), []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(rglru.linear_scan(a, b), torch.stack(want, 1),
                               rtol=0, atol=1e-6)


def test_idle_slot_ticking_past_the_window_matches_jax():
    """Requests served one at a time take slots 0, 1, 2 in turn: slot 2
    idles through more ticks than the ring has slots, its writes wrap at
    ``len % W`` and its valid count stays W, and nothing raises."""
    jcfg, cfg = _f32()
    jparams, model = _port_params(jcfg, cfg, seed=5)
    prompts = [np.arange(3, 12, dtype=np.int32), np.arange(7, 13,
                                                          dtype=np.int32),
               np.array([1, 2, 3, 4], np.int32)]
    jeng = JEngine(jcfg, jparams, slots=3, max_seq=40)
    eng = Engine(cfg, model, slots=3, max_seq=40, device="cpu")
    for e, R in ((jeng, JRequest), (eng, Request)):
        for i, p in enumerate(prompts):
            if i == 2:
                assert int(e.cache["len"][2]) > 32
            e.submit(R(rid=i, prompt=p, max_new=20))
            while e.queue or e.active:
                e.tick()
    assert np.asarray(jeng.cache["len"]).tolist() == \
        eng.cache["len"].tolist()
    want = {r.rid: (r.slot, r.generated) for r in jeng.finished}
    got = {r.rid: (r.slot, r.generated) for r in eng.finished}
    assert got == want
    for key in ("k", "v", "state", "conv"):
        _close(eng.cache[key], jeng.cache[key])


def test_short_prompt_raises_where_the_jax_engine_fails():
    jcfg, cfg = _f32()
    jparams, model = _port_params(jcfg, cfg, seed=0)
    short = np.array([1, 2], np.int32)       # conv_width - 1 = 3
    jeng = JEngine(jcfg, jparams, slots=1, max_seq=16)
    jeng.submit(JRequest(rid=0, prompt=short, max_new=2))
    with pytest.raises(Exception):
        jeng.run()
    with pytest.raises(ValueError, match="conv_width - 1"):
        api.prefill(model, cfg, {"tokens": torch.from_numpy(short)[None]},
                    16)


def test_init_params_draws_like_the_jax_init():
    """Fixed leaves as in JAX (``lambda_p`` 2 in f32; norms and ``conv_b``
    zero); weights a truncated normal on +-2 standard deviations of
    1/sqrt(fan_in); the parameter count is ``param_count``'s plus what it
    leaves out (the two W x W gates, ``lambda_p`` counted once of its
    three W-vectors, and ``ln_f``)."""
    cfg = configs.get_reduced(ARCH)
    a = api.init_params(cfg, 7, device="cpu")
    b = api.init_params(cfg, 7, device="cpu")
    assert torch.equal(a.layers[1].rec.w_in, b.layers[1].rec.w_in)
    jparams = japi.init_params(jconfigs.get_reduced(ARCH), jax.random.key(0))
    jrec = jax.tree.map(np.asarray, jparams["super"]["rglru_0"]["rec"])
    rec = a.layers[0].rec
    for name in ("lambda_p", "conv_b"):
        want = jrec[name][0]
        assert str(getattr(rec, name).dtype) == f"torch.{want.dtype}"
        np.testing.assert_allclose(getattr(rec, name).float().numpy(),
                                   want.astype(np.float32), rtol=1e-6)
    w = cfg.rglru.lru_width
    for p, fan_in in ((rec.w_in, cfg.d_model), (rec.wi_gate, w),
                      (rec.w_out, w), (rec.conv_w, cfg.rglru.conv_width),
                      (a.layers[2].attn.wq, cfg.d_model)):
        p = p.float()
        std = 1.0 / np.sqrt(fan_in)
        assert p.abs().max().item() <= 2 * std * 1.01
        assert 0.6 * std < p.std().item() < 1.0 * std
    n_rec = rglru.kinds(cfg).count("rglru")
    extra = n_rec * (2 * w * w - w) + cfg.d_model
    assert sum(p.numel() for p in a.parameters()) == \
        cfg.param_count() + extra


def test_bf16_model_runs_and_keeps_f32_leaves():
    cfg = configs.get_reduced(ARCH)
    model = api.init_params(cfg, 0, device="cpu")
    assert model.layers[0].rec.w_in.dtype == torch.bfloat16
    assert model.layers[0].rec.lambda_p.dtype == torch.float32
    toks = torch.arange(1, 40)[None]                  # past the window
    logits, cache = api.prefill(model, cfg, {"tokens": toks}, 64)
    assert cache["state"].dtype == torch.float32
    assert cache["k"].dtype == torch.bfloat16
    logits, cache = api.decode_step(model, cfg, cache, torch.tensor([3]))
    assert torch.isfinite(logits).all() and cache["len"].tolist() == [40]


def test_cpu_model_launches_no_kernel():
    cfg = configs.get_reduced(ARCH)
    model = api.init_params(cfg, 0, device="cpu")
    _build.reset_launches()
    _, cache = api.prefill(model, cfg, {"tokens": torch.arange(5)[None]}, 8)
    api.decode_step(model, cfg, cache, torch.tensor([1]))
    assert sum(_build.LAUNCHES.values()) == 0
