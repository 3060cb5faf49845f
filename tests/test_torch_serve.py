"""The port's serving engine against the JAX engine on the CPU.

Both engines get the same float32 weights (carried across by
``repro_torch.models.convert``) and the same prompts, as in
``tests/test_serve.py`` (reduced qwen2.5-3b, mamba2-2.7b and
recurrentgemma-9b, ``slots=2``); greedy tokens must be identical.  Also: slots are reused, an idle slot that ticks past
``max_seq`` gives the same tokens as JAX with no error, and the entry
points need a card unless the CPU is asked for.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro_torch import configs
from repro_torch.kernels import _build
from repro_torch.launch import serve as launch_serve
from repro_torch.models import api, convert
from repro_torch.serve import Engine, Request


def _setup(seed, arch="qwen2.5-3b"):
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch),
                               param_dtype="float32")
    cfg = dataclasses.replace(configs.get_reduced(arch),
                              param_dtype="float32")
    jparams = japi.init_params(jcfg, jax.random.key(seed))
    model = convert.from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    return jcfg, jparams, cfg, model


def _serve_both(prompts, max_new, *, slots, max_seq, seed=3,
                arch="qwen2.5-3b"):
    jcfg, jparams, cfg, model = _setup(seed, arch)
    jeng = JEngine(jcfg, jparams, slots=slots, max_seq=max_seq)
    eng = Engine(cfg, model, slots=slots, max_seq=max_seq, device="cpu")
    for i, p in enumerate(prompts):
        jeng.submit(JRequest(rid=i, prompt=p, max_new=max_new))
        eng.submit(Request(rid=i, prompt=p, max_new=max_new))
    want = {r.rid: r.generated for r in jeng.run()}
    got = {r.rid: r.generated for r in eng.run()}
    return got, want, eng


def test_engine_tokens_match_jax_engine():
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, int(rng.integers(4, 12))).astype(np.int32)
               for _ in range(3)]
    got, want, eng = _serve_both(prompts, 4, slots=2, max_seq=64)
    assert len(got) == 3
    assert got == want
    assert len(eng.prefill_s) == 3 and len(eng.decode_s) >= 3


def test_slots_reused():
    prompts = [np.array([1, 2, 3], np.int32)] * 3
    got, want, eng = _serve_both(prompts, 2, slots=1, max_seq=32, seed=0)
    assert len(got) == 3 and got == want
    assert list(eng.free) == [0]


def test_mamba2_engine_tokens_match_jax_engine():
    """The ssm family: every cache entry (state, conv, len) goes into the
    slot, and the tokens are the JAX engine's."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, int(rng.integers(4, 12))).astype(np.int32)
               for _ in range(3)]
    got, want, eng = _serve_both(prompts, 4, slots=2, max_seq=64,
                                 arch="mamba2-2.7b")
    assert len(got) == 3 and got == want
    assert set(eng.cache) == {"state", "conv", "len"}


def test_mamba2_slots_reused():
    prompts = [np.array([1, 2, 3, 4], np.int32), np.array([5, 6, 7], np.int32),
               np.array([9, 9, 9, 9, 9], np.int32)]
    got, want, eng = _serve_both(prompts, 3, slots=1, max_seq=32, seed=0,
                                 arch="mamba2-2.7b")
    assert len(got) == 3 and got == want
    assert list(eng.free) == [0]
    # the last prompt's 5 tokens and 2 decode steps (its first new token
    # came from the prefill)
    assert eng.cache["len"].tolist() == [5 + 2]


def test_rglru_engine_tokens_match_jax_engine():
    """The rglru family: the ring ``k``/``v``, ``state``, ``conv`` and
    ``len`` go into the slot, one prompt passes the reduced window of 32,
    and the tokens are the JAX engine's."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, n).astype(np.int32) for n in (5, 40, 9)]
    got, want, eng = _serve_both(prompts, 6, slots=2, max_seq=64,
                                 arch="recurrentgemma-9b")
    assert len(got) == 3 and got == want
    assert set(eng.cache) == {"k", "v", "state", "conv", "len"}
    assert eng.cache["k"].shape[2] == 32


def test_launcher_serves_rglru_on_the_cpu(capsys):
    assert launch_serve.main(["--arch", "recurrentgemma-9b", "--reduced",
                              "--device", "cpu", "--requests", "3",
                              "--max-new", "3"]) == 0
    assert "served 3 requests, 9 tokens" in capsys.readouterr().out


def test_idle_slot_ticking_past_max_seq_matches_jax():
    """Requests served one at a time take slots 0, 1, 2 in turn: slot 2
    stays idle through the first two, its length counts past max_seq,
    its cache writes clamp to the last position, and nothing raises."""
    prompts = [np.array([5, 6, 7], np.int32), np.array([9, 8], np.int32),
               np.array([1], np.int32)]
    jcfg, jparams, cfg, model = _setup(5)
    jeng = JEngine(jcfg, jparams, slots=3, max_seq=12)
    eng = Engine(cfg, model, slots=3, max_seq=12, device="cpu")
    for e, R in ((jeng, JRequest), (eng, Request)):
        for i, p in enumerate(prompts):
            if i == 2:
                assert int(e.cache["len"][2]) > 12
            e.submit(R(rid=i, prompt=p, max_new=8))
            while e.queue or e.active:
                e.tick()
    assert np.asarray(jeng.cache["len"]).tolist() == \
        eng.cache["len"].tolist()
    want = {r.rid: (r.slot, r.generated) for r in jeng.finished}
    got = {r.rid: (r.slot, r.generated) for r in eng.finished}
    assert got == want
    assert [got[i][0] for i in range(3)] == [0, 1, 2]


def test_cpu_engine_launches_no_kernel():
    _build.reset_launches()
    test_slots_reused()
    assert sum(_build.LAUNCHES.values()) == 0


def test_engine_and_launcher_need_a_card_unless_asked(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_reduced("qwen2.5-3b")
    model = api.init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg, model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main([])
    assert launch_serve.main(["--reduced", "--device", "cpu", "--requests",
                              "3", "--max-new", "3"]) == 0
    out = capsys.readouterr().out
    assert "served 3 requests, 9 tokens" in out and "on CPU" in out


def test_launcher_serves_mamba2_on_the_cpu(capsys):
    assert launch_serve.main(["--arch", "mamba2-2.7b", "--reduced",
                              "--device", "cpu", "--requests", "3",
                              "--max-new", "3"]) == 0
    assert "served 3 requests, 9 tokens" in capsys.readouterr().out


def test_reduced_is_a_switch_off_by_default(monkeypatch):
    seen = []
    full, reduced = configs.get_config, configs.get_reduced
    monkeypatch.setattr(launch_serve.api, "resolve_device",
                        lambda d: (_ for _ in ()).throw(SystemExit(0)))
    monkeypatch.setattr(launch_serve.configs, "get_config",
                        lambda a: seen.append(("full", a)) or full(a))
    monkeypatch.setattr(launch_serve.configs, "get_reduced",
                        lambda a: seen.append(("reduced", a)) or reduced(a))
    for argv in ([], ["--reduced"], ["--no-reduced"]):
        with pytest.raises(SystemExit):
            launch_serve.main(argv)
    assert seen == [("full", "qwen2.5-3b"), ("reduced", "qwen2.5-3b"),
                    ("full", "qwen2.5-3b")]


def test_encoder_only_arch_cannot_serve():
    cfg = configs.get_reduced("hubert-xlarge")
    with pytest.raises(ValueError, match="encoder-only"):
        Engine(cfg, None, device="cpu")
    assert launch_serve.main(["--arch", "hubert-xlarge", "--reduced",
                              "--device", "cpu"]) == 2
