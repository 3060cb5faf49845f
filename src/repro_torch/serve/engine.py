"""Continuous-batching serving engine.

Port of ``repro.serve.engine`` (without ``mesh``: serving across several
cards is ROADMAP queue 1, distribution; and without ``prefill_pad``, which
no caller sets: every prompt is prefilled at its own length).  Slot-based scheduler over the
family-generic model API: new requests are prefilled one at a time into a
free slot of the shared padded cache; every engine tick runs one decode
step across all slots (idle ones included, as in the JAX engine);
finished requests free their slot immediately (no head-of-line blocking).
Tokens are chosen by greedy argmax.

The cache lives on the engine's device and is written **in place**: a
prefill copies every entry of its cache into the slot (the dense family's
``k``/``v``, the ssm family's ``state``/``conv``, and ``len``), and each
decode step updates each slot's part.  The engine runs on the card unless it is given
``device="cpu"``; without a card and without that request it raises.  The
host-clock seconds of each prefill and each decode step (each ends in a
read of the chosen tokens, which waits for the card) are kept in
``prefill_s`` and ``decode_s``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from ..models import api
from ..models.config import ArchConfig


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray               # (S,) int32
    max_new: int = 16
    eos_id: Optional[int] = None
    generated: list = dataclasses.field(default_factory=list)
    slot: Optional[int] = None

    @property
    def done(self) -> bool:
        if self.eos_id is not None and self.generated \
                and self.generated[-1] == self.eos_id:
            return True
        return len(self.generated) >= self.max_new


class Engine:
    def __init__(self, cfg: ArchConfig, params, *, slots: int = 4,
                 max_seq: int = 512, device=None):
        if cfg.encoder_only:
            raise ValueError(f"{cfg.name} is encoder-only: it cannot serve")
        self.device = api.resolve_device(device)
        self.cfg = cfg
        self.params = params.to(self.device)
        self.slots = slots
        self.max_seq = max_seq
        self.cache = api.init_cache(cfg, slots, max_seq,
                                    dtype=getattr(torch, cfg.param_dtype),
                                    device=self.device)
        self.free = deque(range(slots))
        self.active: dict[int, Request] = {}
        self.queue: deque[Request] = deque()
        self.finished: list[Request] = []
        self.prefill_s: list[float] = []
        self.decode_s: list[float] = []

    # ------------------------------------------------------------- intake
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        while self.queue and self.free:
            req = self.queue.popleft()
            slot = self.free.popleft()
            req.slot = slot
            t0 = time.perf_counter()
            toks = torch.as_tensor(req.prompt, dtype=torch.long,
                                   device=self.device)
            batch = {"tokens": toks[None]}
            if self.cfg.mrope:
                pos = torch.arange(len(toks), dtype=torch.int32,
                                   device=self.device)[None]
                batch["positions"] = torch.stack([pos, pos * 0, pos * 0], 0)
            logits, cache1 = api.prefill(self.params, self.cfg, batch,
                                         self.max_seq)
            self._write_slot(slot, cache1)
            # the last position's logits give the first new token; reading
            # it waits for the card, slot write included
            req.generated.append(int(torch.argmax(logits[0])))
            self.prefill_s.append(time.perf_counter() - t0)
            self.active[slot] = req

    def _write_slot(self, slot: int, cache1) -> None:
        """Copy every entry of a batch-1 prefill cache into ``slot``:
        along axis 0 for ``len``, axis 1 (after the layers) otherwise."""
        for key, dst in self.cache.items():
            ax = 0 if key == "len" else 1
            dst.select(ax, slot).copy_(cache1[key].select(ax, 0))

    # --------------------------------------------------------------- tick
    def tick(self) -> int:
        """Admit, run one decode step for all slots, retire done."""
        self._admit()
        if not self.active:
            return 0
        t0 = time.perf_counter()
        tokens = np.zeros((self.slots,), np.int64)
        for slot, req in self.active.items():
            tokens[slot] = (req.generated[-1] if req.generated
                            else req.prompt[-1])
        logits, self.cache = api.decode_step(
            self.params, self.cfg, self.cache,
            torch.as_tensor(tokens, device=self.device))
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        self.decode_s.append(time.perf_counter() - t0)
        for slot in list(self.active):
            req = self.active[slot]
            req.generated.append(int(nxt[slot]))
            if req.done:
                del self.active[slot]
                self.free.append(slot)
                self.finished.append(req)
        return len(self.active)

    def run(self, max_ticks: int = 1000) -> list:
        ticks = 0
        while (self.queue or self.active) and ticks < max_ticks:
            self.tick()
            ticks += 1
        return self.finished
