"""Batched serving loop: fixed decode slots + continuous batching (the
legacy wave loop; the port's counterpart of the reference's
``runtime/server.py``).

Requests queue up; a slot map assigns each to a batch lane.  Each engine step
decodes one token for every active lane, feeding a prompt token by token
(teacher-forced) before the generated ones; finished lanes (EOS, max tokens
or the cache's length) are released and refilled from the queue, sized to
the decode batch so the step's shapes never change.

The queue/slot/metrics plumbing is the shared serving core in
:mod:`repro_torch.runtime.batching`: admission control via
:class:`~repro_torch.runtime.batching.BoundedQueue` (``max_pending``), slot
refill via :func:`~repro_torch.runtime.batching.refill_slots`, and a
``metrics()`` dict in the shape the CNN tier emits.  A refilled lane starts
from a fresh slot: its position index and its recurrent cache rows (rwkv's,
hymba's SSM state) are zeroed (:func:`repro_torch.runtime.kvcache.
_fresh_slot`), where the reference resets the index alone; an enc_dec
lane's ``cross_kv`` (its frames) stays.  The caller
drives :meth:`ServeEngine.step`;
the continuous-batching tier with futures is
:class:`~repro_torch.runtime.lm_server.AsyncLmEngine`.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.models import transformer as T
from repro_torch.runtime import batching
from repro_torch.runtime.kvcache import _fresh_slot


@dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int = 16
    eos_id: int = -1  # -1: never
    generated: list[int] = field(default_factory=list)
    done: bool = False
    _t0: float = 0.0


class ServeEngine:
    """The steps run where ``params`` live, through the plain versions (no
    extension table is bound), as the reference's loop runs its baselines.
    ``frames`` (batch_slots, F, d) feed the enc_dec family: lane i decodes
    against ``frames[i]``, whose cross-attention K/V the state builds once
    and a refilled lane keeps."""

    def __init__(self, params, cfg: ArchConfig, run: RunConfig, *,
                 batch_slots: int = 4, max_len: int = 256, frames=None,
                 max_pending: int | None = None):
        self.params = params
        self.cfg = cfg
        self.run = run
        self.slots: list[Request | None] = [None] * batch_slots
        self.queue = batching.BoundedQueue(capacity=max_pending)
        self.max_len = max_len
        self.device = params["embed"]["table"].device
        self.state = T.init_decode_state(params, cfg, run, batch=batch_slots,
                                         max_len=max_len, frames=frames)
        self._step = lambda p, s, t: T.decode_step(p, s, t, cfg, run)
        self._next_tok = np.zeros((batch_slots, 1), np.int32)
        self._prompt_pos = np.zeros(batch_slots, np.int32)
        self._metrics = batching.EngineMetrics()

    def submit(self, req: Request) -> None:
        req._t0 = time.perf_counter()
        self.queue.push(req)  # AdmissionError surfaces to the caller
        self._metrics.submitted += 1

    def _on_fill(self, i: int, req: Request) -> None:
        # a fresh lane; the prompt is fed token by token
        self.state = _fresh_slot(self.state, i)
        self._prompt_pos[i] = 0
        self._next_tok[i, 0] = req.prompt[0]

    def step(self) -> None:
        """One engine step = one decode step for every active lane."""
        batching.refill_slots(self.slots, self.queue, self._on_fill)
        with torch.inference_mode():
            logits, self.state = self._step(
                self.params, self.state,
                torch.from_numpy(self._next_tok).to(self.device))
            # argmax takes the first maximum, as jnp.argmax does
            sampled = logits[:, 0, : self.cfg.vocab].argmax(dim=-1).to(
                torch.int32).cpu().numpy()
        used = sum(s is not None for s in self.slots)
        self._metrics.observe_batch(used, len(self.slots))
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            self._prompt_pos[i] += 1
            if self._prompt_pos[i] < len(req.prompt):
                # still teacher-forcing the prompt
                self._next_tok[i, 0] = req.prompt[self._prompt_pos[i]]
                continue
            tok = int(sampled[i])
            req.generated.append(tok)
            self._next_tok[i, 0] = tok
            total = int(self._prompt_pos[i]) + len(req.generated)
            if (tok == req.eos_id or len(req.generated) >= req.max_new_tokens
                    or total >= self.max_len - 1):
                req.done = True
                self.slots[i] = None
                self._metrics.completed += 1
                self._metrics.observe_latency(
                    (time.perf_counter() - req._t0) * 1e3
                )

    @property
    def active(self) -> int:
        return sum(s is not None for s in self.slots) + len(self.queue)

    def run_until_drained(self, max_steps: int = 10_000) -> None:
        steps = 0
        while self.active and steps < max_steps:
            self.step()
            steps += 1

    def metrics(self) -> dict:
        """The serving metrics surface — same shape as the CNN engines'."""
        self._metrics.rejected = self.queue.rejected
        return self._metrics.snapshot(queue_depth=len(self.queue))
