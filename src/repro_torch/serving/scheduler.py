"""Iteration-level continuous batching (Orca-style) on per-slot positions:
the reference's ``repro.serving.scheduler`` on the port's model.

The decode path accepts a per-slot position vector, so slots advance
independently: new requests are admitted into free slots mid-flight and
replay their prompt tokens one iteration at a time while other slots keep
generating, with no batch drain and no padding waste.  Slot reuse is safe
because cache reads mask ``ki <= pos`` and a new request overwrites
positions from 0 upward.

The SSM and hybrid families are refused (ROADMAP C.8): their state
and conv caches are not position-masked, and the reference resets no
cache when it reuses a slot.  The MoE family is refused (ROADMAP C.9):
the reference's step feeds every slot's token to ``decode_step``, free
slots' stale ones too, and a row's expert capacity depends on the other
rows of the batch.  The vlm and audio families are refused (ROADMAP
C.10): no request carries a context, and the reference's batcher never
fills the context caches.  gemma3's ring buffers are served: each
slot writes its ring at ``pos mod W``, and a reused slot starts clean as
the full caches do (see the constructor).

The batcher works the same over bf16 and int8 KV caches (``kv_quant``,
the int8 decode-attention kernel) and over quantized weights.  Where the
reference jits ``decode_step``, the port calls it as it is: positions and
tokens go to the device as tensors, and one host sync an iteration reads
the sampled tokens back.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list
    max_new: int
    # filled by the batcher
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False
    # iteration stamps: admitted at the start of iteration `submit_iter`,
    # done by the end of iteration `complete_iter - 1`.  A request with P
    # prompt and G new tokens completes at submit_iter + P + G - 1 (the
    # contract the reference's fleet simulator reproduces, with this
    # batcher as the golden latency reference).
    submit_iter: int = -1
    complete_iter: int = 0


class ContinuousBatcher:
    FREE, PREFILL, GEN = 0, 1, 2

    def __init__(self, model, params, *, n_slots: int, max_seq: int,
                 kv_quant: bool = False):
        family = model.cfg.family
        # A windowed model's ring buffers do not leak what a slot served
        # before: ring slot r is read only when r <= pos, and the new
        # request has rewritten slots 0..pos (all of them once pos >= W).
        if family in ("ssm", "hybrid"):
            raise NotImplementedError(
                f"{model.cfg.name}: continuous batching of the {family!r} "
                f"family is refused (ROADMAP C.8): the reference's batcher "
                f"reuses a slot without resetting its SSM state and conv "
                f"caches, so a request's tokens would depend on what the "
                f"slot served before")
        if family in ("vlm", "audio"):
            raise NotImplementedError(
                f"{model.cfg.name}: continuous batching of the {family!r} "
                f"family is refused (ROADMAP C.10): the reference's batcher "
                f"inits its caches and never fills the context caches "
                f"ctx_k / ctx_v (no request carries a context), so every "
                f"request would attend to an all-zero context")
        if family == "moe":
            raise NotImplementedError(
                f"{model.cfg.name}: continuous batching of the 'moe' family "
                f"is refused (ROADMAP C.9): the reference's step feeds free "
                f"slots' stale tokens to decode_step, and they take expert "
                f"capacity from live requests, so a request's tokens would "
                f"depend on the requests that ran before it")
        self.model = model
        self.params = params
        self.n = n_slots
        self.max_seq = max_seq
        self.caches = model.init_cache(n_slots, max_seq, kv_quant=kv_quant)
        self.queue: deque[Request] = deque()
        self.state = np.full(n_slots, self.FREE)
        self.pos = np.zeros(n_slots, np.int32)
        self.cursor = np.zeros(n_slots, np.int32)      # prompt replay index
        self.slot_req: list = [None] * n_slots
        self.next_tok = np.zeros(n_slots, np.int64)
        self._step = model.decode_step
        self.completed: list[Request] = []
        self.it = 0                       # iteration counter (wall clock)

    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        for s in range(self.n):
            if self.state[s] == self.FREE and self.queue:
                req = self.queue.popleft()
                self.slot_req[s] = req
                req.submit_iter = self.it
                self.state[s] = self.PREFILL
                self.pos[s] = 0
                self.cursor[s] = 0
                self.next_tok[s] = req.prompt[0]

    @property
    def busy(self) -> bool:
        return bool(self.queue) or bool((self.state != self.FREE).any())

    def step(self):
        """One iteration: every non-free slot advances one token.

        The iteration counter advances even when every slot is idle, so
        a caller pacing submissions against wall-clock arrival times can
        model idle gaps.
        """
        self._admit()
        if not (self.state != self.FREE).any():
            self.it += 1
            return
        dev = self.model.device
        tokens = torch.from_numpy(self.next_tok.copy()).to(dev)[:, None]
        pos = torch.from_numpy(self.pos.copy()).to(dev)
        logits, self.caches = self._step(self.params, self.caches,
                                         tokens, pos)
        sampled = logits[:, 0].argmax(dim=-1).to(torch.int32).cpu().numpy()

        for s in range(self.n):
            if self.state[s] == self.FREE:
                continue
            req = self.slot_req[s]
            self.pos[s] += 1
            if self.state[s] == self.PREFILL:
                self.cursor[s] += 1
                if self.cursor[s] < len(req.prompt):
                    self.next_tok[s] = req.prompt[self.cursor[s]]
                else:                     # prompt done -> first gen token
                    self.state[s] = self.GEN
                    req.generated.append(int(sampled[s]))
                    self.next_tok[s] = sampled[s]
            else:                          # GEN
                req.generated.append(int(sampled[s]))
                self.next_tok[s] = sampled[s]
            if self.state[s] == self.GEN and (
                    len(req.generated) >= req.max_new
                    or self.pos[s] >= self.max_seq - 1):
                req.done = True
                req.complete_iter = self.it + 1
                self.completed.append(req)
                self.state[s] = self.FREE
                self.slot_req[s] = None
        self.it += 1

    def run(self, max_iters: int = 10000):
        """Iterate until drained; raise if ``max_iters`` cuts serving
        short (in-flight and queued requests would vanish otherwise)."""
        it = 0
        while self.busy and it < max_iters:
            self.step()
            it += 1
        if self.busy:
            in_flight = sum(1 for r in self.slot_req if r is not None)
            raise RuntimeError(
                f"ContinuousBatcher.run hit max_iters={max_iters} while "
                f"busy: {len(self.completed)} completed, {in_flight} "
                f"in flight, {len(self.queue)} queued; raise max_iters "
                f"or drain incrementally with step()")
        return self.completed
