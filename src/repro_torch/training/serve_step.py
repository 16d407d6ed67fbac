"""Serving: a decode-step factory, a greedy generate loop and a minimal
continuous-batching scheduler (slot-based, host-driven).

``serve_step`` is one batched single-token decode against a full KV
cache.  The cache's tensors are updated in place.  Serving tracks no
gradient, so a trainer's weights (``requires_grad``) serve as they are.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable

import numpy as np
import torch

from ..models.model_zoo import Model
from ..models.sharding import get_rules


def make_serve_step(model: Model) -> Callable:
    """serve_step(params, token (B,1) int32, cache) -> (token', cache)."""

    @torch.no_grad()
    def serve_step(params, token, cache):
        logits, cache = model.decode_step(params, token, cache)
        # the vocab whole before the argmax (an identity with no mesh)
        logits = get_rules().constrain(logits, "batch", None, None)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return nxt[:, None], cache

    return serve_step


@torch.no_grad()
def greedy_generate(model: Model, params, batch: dict, *, max_new: int,
                    max_len: int) -> np.ndarray:
    """Prefill the prompt then decode ``max_new`` tokens greedily."""
    logits, cache = model.prefill(params, batch, max_len)
    tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
    step = make_serve_step(model)
    out = [tok.cpu().numpy()]
    for _ in range(max_new - 1):
        tok, cache = step(params, tok, cache)
        out.append(tok.cpu().numpy())
    return np.concatenate(out, axis=1)


# ----------------------------------------------------------------------
@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (S,) int32
    max_new: int
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ContinuousBatcher:
    """Slot-based continuous batching: a fixed decode batch of ``slots``;
    finished requests release their slot, queued requests are prefilled
    into it.  Host-side control, device-side caches — the standard
    serving shape (vLLM-lite) on top of serve_step."""

    def __init__(self, model: Model, params, *, slots: int, max_len: int):
        self.model = model
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.queue: deque[Request] = deque()
        self.active: list[Request | None] = [None] * slots
        self.cache = model.init_cache(slots, max_len)
        self.tokens = torch.zeros((slots, 1), dtype=torch.int32,
                                  device=model.device)
        self._step = make_serve_step(model)

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        for slot in range(self.slots):
            if self.active[slot] is None and self.queue:
                req = self.queue.popleft()
                self.active[slot] = req
                # prefill one request, splice its cache into the batch
                b = {"tokens": req.prompt[None, :]}
                logits, c1 = self.model.prefill(self.params, b,
                                                self.max_len)
                first = int(torch.argmax(logits[0, -1]))
                req.generated.append(first)
                self.tokens[slot, 0] = first
                self.cache = _splice_cache(self.cache, c1, slot)

    @torch.no_grad()
    def run(self) -> list[Request]:
        """Admit, then one batched decode step, then collect the tokens,
        until every request is done."""
        finished = []
        while self.queue or any(self.active):
            self._admit()
            self.tokens, self.cache = self._step(self.params, self.tokens,
                                                 self.cache)
            toks = self.tokens.cpu().numpy()
            for slot, req in enumerate(self.active):
                if req is None:
                    continue
                req.generated.append(int(toks[slot, 0]))
                if len(req.generated) >= req.max_new:
                    req.done = True
                    finished.append(req)
                    self.active[slot] = None
        return finished


def _splice_cache(batch_cache, single_cache, slot: int):
    """Write a single-request cache into slot ``slot`` of the batched
    cache, in place, leaf by leaf over the tree (dicts, and tuples such
    as ``MambaCache``, ``MLSTMCache`` or ``SLSTMCache``), as the
    reference's ``jax.tree.map`` walks it.  The batch axis of each tensor
    is found structurally (the first axis where the two differ; none:
    left as it is).  A scalar, the shared ``length``, is replaced by the
    single cache's, as in the reference: slots filled at other lengths
    then decode at this request's position."""
    if isinstance(batch_cache, dict):
        return {name: _splice_cache(b, single_cache[name], slot)
                for name, b in batch_cache.items()}
    if isinstance(batch_cache, tuple):
        return type(batch_cache)(*(
            _splice_cache(b, s, slot)
            for b, s in zip(batch_cache, single_cache, strict=True)))
    b, s = batch_cache, single_cache
    if not isinstance(b, torch.Tensor) or b.dim() == 0:
        return s
    axes = [i for i in range(b.dim())
            if i < s.dim() and b.shape[i] != s.shape[i]]
    if axes:
        ax = axes[0]
        # the reference's dynamic_update_slice clamps the start
        start = min(slot, b.shape[ax] - s.shape[ax])
        b.narrow(ax, start, s.shape[ax]).copy_(s)
    return b
