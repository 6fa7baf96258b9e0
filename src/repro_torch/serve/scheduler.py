"""Continuous batching for the serving engine: the port of
``repro.serve.scheduler``.

A slot-based scheduler over the fixed-batch decode step: requests arrive
with different prompts, lengths and constraints; the scheduler packs them
into ``batch`` decode slots and admits a new request the moment a slot frees
(no head-of-line blocking on the longest sequence).

Per-slot state lives on the host (positions, constraint DFA states, emitted
tokens); the device caches are shared across slots, each slot owning a batch
row.  Freed rows are re-primed by step-wise prefill of the next request's
prompt while other rows keep decoding (prefill steps feed dummy tokens to
finished or waiting rows; their cache rows are masked by per-row positions).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional

import numpy as np
import torch

from ..core.engine import resolve_device
from ..models.config import ModelConfig
from ..models.model import decode_step, make_cache
from .engine import TokenDFA


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (Lp,) int32
    max_new: int
    temperature: float = 0.0
    constraint: Optional[TokenDFA] = None
    # filled by the scheduler:
    output: Optional[np.ndarray] = None


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None
    pos_in_prompt: int = 0
    emitted: int = 0
    dfa_state: int = 0
    tokens: List[int] = dataclasses.field(default_factory=list)

    @property
    def free(self) -> bool:
        return self.req is None


class ContinuousBatcher:
    """Slot scheduler over a fixed-batch decode program on ``device`` (None:
    the card; raises without one)."""

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        batch: int = 4,
        max_seq: int = 256,
        eos_id: int = 0,
        seed: int = 0,
        device=None,
    ):
        self.cfg = cfg
        self.params = params
        self.batch = batch
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.device = resolve_device(device)
        self._caches = make_cache(cfg, batch, max_seq, device=self.device)
        self._slots = [_Slot() for _ in range(batch)]
        self._queue: Deque[Request] = deque()
        self._done: List[Request] = []
        self._rng = np.random.default_rng(seed)

    # ------------------------------------------------------------- admission

    def submit(self, req: Request) -> None:
        self._queue.append(req)

    def _admit(self) -> None:
        for i, slot in enumerate(self._slots):
            if slot.free and self._queue:
                req = self._queue.popleft()
                slot.req = req
                slot.pos_in_prompt = 0
                slot.emitted = 0
                slot.tokens = []
                slot.dfa_state = req.constraint.initial if req.constraint is not None else 0
                # slot reuse isolation: mask this row's stale attention cache
                # behind the current position, and zero its SSM state rows
                if "row_start" in self._caches:
                    self._caches["row_start"][i] = int(self._caches["pos"])
                if "ssm" in self._caches:
                    self._caches["ssm"]["state"][:, i] = 0.0
                    self._caches["ssm"]["conv"][:, i] = 0.0

    # ---------------------------------------------------------------- stepping

    def _next_feed(self) -> np.ndarray:
        """Token each row feeds THIS step (prompt token, sampled token, or pad)."""
        feed = np.zeros((self.batch, 1), np.int32)
        for i, slot in enumerate(self._slots):
            if slot.free:
                continue
            req = slot.req
            if slot.pos_in_prompt < len(req.prompt):
                feed[i, 0] = req.prompt[slot.pos_in_prompt]
            elif slot.tokens:
                feed[i, 0] = slot.tokens[-1]
            else:
                feed[i, 0] = req.prompt[-1]
        return feed

    def _sample_row(self, i: int, logits_row: np.ndarray) -> int:
        slot = self._slots[i]
        req = slot.req
        lg = logits_row.astype(np.float32)
        if req.constraint is not None:
            mask = req.constraint.delta[slot.dfa_state] >= 0
            mask[self.eos_id] = bool(req.constraint.final[slot.dfa_state])
            if not mask.any():
                return self.eos_id
            lg = np.where(mask, lg, -np.inf)
        if req.temperature <= 0:
            return int(lg.argmax())
        g = self._rng.gumbel(size=lg.shape).astype(np.float32)
        return int((lg / req.temperature + g).argmax())

    @torch.no_grad()
    def step(self) -> bool:
        """One engine iteration; returns False when nothing is in flight."""
        self._admit()
        if all(s.free for s in self._slots) and not self._queue:
            return False
        feed = torch.as_tensor(self._next_feed().astype(np.int64), device=self.device)
        logits, self._caches = decode_step(self.params, self._caches, feed, self.cfg)
        logits = logits[:, -1].float().cpu().numpy()
        for i, slot in enumerate(self._slots):
            if slot.free:
                continue
            req = slot.req
            if slot.pos_in_prompt < len(req.prompt) - 1:
                slot.pos_in_prompt += 1        # still prefilling this row
                continue
            slot.pos_in_prompt += 1
            tok = self._sample_row(i, logits[i])
            finished = tok == self.eos_id
            if not finished:
                slot.tokens.append(tok)
                slot.emitted += 1
                if req.constraint is not None:
                    slot.dfa_state = int(req.constraint.delta[slot.dfa_state, tok])
                    if slot.dfa_state < 0:
                        finished = True
            total_pos = len(req.prompt) + slot.emitted
            if finished or slot.emitted >= req.max_new or total_pos >= self.max_seq - 1:
                req.output = np.asarray(slot.tokens, np.int32)
                self._done.append(req)
                slot.req = None               # slot frees; next admit() reuses it
        return True

    def run(self) -> List[Request]:
        """Drive to completion; returns finished requests in completion order.

        Slot reuse is exact: on admission the row's ``row_start`` is set to
        the current global position (stale K/V masked in ``decode_attention``)
        and its SSM state rows are zeroed.
        """
        while self._queue or any(not s.free for s in self._slots):
            if not self.step():
                break
        out, self._done = self._done, []
        return out
