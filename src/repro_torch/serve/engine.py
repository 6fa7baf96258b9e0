"""Batched serving engine with RE-constrained decoding: the port of
``repro.serve.engine``.

The paper's parser automaton becomes a structured-output constraint.
``TokenDFA`` lifts the byte/char-class parser DFA to the token vocabulary
(token = byte string → composed transition), giving a per-state allowed-token
mask; ``ServeEngine.generate`` applies the mask before sampling, so every
emitted sequence is a prefix of ``L(e)`` and termination is only allowed in
accepting states.

The engine is the reference's loop: step-wise prefill populating the KV /
SSM caches, then greedy or temperature decode, batched.  Sampling draws
Gumbel noise from a ``torch.Generator``: at temperature > 0 its tokens differ
from the reference's ``jax.random`` draws by design; greedy decoding is the
parity case.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.automata import DFA, build_dfa, build_nfa
from ..core.engine import resolve_device
from ..core.matrices import ParserMatrices
from ..models.config import ModelConfig
from ..models.model import decode_step, make_cache


# ------------------------------------------------------------- token DFA


@dataclasses.dataclass
class TokenDFA:
    """Parser DFA lifted to a token vocabulary.

    ``delta``: (n_states, vocab) int32 — next state or -1 (dead).
    ``final``: (n_states,) bool — states where EOS is allowed.
    """

    delta: np.ndarray
    final: np.ndarray
    initial: int

    @classmethod
    def from_matrices(
        cls,
        matrices: ParserMatrices,
        vocab: Sequence[bytes],
        dfa: Optional[DFA] = None,
    ) -> "TokenDFA":
        if dfa is None:
            dfa = build_dfa(build_nfa(matrices.table))
        byte_cls = matrices.byte_to_class
        vocab_classes = [
            byte_cls[np.frombuffer(t, dtype=np.uint8)] if len(t) else np.zeros(0, np.int64)
            for t in vocab
        ]

        def token_step(sid: int, classes) -> int:
            cur: Optional[int] = sid
            for c in classes:
                if cur is None:
                    return -1
                cur = dfa.step(cur, int(c))
            return -1 if cur is None else cur

        # BFS over token transitions (token transitions only visit states of
        # the byte DFA, which is already closed)
        work = [dfa.initial[0]]
        seen = {dfa.initial[0]}
        rows: Dict[int, np.ndarray] = {}
        while work:
            sid = work.pop()
            row = np.full(len(vocab), -1, dtype=np.int32)
            for tid, classes in enumerate(vocab_classes):
                nxt = token_step(sid, classes)
                row[tid] = nxt
                if nxt >= 0 and nxt not in seen:
                    seen.add(nxt)
                    work.append(nxt)
            rows[sid] = row
        n = max(seen) + 1
        delta = np.full((n, len(vocab)), -1, dtype=np.int32)
        for sid, row in rows.items():
            delta[sid] = row
        final = np.zeros(n, dtype=bool)
        for sid in seen:
            final[sid] = dfa.final[sid]
        return cls(delta=delta, final=final, initial=dfa.initial[0])


def byte_vocab(vocab_size: int) -> List[bytes]:
    """Token id = byte id (ids ≥ 256 are non-lexical controls → dead)."""
    return [bytes([i]) if i < 256 else b"\xff\xff" for i in range(vocab_size)]


# ---------------------------------------------------------------- engine


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray           # (b, n_new)
    accepted: Optional[np.ndarray] = None   # constraint acceptance per row


class ServeEngine:
    """Fixed-batch decode over ``models.model.decode_step`` on ``device``
    (None: the card; raises without one)."""

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        max_seq: int = 256,
        batch: int = 1,
        eos_id: Optional[int] = None,
        device=None,
    ):
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.batch = batch
        self.eos_id = eos_id
        self.device = resolve_device(device)

    def new_caches(self):
        return make_cache(self.cfg, self.batch, self.max_seq, device=self.device)

    def _step(self, caches, tokens: np.ndarray):
        tok = torch.as_tensor(np.asarray(tokens, np.int64), device=self.device)
        return decode_step(self.params, caches, tok, self.cfg)

    @torch.no_grad()
    def generate(
        self,
        prompts: np.ndarray,          # (b, Lp) int32
        max_new: int,
        *,
        temperature: float = 0.0,
        seed: int = 0,
        constraint: Optional[TokenDFA] = None,
    ) -> GenerationResult:
        b, Lp = prompts.shape
        if b != self.batch:
            raise ValueError(f"prompts have {b} rows, the engine serves batch {self.batch}")
        caches = self.new_caches()
        logits = None
        for t in range(Lp):  # step-wise prefill (exercises the cache path)
            logits, caches = self._step(caches, prompts[:, t : t + 1])
        gen = torch.Generator()
        gen.manual_seed(seed)
        states = (
            np.full(b, constraint.initial, dtype=np.int32) if constraint is not None else None
        )
        out = np.zeros((b, max_new), dtype=np.int32)
        done = np.zeros(b, dtype=bool)
        for i in range(max_new):
            lg = logits[:, -1].float().cpu().numpy()          # (b, V)
            stuck = None
            if constraint is not None:
                mask = constraint.delta[states] >= 0          # (b, V)
                if self.eos_id is not None:
                    mask[:, self.eos_id] = constraint.final[states]
                lg = np.where(mask, lg, -np.inf)
                # dead-end guard: if nothing is allowed, force EOS/stop
                stuck = ~mask.any(axis=1)
                done |= stuck
            if temperature <= 0.0:
                nxt = lg.argmax(axis=-1).astype(np.int32)
            else:
                u = torch.rand(lg.shape, generator=gen, dtype=torch.float64).numpy()
                g = (-np.log(-np.log(np.clip(u, 1e-300, 1.0 - 1e-16)))).astype(np.float32)
                nxt = (lg / temperature + g).argmax(axis=-1).astype(np.int32)
            if stuck is not None:
                # an all -inf row argmaxes to token 0 (an arbitrary, possibly
                # grammar-breaking id); stuck rows emit EOS, or the -1
                # sentinel when no EOS is configured
                fill = self.eos_id if self.eos_id is not None else -1
                nxt = np.where(stuck, np.int32(fill), nxt)
            if self.eos_id is not None:
                done |= nxt == self.eos_id
            out[:, i] = nxt
            if constraint is not None:
                alive = ~done
                states[alive] = constraint.delta[states[alive], nxt[alive]]
            if done.all():
                out = out[:, : i + 1]
                break
            logits, caches = self._step(caches, nxt[:, None])
        accepted = None
        if constraint is not None:
            accepted = np.where(states >= 0, constraint.final[np.maximum(states, 0)], False)
        return GenerationResult(tokens=out, accepted=accepted)
