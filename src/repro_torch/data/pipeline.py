"""Deterministic, seekable data pipeline: the port of ``repro.data.pipeline``.

Every batch is a pure function of (seed, step) — ``batch_at(step)`` — so a
restarted worker resumes mid-epoch with zero coordination state beyond the
step counter in the checkpoint.  No iterator state is ever persisted.

Three sources:
  * ``SyntheticLM``      — fast hash-derived token streams (smoke/e2e tests);
  * ``CorpusLM``         — tokenized byte corpus, strided windows over a
                           document ring (deterministic shuffling by step);
  * ``RegexStructured``  — the paper's `regrep` use-case as a *pipeline
                           stage*: synthesizes structured records from an RE,
                           and (via the parallel parser) extracts group spans
                           to build supervised extraction examples — the RE
                           parser as a first-class data-plane feature.

The tokens are numpy ints from numpy's Philox, drawn exactly as the
reference draws them, so both packages give the same integers for the same
(seed, step); ``RegexStructured`` parses its records with the port's
``ParserEngine`` (on the card by default: ``backend="cuda"``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


def _philox(seed: int, step: int, n: int, lo: int, hi: int) -> np.ndarray:
    """Deterministic ints from (seed, step) — numpy Philox counter RNG."""
    rng = np.random.Generator(np.random.Philox(key=seed, counter=[0, 0, 0, step]))
    return rng.integers(lo, hi, size=n, dtype=np.int64).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        toks = _philox(
            self.seed, step, self.global_batch * self.seq_len, 0, self.vocab_size
        ).reshape(self.global_batch, self.seq_len)
        return {"tokens": toks}


@dataclasses.dataclass(frozen=True)
class CorpusLM:
    """Byte-level LM windows over an in-memory corpus, seekable by step."""

    corpus: bytes
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        n = len(self.corpus) - self.seq_len - 1
        assert n > 0, "corpus shorter than seq_len"
        starts = _philox(self.seed, step, self.global_batch, 0, n)
        buf = np.frombuffer(self.corpus, dtype=np.uint8)
        rows = np.stack([buf[s : s + self.seq_len] for s in starts])
        return {"tokens": rows.astype(np.int32)}


# ------------------------------------------------------- regex-structured


@dataclasses.dataclass
class RegexStructured:
    """Structured-record source driven by an RE (paper Sect. 1 `regrep` case).

    ``pattern`` describes one record (groups mark fields).  Records are
    *generated* by sampling the RE's AST (REgen-style, App. A of the paper)
    and *parsed back* with the parallel parser; the group spans from the SLPF
    become extraction labels.  This closes the loop: the same automaton
    artifacts serve the data plane and the serving plane.
    """

    pattern: str
    seq_len: int
    global_batch: int
    seed: int = 0
    n_chunks: int = 8
    backend: str = "cuda"
    device: Optional[str] = None       # None: the card

    def __post_init__(self):
        from ..core.engine import ParserEngine
        from ..core.reference import ParallelArtifacts
        from .regen import sample_string

        self._art = ParallelArtifacts.generate(self.pattern)
        self._engine = ParserEngine(self._art.matrices, backend=self.backend, device=self.device)
        self._sample = sample_string

    def record_at(self, seed: int) -> bytes:
        ast = self._art.table.numbered.ast
        rng = np.random.Generator(np.random.Philox(key=self.seed, counter=[1, 0, 0, seed]))
        return self._sample(ast, rng)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rows = np.zeros((self.global_batch, self.seq_len), dtype=np.int32)
        spans: List[List[Tuple[int, int, int]]] = []
        for i in range(self.global_batch):
            rec = self.record_at(step * self.global_batch + i)[: self.seq_len]
            arr = np.frombuffer(rec, dtype=np.uint8).astype(np.int32)
            rows[i, : len(arr)] = arr
            slpf = self._engine.parse(rec, n_chunks=self.n_chunks)
            tree = next(slpf.iter_trees(limit=1), None)
            spans.append(slpf.get_children(tree) if tree is not None else [])
        max_spans = max(1, max(len(s) for s in spans))
        span_arr = np.full((self.global_batch, max_spans, 3), -1, dtype=np.int32)
        for i, s in enumerate(spans):
            for j, (num, a, b) in enumerate(s[:max_spans]):
                span_arr[i, j] = (num, a, b)
        return {"tokens": rows, "spans": span_arr}
