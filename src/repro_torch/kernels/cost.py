"""The least time a kernel launch could take on the card: one formula a kernel.

Each launcher module (``reach``, ``build``, ``semiring``, ``packed_reach``,
``sparse_reach``, ``flash_attention``, ``ssd_chunk``) has two functions of
its launch's arguments, read from their shapes and dtypes alone (no value):

  ``shapes(...)``  the outputs' (shape, dtype), in the output's structure
                   (K7's pair, with None for an output not asked for);
  ``cost(...)``    a :class:`Cost`: the operations the launch does and the
                   bytes it must move (each input read once, each output
                   written once), with the card's peak rate for the
                   operations' type.

They are what a launch on tensors with no storage returns and records
(``ops.KernelWrapper.model``, the dry-run's traces) and what
``chip_smoke.py``'s kernel table reads for its ``bound_ms``.  Where the work
depends on the data (the parser's PAD steps, its ℓ live states of ℓp, K5's
feasible rows), ``cost`` takes the counts as keywords, each a number or a
sequence of them, one a tenant of a fleet launch (:func:`total`); by default
it counts every step, state and row the shapes hold.

The rates are an NVIDIA H100 SXM's (NVIDIA's data sheet, dense, at the card's
full power limit of 700 W): the parser's {0, 1} products are exact on the
int8 tensor cores, the cheapest exact type; the LM kernels run at the rate of
their operands' type (bf16 tensor cores, or f32 outside them: TF32 would
not be exact).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np

INT8_OPS = 1979e12           # int8, tensor cores, dense, per card
BF16_FLOPS = 989e12          # bf16, tensor cores, dense, per card
F32_FLOPS = 67e12            # f32, CUDA cores, per card
HBM_BW = 3.35e12             # bytes/s of device memory, per card


class Cost(NamedTuple):
    """One launch's operations, bytes and the peak rate of its operations."""

    ops: float
    bytes: float
    rate: float

    @property
    def ops_s(self) -> float:
        return self.ops / self.rate

    @property
    def bytes_s(self) -> float:
        return self.bytes / HBM_BW

    @property
    def seconds(self) -> float:
        """The bound: the larger of the operations' and the bytes' times."""
        return max(self.ops_s, self.bytes_s)

    @property
    def bound_by(self) -> str:
        return "operations" if self.ops_s >= self.bytes_s else "bytes"


def float_rate(dtype) -> float:
    """The peak rate of the LM kernels' operands: bf16 on the tensor cores,
    anything else in f32."""
    import torch

    return BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS


def total(fn: Callable, *counts) -> float:
    """``fn`` of the counts, summed: each count a number or a sequence (one
    entry a tenant of a fleet launch), broadcast together."""
    return float(np.sum(fn(*(np.asarray(c, dtype=np.float64) for c in counts))))
