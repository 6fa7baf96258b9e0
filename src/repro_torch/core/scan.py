"""The join's scan: exclusive entries from stacked chunk summaries.

The paper's join (Eq. 7) is an exclusive scan over the chunk products.  Here it
is a log-depth (Hillis–Steele) loop over the chunk axis: level ``d`` combines
every summary with the one ``d`` places earlier, so a stack of c summaries
takes ⌈log₂ c⌉ batched combines.  Any scan order gives the same bits, because
the OR-AND semiring on {0,1} is exact.

A summary is one tensor (the parser's products) or a tuple of tensors that
share the chunk axis (the SSD layer's (decay, state) pairs,
``models/mamba.py``).  ``combine(later, earlier)`` and ``act(summaries,
state)`` work on whole stacks: each is one batched call over the leading
axes, where the reference vmaps a single-element function.
"""

from __future__ import annotations

from typing import Callable, Tuple, TypeVar, Union

import torch

Summary = TypeVar("Summary", torch.Tensor, Tuple[torch.Tensor, ...])
Combine = Callable[[Summary, Summary], Summary]       # (later, earlier)
Act = Callable[[Summary, torch.Tensor], torch.Tensor]  # (summaries, state)


def _map(fn, xs: Union[torch.Tensor, tuple]):
    return tuple(fn(x) for x in xs) if isinstance(xs, tuple) else fn(xs)


def _cat(a, b):
    if isinstance(a, tuple):
        return tuple(torch.cat([x, y], dim=0) for x, y in zip(a, b))
    return torch.cat([a, b], dim=0)


def associative_prefix(combine: Combine, xs: Summary) -> Summary:
    """Inclusive prefix combine along axis 0: out[i] = xs[i] ⊗ … ⊗ xs[0]."""
    c = (xs[0] if isinstance(xs, tuple) else xs).shape[0]
    d = 1
    while d < c:
        xs = _cat(_map(lambda x: x[:d], xs),
                  combine(_map(lambda x: x[d:], xs), _map(lambda x: x[:-d], xs)))
        d *= 2
    return xs


def exclusive_entries(
    combine: Combine, act: Act, summaries: Summary, init: torch.Tensor
) -> torch.Tensor:
    """Entry state per chunk from stacked summaries (axis 0).

    ``entries[0] = init``; ``entries[i] = act(summaries[i-1] ⊗ … ⊗
    summaries[0], init)``.  ``act`` maps the stack of prefixes (c, …) to the
    stack of states after each chunk; ``init`` broadcasts against one state.
    """
    applied = act(associative_prefix(combine, summaries), init)
    first = torch.broadcast_to(init, applied.shape[1:]).unsqueeze(0)
    return torch.cat([first.to(applied.dtype), applied[:-1]], dim=0)
