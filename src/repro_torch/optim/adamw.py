"""AdamW with fp32 master weights, cosine schedule, global-norm clipping: the
port of ``repro.optim.adamw``.

Mixed-precision discipline (the reference's):
  * live params are in ``param_dtype`` (bf16: matmul inputs);
  * the optimizer state holds an fp32 master copy plus fp32 (m, v);
  * gradients arrive in fp32 (the train step's accumulation of bf16
    microbatch gradients) and the update runs in fp32.

The formula is the reference's, not ``torch.optim.AdamW``'s: the gradients
are clipped by their global norm before the moments, the bias correction
uses the new step, weight decay applies to leaves of two or more dims only
(norms, biases and scalars are not decayed) and is added to the Adam
direction, and the masters are re-cast to ``param_dtype``.

Plain functions over the nested-dict param tree.  Unlike the reference,
which returns new arrays, ``apply_updates`` updates the masters, moments
and params in place, a leaf at a time and a slice of at most ``CHUNK``
elements at a time along its leading axis, so that a full-width model's
update needs no second copy of the state (zamba2-2.7b: 2.34 B parameters,
~47 GB of params, gradients and state).  The arithmetic is the reference's,
operation for operation, in f32.

On a mesh the leaves are DTensors: masters and moments are laid out like
their params (``zeros_like``), so each rank updates its own shards in place
(their local tensors), and ``global_norm`` adds each leaf's shards across
the ranks that split it (not the copies of the ranks that replicate it):
the global norm, the same on every rank.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, NamedTuple, Tuple

import numpy as np
import torch

CHUNK = 1 << 26      # elements a slice of a leaf's update (256 MB of f32)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor         # () int32, on the host
    master: Any                # fp32 copy of params
    m: Any
    v: Any


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (keys sorted, as the reference's
    tree order), with the matching leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves of nested dicts in the reference's flatten order (keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def lr_at(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup → cosine decay to lr_min, in f32 as the reference
    computes it (the value is exact as a Python float)."""
    f32 = np.float32
    step_f = f32(step)
    warm = f32(cfg.lr_peak) * step_f / f32(max(cfg.warmup_steps, 1))
    prog = np.clip((step_f - f32(cfg.warmup_steps))
                   / f32(max(cfg.total_steps - cfg.warmup_steps, 1)), f32(0.0), f32(1.0))
    cos = f32(cfg.lr_min) + f32(0.5 * (cfg.lr_peak - cfg.lr_min)) * (
        f32(1.0) + np.cos(f32(math.pi) * prog))
    return float(warm if step_f < f32(cfg.warmup_steps) else f32(cos))


def init_opt_state(params: Any) -> OptState:
    return OptState(
        step=torch.zeros((), dtype=torch.int32),
        master=tree_map(lambda p: p.detach().to(torch.float32, copy=True), params),
        m=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
        v=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
    )


def abstract_opt_state(abstract_params: Any) -> OptState:
    """The state of params with no storage (``train/step.py``'s abstract
    inputs): f32 masters and moments of the params' shapes and layouts (on
    the meta device, DTensors where the params are), and a concrete step 0
    (a host int), which ``apply_updates`` reads to schedule the learning
    rate."""
    f32 = lambda p: torch.empty_like(p, dtype=torch.float32)  # noqa: E731
    return OptState(
        step=0,
        master=tree_map(f32, abstract_params),
        m=tree_map(f32, abstract_params),
        v=tree_map(f32, abstract_params),
    )


def _slices(t: torch.Tensor) -> Iterator[torch.Tensor]:
    """Views of ``t`` along its leading axis, each of at most CHUNK elements
    (one view of the whole tensor when it is small or 0-d)."""
    if t.dim() == 0 or t.numel() <= CHUNK:
        yield t
        return
    rows = max(1, CHUNK // max(1, t[0].numel()))
    for i in range(0, t.shape[0], rows):
        yield t[i : i + rows]


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local tensor (its storage or a view of it: writes to it
    are the DTensor's), or ``t``."""
    return t.to_local() if hasattr(t, "to_local") else t


def _square_sum(g: torch.Tensor) -> torch.Tensor:
    """The sum of the squares of a whole gradient leaf (f32, 0-d, plain)."""
    total = None
    for piece in _slices(_local(g)):
        sq = torch.sum(piece.float() ** 2)
        total = sq if total is None else total + sq
    if hasattr(g, "device_mesh"):
        from torch.distributed.tensor import DTensor, Partial, Replicate

        places = [Partial() if p.is_shard() else Replicate() for p in g.placements]
        total = DTensor.from_local(total, g.device_mesh, places, run_check=False).full_tensor()
    return total


def global_norm(grads: Any) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares, in f32 (a 0-d plain tensor
    on the gradients' device)."""
    return torch.sqrt(sum(_square_sum(g) for g in tree_leaves(grads)))


@torch.no_grad()
def apply_updates(
    cfg: AdamWConfig,
    params: Any,
    grads: Any,
    state: OptState,
    param_dtype=torch.bfloat16,
) -> Tuple[Any, OptState, Dict[str, Any]]:
    """One AdamW step.  Returns (params, state, {"grad_norm", "lr"}): the
    same param tensors and state tensors, updated in place, with the step
    advanced; ``grad_norm`` is a 0-d tensor, ``lr`` a float."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    step = int(state.step) + 1
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(step))
    bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(step))

    def upd(p, g, m, v, master):
        decay = master.dim() >= 2
        for gs, ms, vs, mast, ps in zip(_slices(g), _slices(m), _slices(v), _slices(master),
                                        _slices(p)):
            gs = gs.float() * scale
            ms.copy_(b1 * ms + (1 - b1) * gs)
            vs.copy_(b2 * vs + (1 - b2) * gs * gs)
            mh = ms / bc1
            vh = vs / bc2
            delta = mh / (torch.sqrt(vh) + cfg.eps)
            if decay:
                delta = delta + cfg.weight_decay * mast
            mast.copy_(mast - lr * delta)
            ps.copy_(mast.to(param_dtype))

    for leaves in zip(*(tree_leaves(t) for t in (params, grads, state.m, state.v,
                                                  state.master))):
        upd(*map(_local, leaves))
    new_state = OptState(step=torch.tensor(step, dtype=torch.int32), master=state.master,
                         m=state.m, v=state.v)
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
