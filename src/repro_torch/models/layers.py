"""Transformer building blocks in PyTorch: the port of ``repro.models.layers``.

Conventions (the reference's):
  * activations: (batch, seq, d_model) in ``cfg.dtype`` (bf16 by default);
  * params: nested dicts of tensors with the reference's names, declared via
    ``ParamDecl`` so that shapes, logical sharding axes and initializers live
    in one place;
  * attention is GQA with RoPE, an optional sliding window and an optional
    logit softcap.  Prefill and training attention is K6
    (``kernels/ops.flash_attention``, its plain version on the CPU); decode
    attends one token against the cache here;
  * head padding follows ``HeadPlan`` (zero-padded query heads, zero rows of
    the output projection), so the math is exact.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel.sharding import whole_dim

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


# ------------------------------------------------------------ declarations


@dataclasses.dataclass(frozen=True)
class ParamDecl:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]   # logical sharding axis per dim
    init: str = "normal"                 # normal | zeros | ones | scaled
    scale: float = 0.02

    def materialize(self, gen: torch.Generator, dtype, device) -> torch.Tensor:
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=device)
        scale = self.scale
        if self.init == "scaled":  # 1/sqrt(fan_in) on the penultimate dim
            fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
            scale = 1.0 / math.sqrt(fan_in)
        x = torch.randn(self.shape, generator=gen, dtype=torch.float32, device=device)
        return (x * scale).to(dtype)


def tree_init(decls: Any, gen: torch.Generator, dtype, device) -> Any:
    """Materialize a nested dict of ParamDecl in sorted-key order."""
    if isinstance(decls, ParamDecl):
        return decls.materialize(gen, dtype, device)
    return {k: tree_init(decls[k], gen, dtype, device) for k in sorted(decls)}


def tree_abstract(decls: Any, dtype) -> Any:
    """The declared params as tensors on the meta device: shapes and dtype,
    no storage (the reference's ``ShapeDtypeStruct`` tree)."""
    if isinstance(decls, ParamDecl):
        return torch.empty(decls.shape, dtype=dtype, device="meta")
    return {k: tree_abstract(v, dtype) for k, v in decls.items()}


def tree_logical(decls: Any) -> Any:
    """Every param's logical axes, in the tree's structure."""
    if isinstance(decls, ParamDecl):
        return decls.logical
    return {k: tree_logical(v) for k, v in decls.items()}


# ----------------------------------------------------------------- norms


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


# ------------------------------------------------------------------ RoPE


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # (hd/2,)
    angles = positions[..., None].float() * freqs               # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------- attention


def repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(b, s, kv, hd) → (b, s, kv*groups, hd) by head repetition (GQA)."""
    if groups == 1:
        return k
    b, s, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, groups, hd).reshape(b, s, kv * groups, hd)


def decode_attention(
    q: torch.Tensor,                 # (b, 1, h, hd)   h = padded query heads
    k_cache: torch.Tensor,           # (b, S, kv, hd)  (ring-buffered slots)
    v_cache: torch.Tensor,
    kpos: torch.Tensor,              # (S,) int32 — absolute position per slot (-1 empty)
    pos: int,                        # index of the new token
    *,
    groups: int,
    grouped: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    row_start: Optional[torch.Tensor] = None,   # (b,) — continuous batching
) -> torch.Tensor:
    """Single-step grouped attention against a (possibly ring-buffered) cache.

    Exact head plans attend grouped (K/V never repeated); non-exact ones
    repeat.  Masks use each slot's absolute position, so overwritten ring
    slots never leak, and ``row_start`` masks positions before each row's
    current request (slot reuse in ``serve/scheduler.py``).  A ``softcap`` c
    maps the scaled scores s to c·tanh(s/c) before the mask."""
    b, S, kv, hd = k_cache.shape
    h = q.shape[2]
    if not grouped:
        # repeat_kv(cache, groups)[:, :, :h] as one gather: its reshape
        # flattens the kv heads beside slots split over 'model', which
        # DTensor (torch 2.11) refuses
        rep = torch.arange(h, device=k_cache.device) // groups
        k_cache = k_cache.index_select(2, rep)
        v_cache = v_cache.index_select(2, rep)
        kv = h
        groups = 1
    assert h == kv * groups, (h, kv, groups)
    scale = 1.0 / math.sqrt(hd)
    # on a mesh q's heads are split over 'model' where h divides it, and kv
    # groups of them need not line up with the split (mixtral at tp 16: 3
    # heads a rank, groups of 6), which DTensor cannot reshape in place: one
    # token's q is whole on every rank first (the identity on a plain tensor)
    qg = whole_dim(q, 2).reshape(b, 1, kv, groups, hd)
    s = torch.einsum("bqcgd,bscd->bcgqs", qg.float(), k_cache.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = (kpos >= 0) & (kpos <= pos)
    if window is not None:
        mask &= kpos > pos - window
    mask = mask[None, :].expand(b, S)
    if row_start is not None:
        mask = mask & (kpos[None, :] >= row_start[:, None])
    s = s.masked_fill(~mask[:, None, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bcgqs,bscd->bqcgd", p, v_cache.float()).reshape(b, 1, h, hd)
    return out.to(q.dtype)


# ----------------------------------------------------------------- MLP


def swiglu(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


# ------------------------------------------------------- head accounting


@dataclasses.dataclass(frozen=True)
class HeadPlan:
    """Padded head counts for exact tensor-parallel grouped GQA.

    Invariant: ``pad_q == pad_kv * groups`` — attention is computed grouped,
    so padding must preserve the group shape.  Rule: smallest
    ``pad_kv ≥ n_kv`` with ``(pad_kv·groups) % tp == 0``, accepted only if it
    wastes ≤ 2× query heads; otherwise no padding (heads replicate across TP —
    exact, chosen only for small models like internvl2 where 7:1 grouping vs
    tp=16 would force 8× padding)."""

    n_q: int          # real query heads
    n_kv: int         # real kv heads
    pad_q: int        # padded query heads
    pad_kv: int       # padded kv heads (ceil(pad_q / groups))
    groups: int       # q heads per kv head (unchanged by padding)
    grouped: bool     # pad_q == pad_kv * groups → grouped decode is exact

    @classmethod
    def plan(cls, n_q: int, n_kv: int, tp: int) -> "HeadPlan":
        groups = n_q // n_kv
        assert n_q == n_kv * groups, "q heads must be a multiple of kv heads"
        if tp <= 1 or n_q % tp == 0:
            return cls(n_q, n_kv, n_q, n_kv, groups, True)
        # 1) pad q heads to the TP multiple; exact grouping if it divides
        a = ((n_q + tp - 1) // tp) * tp
        kv_a = (a + groups - 1) // groups
        if kv_a * groups == a:
            return cls(n_q, n_kv, a, kv_a, groups, True)       # e.g. phi3 48/12
        # 2) try a TP-multiple kv count within the 2× query-waste bound
        b_kv = ((n_kv + tp - 1) // tp) * tp
        if b_kv * groups <= 2 * n_q:
            return cls(n_q, n_kv, b_kv * groups, b_kv, groups, True)  # llama4 80/16
        # 3) non-exact repeat plan (decode repeats KV; e.g. internvl2 16/3)
        return cls(n_q, n_kv, a, kv_a, groups, False)
