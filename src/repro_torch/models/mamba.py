"""Mamba-2 (SSD — state-space duality) layer: the port of ``repro.models.mamba``.

The SSD recurrence per head is  ``s_t = a_t · s_{t-1} + dt_t · x_t ⊗ B_t``,
``y_t = C_t · s_t + D · x_t``: an associative affine recurrence, run as the
paper's three-phase schema (``core/scan.py``):

  reach  per chunk: the chunk's state contribution S_c — K7
         (``kernels/ops.ssd_chunk``, ``outputs="state"``: neither C nor the
         entry state is read);
  join   exclusive scan of (decay, state) pairs across chunks
         (``core.scan.exclusive_entries``);
  build  per chunk: the within-chunk quadratic form plus the inter-chunk term
         ``C_t · (decay · S_prev)`` — K7 again (``outputs="y"``), with the
         joined entry states.

So a layer's prefill is two K7 launches.  On a mesh the SSD runs on each
rank's batch rows and heads (``ssd_local``: heads are independent, so the
chunked scan is too), K7 on local tensors; the fused input projection is
split by 'mlp' over 'model', and its z / xBC / dt split crosses the shard
boundaries, so DTensor gathers the projection there.  Decode is the O(1) stepwise
recurrence against an (heads, head_dim, d_state) state cache plus a
(d_conv-1)-deep convolution cache, with no kernel.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.scan import exclusive_entries
from ..kernels import ops
from ..parallel.sharding import local_range
from .config import SSMConfig
from .layers import ParamDecl, rms_norm


def ssm_dims(d_model: int, cfg: SSMConfig) -> Dict[str, int]:
    d_inner = cfg.expand * d_model
    n_heads = d_inner // cfg.head_dim
    conv_dim = d_inner + 2 * cfg.n_groups * cfg.d_state
    return dict(d_inner=d_inner, n_heads=n_heads, conv_dim=conv_dim)


def declare_ssm(d_model: int, cfg: SSMConfig) -> Dict[str, ParamDecl]:
    dims = ssm_dims(d_model, cfg)
    di, nh, cd = dims["d_inner"], dims["n_heads"], dims["conv_dim"]
    in_dim = 2 * di + 2 * cfg.n_groups * cfg.d_state + nh
    return {
        # pure TP (no FSDP on the contracting d_model dim): the reference's
        # choice, which replicates these weights over 'data'
        "w_in": ParamDecl((d_model, in_dim), (None, "mlp"), init="scaled"),
        "conv_w": ParamDecl((cfg.d_conv, cd), (None, "mlp"), init="scaled", scale=0.1),
        "conv_b": ParamDecl((cd,), ("mlp",), init="zeros"),
        "A_log": ParamDecl((nh,), ("heads",), init="ones"),
        "D": ParamDecl((nh,), ("heads",), init="ones"),
        "dt_bias": ParamDecl((nh,), ("heads",), init="zeros"),
        "norm_w": ParamDecl((di,), ("mlp",), init="ones"),
        "w_out": ParamDecl((di, d_model), ("mlp", None), init="scaled"),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along seq via shifted adds (d_conv is tiny)."""
    d_conv = w.shape[0]
    out = x * w[-1]
    for i in range(1, d_conv):
        shifted = torch.cat([torch.zeros_like(x[:, :i]), x[:, : x.shape[1] - i]], dim=1)
        out = out + shifted * w[-1 - i]
    return out + b


def _split_zxbcdt(zxbcdt, d_inner, g, n, nh):
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner : 2 * d_inner + 2 * g * n]
    dt = zxbcdt[..., 2 * d_inner + 2 * g * n :]
    return z, xBC, dt


def _combine(later, earlier):
    a2, s2 = later
    a1, s1 = earlier
    return a2 * a1, a2[..., None, None] * s1 + s2


def _act(m, s):
    a, inc = m
    return a[..., None, None] * s + inc


def ssd_chunked(
    xdt: torch.Tensor,   # (b, l, nh, hp)  — dt-weighted inputs
    dA: torch.Tensor,    # (b, l, nh)      — negative decay log-increments dt·A
    B: torch.Tensor,     # (b, l, g, n)
    C: torch.Tensor,     # (b, l, g, n)
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,   # (b, nh, hp, n)
    head_offset: int = 0,
    n_heads: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD: returns (y (b,l,nh,hp) f32, final_state (b,nh,hp,n) f32).

    The chunks are flattened to programs p = (batch, chunk, head) with B and C
    repeated per head, as K7 takes them.  The nh heads given may be heads
    ``head_offset`` … of a layer of ``n_heads`` (default nh): head h reads
    group h // (n_heads // g).
    """
    b, l, nh, hp = xdt.shape
    g, n = B.shape[-2], B.shape[-1]
    hpg = (n_heads or nh) // g
    group = (torch.arange(head_offset, head_offset + nh, device=B.device) // hpg)
    q = min(chunk, l)
    while l % q:
        q //= 2
    nc = l // q
    P = b * nc * nh

    cs = torch.cumsum(dA.float().reshape(b, nc, q, nh), dim=2)      # (b, nc, q, nh)
    decay = torch.exp(cs[:, :, -1])                                 # (b, nc, nh)

    def flat(t):  # (b, nc, q, nh, k) → (b·nc·nh, q, k), contiguous
        return t.permute(0, 1, 3, 2, 4).reshape(P, q, t.shape[-1])

    x_f = flat(xdt.reshape(b, nc, q, nh, hp))
    B_f = flat(B.index_select(2, group).reshape(b, nc, q, nh, n))
    C_f = flat(C.index_select(2, group).reshape(b, nc, q, nh, n))
    cs_f = flat(cs[..., None])

    # ---- reach: each chunk's state contribution (S_c does not depend on the
    # entry state, and a launch for S_c alone does not read it)
    _, S_c = ops.ssd_chunk(x_f, cs_f, B_f, C_f, None, outputs="state")
    S = S_c.reshape(b, nc, nh, n, hp).transpose(-1, -2)             # (b, nc, nh, hp, n)

    # ---- join: exclusive scan of (decay, state) across chunks
    init = (
        torch.zeros((b, nh, hp, n), dtype=torch.float32, device=xdt.device)
        if initial_state is None
        else initial_state.float()
    )
    summaries = (decay.transpose(0, 1), S.transpose(0, 1))          # chunk axis first
    entries = exclusive_entries(_combine, _act, summaries, init)    # (nc, b, nh, hp, n)
    final_state = _act((summaries[0][-1], summaries[1][-1]), entries[-1])

    # ---- build: intra-chunk quadratic form + inter-chunk term
    S_prev = entries.transpose(0, 1).reshape(P, hp, n).contiguous()
    y, _ = ops.ssd_chunk(x_f, cs_f, B_f, C_f, S_prev, outputs="y")
    y = y.reshape(b, nc, nh, q, hp).permute(0, 1, 3, 2, 4).reshape(b, l, nh, hp)
    return y, final_state


def ssd_local(xdt, dA, B, C, chunk: int, initial_state=None):
    """``ssd_chunked`` on each rank's batch rows and heads, through
    ``ops.on_local_shards`` (one rank: the same call on plain tensors).  xdt
    (b, l, nh, hp) keeps its split of dims 0 and 2, dA (b, l, nh) and the
    state (b, nh, hp, n) follow it, B and C (b, l, g, n) are whole on the
    axes that split the heads; their gradients are partial sums there (each
    rank's heads add theirs)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    x_pl = ops.local_placements(xdt, (0, 2))
    if x_pl is None:
        places = grads = s_pl = None
        offset = 0
    else:
        s_pl = [Shard(1) if p.is_shard(2) else p for p in x_pl]
        bc_pl = [p if p.is_shard(0) else Replicate() for p in x_pl]
        bc_grad = [Partial() if p.is_shard(2) else p for p in x_pl]
        state_pl = s_pl if initial_state is not None else None
        places = (x_pl, x_pl, bc_pl, bc_pl, state_pl)
        grads = (x_pl, x_pl, bc_grad, bc_grad, state_pl)
        offset = local_range(xdt.shape, xdt.device_mesh, x_pl, 2)[0]
    nh = xdt.shape[2]

    def scan(x_, a_, b_, c_, s_):
        return ssd_chunked(x_, a_, b_, c_, chunk, s_, head_offset=offset, n_heads=nh)

    return ops.on_local_shards(scan, (x_pl, s_pl), places, grads)(xdt, dA, B, C, initial_state)


def ssm_forward(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,                   # (b, l, d)
    cfg: SSMConfig,
    rms_eps: float,
    shard: Callable = lambda t, logical: t,
) -> torch.Tensor:
    """Full Mamba-2 block: in-proj → conv → SSD → gated norm → out-proj.
    ``shard`` re-places the projection by 'mlp' and the output, as the
    reference does."""
    b, l, d = x.shape
    dims = ssm_dims(d, cfg)
    di, nh = dims["d_inner"], dims["n_heads"]
    g, n, hp = cfg.n_groups, cfg.d_state, cfg.head_dim

    zxbcdt = shard(x @ params["w_in"], ("batch", "seq", "mlp"))
    z, xBC, dt = _split_zxbcdt(zxbcdt, di, g, n, nh)
    xBC = F.silu(_causal_conv(xBC, params["conv_w"], params["conv_b"]))
    xs = xBC[..., :di].reshape(b, l, nh, hp)
    B = xBC[..., di : di + g * n].reshape(b, l, g, n)
    C = xBC[..., di + g * n :].reshape(b, l, g, n)

    dt = F.softplus(dt.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())                          # (nh,) negative
    dA = dt * A                                                       # (b, l, nh) f32
    xdt = xs * dt.to(xs.dtype)[..., None]

    y, _ = ssd_local(xdt, dA, B, C, cfg.chunk)
    y = y + params["D"][None, None, :, None] * xs
    y = y.reshape(b, l, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["norm_w"], rms_eps)
    return shard(y @ params["w_out"], ("batch", "seq", None))


def ssm_decode_step(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,                   # (b, 1, d)
    cfg: SSMConfig,
    rms_eps: float,
    state: torch.Tensor,               # (b, nh, hp, n)
    conv_cache: torch.Tensor,          # (b, d_conv-1, conv_dim)
):
    """O(1) single-token step.  Returns (out, new_state, new_conv_cache)."""
    b, _, d = x.shape
    dims = ssm_dims(d, cfg)
    di, nh = dims["d_inner"], dims["n_heads"]
    g, n, hp = cfg.n_groups, cfg.d_state, cfg.head_dim

    zxbcdt = x @ params["w_in"]
    z, xBC, dt = _split_zxbcdt(zxbcdt, di, g, n, nh)
    window = torch.cat([conv_cache, xBC], dim=1)                     # (b, d_conv, cd)
    new_conv_cache = window[:, 1:]
    conv_out = torch.einsum("btc,tc->bc", window, params["conv_w"]) + params["conv_b"]
    xBC1 = F.silu(conv_out)[:, None, :]

    xs = xBC1[..., :di].reshape(b, nh, hp)
    B = xBC1[..., di : di + g * n].reshape(b, g, n)
    C = xBC1[..., di + g * n :].reshape(b, g, n)
    hpg = nh // g
    Bh = torch.repeat_interleave(B, hpg, dim=1)                      # (b, nh, n)
    Ch = torch.repeat_interleave(C, hpg, dim=1)

    dt = F.softplus(dt[:, 0].float() + params["dt_bias"])            # (b, nh)
    A = -torch.exp(params["A_log"].float())
    a = torch.exp(dt * A)                                             # (b, nh)
    xdt = xs * dt.to(xs.dtype)[..., None]                             # (b, nh, hp)

    # products and a sum over n, not einsums: an einsum flattens (b, nh) into
    # one batch dim, which DTensor (torch 2.11) cannot do where the batch is
    # split over 'data' and the heads over 'model'
    new_state = a[..., None, None] * state + (xdt[..., :, None] * Bh[..., None, :]).float()
    y = (new_state * Ch.float()[..., None, :]).sum(-1) + params["D"][None, :, None] * xs
    y = y.reshape(b, 1, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["norm_w"], rms_eps)
    return y @ params["w_out"], new_state, new_conv_cache
