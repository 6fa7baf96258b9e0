"""Mixture-of-Experts layer: the port of ``repro.models.moe``.

Top-k routing with sort-based capacity dispatch (the reference's static-shape
Megatron-style token permutation):
  1. router logits → top-k experts + gates per token;
  2. flatten the (tokens·k) assignments and stable-sort them by expert id;
  3. position within the expert by cumulative one-hot counts; assignments at
     positions ≥ the capacity ``C = max(1, int(tokens·k/E · capacity_factor))``
     are dropped (their gate contributes nothing — GShard's rule);
  4. scatter into an (E, C, d) buffer, run every expert as one batched einsum,
     gather back, unsort, gate-weight and sum over k.

Two places where JAX's indexing rules do the dropping and PyTorch's do not:
the reference's scatter ``buf.at[...].set(..., mode="drop")`` skips slots
``pos ≥ C``, and ``index_put`` would raise on them, so dropped assignments are
written to one spare slot C that is cut off; its gather ``out[expert, pos]``
relies on JAX clamping out-of-range reads before the ``where`` that zeroes
them, so ``pos`` is clamped here first.  Both are exact: the values that
differ are multiplied by zero.

Aux losses: the switch-style load-balance loss and the router z-loss,
returned to the trainer for the total objective.

On a mesh (DTensors) the routing, the dispatch scatter and the combine
gather run whole on every rank (``_whole``: their inputs gathered, the
same values everywhere), as the reference's one group per microbatch ranks
and drops the microbatch's tokens together; the expert einsums are DTensor
ops between the ``constrain`` sites, split by 'experts' (or 'expert_mlp')
over 'model' and the capacity slots by 'batch'.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..kernels.ops import on_local_shards
from .config import MoEConfig
from .layers import ParamDecl


def _whole(fn, n_out: int, *args):
    """``fn`` of whole tensors on every rank: DTensor arguments replicated
    (gathered), the ``n_out`` outputs replicated DTensors; on plain tensors
    ``fn`` itself."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = next((a.device_mesh for a in args if isinstance(a, DTensor)), None)
    rep = None if mesh is None else [Replicate()] * mesh.ndim
    ins = tuple(rep if isinstance(a, torch.Tensor) else None for a in args)
    return on_local_shards(fn, rep if n_out == 1 else (rep,) * n_out, ins, mesh=mesh)(*args)


def _route(x, router, E: int, k: int, C: int):
    logits = x.float() @ router.float()                               # (T, E) f32
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)                         # (T, k), descending
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    # ---- flatten + stable sort by expert --------------------------------
    flat_expert = idx.reshape(-1)                                     # (T·k,)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    oh = F.one_hot(sorted_expert, E)
    pos = (torch.cumsum(oh, dim=0) * oh).sum(-1) - 1                  # within-expert slot
    # ---- aux losses: load balance E · Σ_e (fraction to e) · (mean prob of e), z-loss
    frac = F.one_hot(idx, E).float().mean(dim=(0, 1)) * k
    lb = E * torch.sum(frac * probs.mean(dim=0))
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return gates, order, sorted_expert, pos, lb, z


def _dispatch(x, order, sorted_expert, pos, E: int, k: int, C: int):
    """The (E, C, d) buffer; dropped assignments land in the spare slot C."""
    slot = torch.where(pos < C, pos, C)
    token_of = order // k                                             # source token
    buf = x.new_zeros((E, C + 1, x.shape[1])).index_put((sorted_expert, slot), x[token_of])
    return buf[:, :C]


def _combine(out, gates, order, sorted_expert, pos, k: int, C: int):
    y_sorted = out[sorted_expert, pos.clamp(max=C - 1)]               # (T·k, d)
    y_sorted = torch.where((pos < C)[:, None], y_sorted,
                           torch.zeros((), dtype=y_sorted.dtype, device=out.device))
    inv = torch.argsort(order, stable=True)
    y = y_sorted[inv].reshape(-1, k, out.shape[-1])
    return (y * gates[..., None].to(y.dtype)).sum(dim=1)


def declare_moe(d_model: int, cfg: MoEConfig) -> Dict[str, ParamDecl]:
    E, f = cfg.n_experts, cfg.d_ff_expert
    decls = {
        "router": ParamDecl((d_model, E), ("embed", None), init="scaled"),
        "w_gate": ParamDecl((E, d_model, f), ("experts", "fsdp", "expert_mlp"), init="scaled"),
        "w_up": ParamDecl((E, d_model, f), ("experts", "fsdp", "expert_mlp"), init="scaled"),
        "w_down": ParamDecl((E, f, d_model), ("experts", "expert_mlp", "fsdp"), init="scaled"),
    }
    if cfg.shared_expert:
        decls.update(
            {
                "shared_gate": ParamDecl((d_model, f), ("fsdp", "mlp"), init="scaled"),
                "shared_up": ParamDecl((d_model, f), ("fsdp", "mlp"), init="scaled"),
                "shared_down": ParamDecl((f, d_model), ("mlp", "fsdp"), init="scaled"),
            }
        )
    return decls


def capacity(n_tokens: int, cfg: MoEConfig) -> int:
    """Slots per expert for ``n_tokens`` tokens (the reference's formula)."""
    return max(1, int((n_tokens * cfg.top_k) / cfg.n_experts * cfg.capacity_factor))


def moe_ffn(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,                  # (tokens, d)
    cfg: MoEConfig,
    constrain=lambda t, logical: t,   # sharding-constraint hook (tensor, logical axes)
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = capacity(T, cfg)

    gates, order, sorted_expert, pos, lb, z = _whole(
        lambda x_, r_: _route(x_, r_, E, k, C), 6, x, params["router"])

    # ---- dispatch ----------------------------------------------------------
    buf = _whole(lambda *a: _dispatch(*a, E, k, C), 1, x, order, sorted_expert, pos)
    buf = constrain(buf, ("experts", "batch", "embed"))

    # ---- expert compute (batched over E) ---------------------------------
    g = torch.einsum("ecd,edf->ecf", buf, params["w_gate"])
    u = torch.einsum("ecd,edf->ecf", buf, params["w_up"])
    h = constrain(F.silu(g) * u, ("experts", "batch", "expert_mlp"))
    out = constrain(torch.einsum("ecf,efd->ecd", h, params["w_down"]), ("experts", "batch", "embed"))

    # ---- combine ----------------------------------------------------------
    y = _whole(lambda *a: _combine(*a, k, C), 1, out, gates, order, sorted_expert, pos)

    if cfg.shared_expert:
        sg = F.silu(x @ params["shared_gate"]) * (x @ params["shared_up"])
        y = y + sg @ params["shared_down"]
    aux = {"moe_lb_loss": lb * cfg.load_balance_loss, "moe_z_loss": z * cfg.router_z_loss}
    return y.to(x.dtype), aux
