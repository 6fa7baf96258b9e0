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
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .config import MoEConfig
from .layers import ParamDecl


def declare_moe(d_model: int, cfg: MoEConfig) -> Dict[str, ParamDecl]:
    E, f = cfg.n_experts, cfg.d_ff_expert
    decls = {
        "router": ParamDecl((d_model, E), init="scaled"),
        "w_gate": ParamDecl((E, d_model, f), init="scaled"),
        "w_up": ParamDecl((E, d_model, f), init="scaled"),
        "w_down": ParamDecl((E, f, d_model), init="scaled"),
    }
    if cfg.shared_expert:
        decls.update(
            {
                "shared_gate": ParamDecl((d_model, f), init="scaled"),
                "shared_up": ParamDecl((d_model, f), init="scaled"),
                "shared_down": ParamDecl((f, d_model), init="scaled"),
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

    logits = x.float() @ params["router"].float()                     # (T, E) f32
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)                         # (T, k), descending
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    # ---- flatten + stable sort by expert --------------------------------
    flat_expert = idx.reshape(-1)                                     # (T·k,)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    token_of = order // k                                             # source token
    oh = F.one_hot(sorted_expert, E)
    pos = (torch.cumsum(oh, dim=0) * oh).sum(-1) - 1                  # within-expert slot
    kept = pos < C

    # ---- dispatch: dropped assignments land in the spare slot C ----------
    slot = torch.where(kept, pos, C)
    buf = x.new_zeros((E, C + 1, d)).index_put((sorted_expert, slot), x[token_of])[:, :C]
    buf = constrain(buf, ("experts", "batch", "embed"))

    # ---- expert compute (batched over E) ---------------------------------
    g = torch.einsum("ecd,edf->ecf", buf, params["w_gate"])
    u = torch.einsum("ecd,edf->ecf", buf, params["w_up"])
    h = constrain(F.silu(g) * u, ("experts", "batch", "expert_mlp"))
    out = constrain(torch.einsum("ecf,efd->ecd", h, params["w_down"]), ("experts", "batch", "embed"))

    # ---- combine ----------------------------------------------------------
    y_sorted = out[sorted_expert, pos.clamp(max=C - 1)]               # (T·k, d)
    y_sorted = torch.where(kept[:, None], y_sorted, torch.zeros((), dtype=y_sorted.dtype,
                                                                 device=x.device))
    inv = torch.argsort(order, stable=True)
    y = y_sorted[inv].reshape(T, k, d)
    y = (y * gates[..., None].to(y.dtype)).sum(dim=1)

    if cfg.shared_expert:
        sg = F.silu(x @ params["shared_gate"]) * (x @ params["shared_up"])
        y = y + sg @ params["shared_down"]

    # ---- aux losses --------------------------------------------------------
    # load balance: E · Σ_e (fraction of tokens to e) · (mean prob of e)
    frac = F.one_hot(idx, E).float().mean(dim=(0, 1)) * k
    mean_prob = probs.mean(dim=0)
    lb = E * torch.sum(frac * mean_prob) * cfg.load_balance_loss
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2) * cfg.router_z_loss
    return y.to(x.dtype), {"moe_lb_loss": lb, "moe_z_loss": z}
