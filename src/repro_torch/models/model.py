"""The decoder LM backbone: the port of ``repro.models.model``.

Structure (the reference's):
  * params are declared (shape + init) per layer kind, then *stacked* along a
    leading layer axis; the port walks the layers in a Python loop where the
    reference scans;
  * hybrid layouts (zamba2) apply one weight-shared attention+MLP block after
    every ``shared_attn_every`` core layers;
  * three entry points: ``forward_train`` (causal LM loss plus the MoE aux
    losses, microbatched by the caller: ``train/step.py``), ``prefill`` (the
    full-sequence forward, the compute-bound phase of serving) and
    ``decode_step`` (one token against the caches, no kernel).  The first
    two run attention through K6 and every SSD layer through K7 (twice); in
    training both are ``torch.autograd.Function``s whose backward recomputes
    the plain version (``kernels/ops.py``), and with ``cfg.remat`` each
    stacked layer's body runs under ``torch.utils.checkpoint`` (its forward,
    kernels included, runs again in the backward), as the reference wraps it
    in ``jax.checkpoint``;
  * attention decode caches are ring-buffered at ``min(seq, window)`` slots
    for sliding-window configs;
  * every layer kind runs: ``attn``, ``ssm``, ``moe`` (``models/moe.py``) and
    the zamba2 shared block, with the attention logit softcap where a config
    sets one; modality frontends (internvl2 vision, musicgen audio) are the
    reference's stubs: precomputed patch / frame features ``extra`` are
    projected by ``frontend_proj`` and prepended to the token sequence.

Params are a nested dict of tensors with the reference's names and stacked
layer axes; ``params_from_jax`` carries the reference's tree over.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..core.engine import resolve_device
from ..kernels import ops
from .config import ModelConfig
from .layers import (
    HeadPlan,
    ParamDecl,
    apply_rope,
    decode_attention,
    rms_norm,
    swiglu,
    torch_dtype,
    tree_init,
)
from .mamba import declare_ssm, ssm_decode_step, ssm_dims, ssm_forward
from .moe import declare_moe, moe_ffn

Params = Dict[str, Any]
AUX_KEYS = ("moe_lb_loss", "moe_z_loss")


# ===================================================================== decls


def _attn_decls(cfg: ModelConfig, plan: HeadPlan) -> Dict[str, ParamDecl]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "norm1": ParamDecl((d,), init="ones"),
        "wq": ParamDecl((d, plan.pad_q, hd), init="scaled"),
        "wk": ParamDecl((d, plan.pad_kv, hd), init="scaled"),
        "wv": ParamDecl((d, plan.pad_kv, hd), init="scaled"),
        "wo": ParamDecl((plan.pad_q, hd, d), init="scaled"),
    }


def _mlp_decls(cfg: ModelConfig) -> Dict[str, ParamDecl]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "norm2": ParamDecl((d,), init="ones"),
        "w_gate": ParamDecl((d, f), init="scaled"),
        "w_up": ParamDecl((d, f), init="scaled"),
        "w_down": ParamDecl((f, d), init="scaled"),
    }


def _layer_decls(cfg: ModelConfig, kind: str, plan: HeadPlan) -> Dict[str, Any]:
    if kind == "attn":
        return {**_attn_decls(cfg, plan), **_mlp_decls(cfg)}
    if kind == "moe":
        return {
            **_attn_decls(cfg, plan),
            "norm2": ParamDecl((cfg.d_model,), init="ones"),
            "moe": declare_moe(cfg.d_model, cfg.moe),
        }
    if kind == "ssm":
        return {
            "norm1": ParamDecl((cfg.d_model,), init="ones"),
            "ssm": declare_ssm(cfg.d_model, cfg.ssm),
        }
    raise ValueError(kind)


def _stack_decls(decls: Any, n: int) -> Any:
    """Prepend a layer axis of size n to every decl."""
    if isinstance(decls, ParamDecl):
        return ParamDecl((n,) + decls.shape, decls.init, decls.scale)
    return {k: _stack_decls(v, n) for k, v in decls.items()}


def head_plan(cfg: ModelConfig) -> HeadPlan:
    """The reference's plan at tensor-parallel degree 1 (the port runs on one
    card): no padding."""
    return HeadPlan.plan(cfg.n_heads, cfg.n_kv_heads, 1)


def shared_attn_plan(cfg: ModelConfig) -> HeadPlan:
    h = cfg.shared_attn_heads or cfg.n_heads
    return HeadPlan.plan(h, h, 1)  # shared block is MHA (zamba2)


def declare_params(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    plan = head_plan(cfg)
    kinds = cfg.layer_kinds
    decls: Dict[str, Any] = {
        "embed": ParamDecl((cfg.vocab_size, d), init="normal"),
        "final_norm": ParamDecl((d,), init="ones"),
    }
    if not cfg.tie_embeddings:
        decls["lm_head"] = ParamDecl((d, cfg.vocab_size), init="scaled")
    if cfg.frontend is not None:
        decls["frontend_proj"] = ParamDecl((cfg.frontend.feature_dim, d), init="scaled")
    decls["stacks"] = {
        kind: _stack_decls(_layer_decls(cfg, kind, plan), sum(1 for k in kinds if k == kind))
        for kind in sorted(set(kinds))
    }
    if cfg.shared_attn_every:
        decls["shared_attn"] = {
            **_attn_decls(cfg, shared_attn_plan(cfg)),
            **_mlp_decls(cfg),
        }
    return decls


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Params:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``, made
    on ``device`` (None: the card; raises without one).  The reference's
    initializers, not its numbers: a JAX key draws other values."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return tree_init(declare_params(cfg), gen, torch_dtype(cfg.param_dtype), dev)


def params_from_jax(tree: Any, cfg: ModelConfig, device=None) -> Params:
    """The reference's parameter tree (nested dicts of numpy arrays, any float
    dtype) as the port's, in ``cfg.param_dtype`` on ``device`` (None: the
    card).  Both packages then compute the same function."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.param_dtype)

    def convert(x):
        if isinstance(x, dict):
            return {k: convert(v) for k, v in x.items()}
        return torch.tensor(np.asarray(x, dtype=np.float32), device=dev).to(dtype)

    return convert(tree)


def compute_params(params: Params, cfg: ModelConfig) -> Params:
    """The params as the model computes with them: where ``cfg.dtype`` is
    wider than ``cfg.param_dtype`` (f32 compute over bf16 params), every
    leaf cast to the wider type, which is what the reference's matmuls do by
    JAX's type promotion (PyTorch's matmuls do not promote).  The cast is
    exact and differentiable: the gradients come back to the params in their
    own type.  Otherwise the params themselves."""
    pd, cd = torch_dtype(cfg.param_dtype), torch_dtype(cfg.dtype)
    wide = torch.promote_types(pd, cd)
    if wide == pd:
        return params

    def cast(tree):
        return {k: cast(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.to(wide)

    return cast(params)


def _unstack(tree: Any) -> list:
    """The layers of a stacked parameter tree, one tree each, through one
    ``unbind`` a leaf.  Its backward stacks the layers' gradients once;
    indexing layer by layer would give each layer's gradient as a zero
    tensor the size of the whole stack plus its slice (2.9 GB for zamba2's
    stacked in_proj), summed over the layers."""
    if isinstance(tree, dict):
        per_key = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(per_key.values())))
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(tree.unbind(0))


# ================================================================ layer fwd


def _attention(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    plan: HeadPlan,
    positions: torch.Tensor,
    window: Optional[int],
) -> torch.Tensor:
    """Project q/k/v, apply RoPE, repeat K/V to the query heads, and attend
    through K6 (with ``cfg.attn_logit_softcap``).  K6 casts p to v's dtype,
    which is the reference's ``attn_p_dtype`` whenever that equals
    ``cfg.dtype``."""
    q = torch.einsum("bld,dhk->blhk", x, p["wq"])
    k = torch.einsum("bld,dhk->blhk", x, p["wk"])
    v = torch.einsum("bld,dhk->blhk", x, p["wv"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    kr = torch.repeat_interleave(k, plan.groups, dim=2)[:, :, : plan.pad_q]
    vr = torch.repeat_interleave(v, plan.groups, dim=2)[:, :, : plan.pad_q]
    o = ops.flash_attention(
        q.contiguous(), kr.contiguous(), vr.contiguous(), causal=True, window=window,
        softcap=cfg.attn_logit_softcap,
    )
    return torch.einsum("blhk,hkd->bld", o.to(x.dtype), p["wo"])


def _attn_block(p, x, cfg, plan, positions, window):
    h = x + _attention(p, rms_norm(x, p["norm1"], cfg.rms_eps), cfg, plan, positions, window)
    if "w_gate" in p:
        h = h + swiglu(rms_norm(h, p["norm2"], cfg.rms_eps), p["w_gate"], p["w_up"], p["w_down"])
    return h


def _moe_block(p, x, cfg, plan, positions, window):
    h = x + _attention(p, rms_norm(x, p["norm1"], cfg.rms_eps), cfg, plan, positions, window)
    b, l, d = h.shape
    flat = rms_norm(h, p["norm2"], cfg.rms_eps).reshape(b * l, d)
    y, aux = moe_ffn(p["moe"], flat, cfg.moe)
    return h + y.reshape(b, l, d), aux


def _ssm_block(p, x, cfg):
    return x + ssm_forward(p["ssm"], rms_norm(x, p["norm1"], cfg.rms_eps), cfg.ssm, cfg.rms_eps)


# ============================================================== full forward


def _layer_runs(cfg: ModelConfig):
    """Consecutive same-kind runs: [(kind, start_idx_in_stack, count), ...]."""
    kinds = cfg.layer_kinds
    runs = []
    seen: Dict[str, int] = {}
    i = 0
    while i < len(kinds):
        j = i
        while j < len(kinds) and kinds[j] == kinds[i]:
            j += 1
        k = kinds[i]
        runs.append((k, seen.get(k, 0), j - i))
        seen[k] = seen.get(k, 0) + (j - i)
        i = j
    return runs


def _zero_aux(device) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros((), dtype=torch.float32, device=device) for k in AUX_KEYS}


def backbone(
    params: Params,
    x: torch.Tensor,                 # (b, L, d) embedded inputs
    cfg: ModelConfig,
    positions: torch.Tensor,         # (b, L)
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Every layer in order, the shared block after every
    ``shared_attn_every`` core layers (zamba2); returns the hidden states and
    the MoE aux losses summed over the layers.

    With ``cfg.remat`` and autograd recording, each stacked layer's body runs
    under ``torch.utils.checkpoint`` (non-reentrant): only its input is kept
    and its forward runs again in the backward, as the reference's
    ``jax.checkpoint`` of the scanned body (the shared block is not wrapped
    there either)."""
    plan = head_plan(cfg)
    splan = shared_attn_plan(cfg)
    every = cfg.shared_attn_every
    bodies: Dict[str, Callable] = {
        "attn": lambda p, h: _attn_block(p, h, cfg, plan, positions, cfg.sliding_window),
        "moe": lambda p, h: _moe_block(p, h, cfg, plan, positions, cfg.sliding_window),
        "ssm": lambda p, h: _ssm_block(p, h, cfg),
    }
    remat = cfg.remat and torch.is_grad_enabled()
    aux = _zero_aux(x.device)
    layers = {kind: _unstack(stack) for kind, stack in params["stacks"].items()}
    layers_done = 0
    for kind, start, count in _layer_runs(cfg):
        body = bodies[kind]
        for i in range(start, start + count):
            p = layers[kind][i]
            out = checkpoint(body, p, x, use_reentrant=False) if remat else body(p, x)
            if isinstance(out, tuple):
                x, layer_aux = out
                aux = {k: aux[k] + layer_aux[k] for k in AUX_KEYS}
            else:
                x = out
            layers_done += 1
            if every and layers_done % every == 0:
                x = _attn_block(params["shared_attn"], x, cfg, splan, positions, None)
    return x, aux


def embed_inputs(
    params: Params,
    tokens: torch.Tensor,                      # (b, L)
    cfg: ModelConfig,
    extra: Optional[torch.Tensor] = None,      # (b, n_extra, feat) frontend stub
):
    """Returns (x (b, L_total, d), positions (b, L_total)): the token
    embeddings, after the projected frontend features when the config has a
    frontend and ``extra`` is given."""
    dt = torch_dtype(cfg.dtype)
    emb = params["embed"][tokens].to(dt)
    if cfg.frontend is not None and extra is not None:
        fe = (extra.to(dt) @ params["frontend_proj"]).to(dt)
        emb = torch.cat([fe, emb], dim=1)
    b, L = emb.shape[:2]
    positions = torch.arange(L, dtype=torch.int32, device=emb.device).expand(b, L)
    return emb, positions


def logits_from(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.einsum("bld,dv->blv", x, head)


def lm_loss(
    logits: torch.Tensor,            # (b, L, V)
    labels: torch.Tensor,            # (b, L) next-token targets; -1 = ignore
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean next-token cross-entropy over the labels ≥ 0 (f32), and their
    count."""
    lf = logits.float()
    m = lf.max(dim=-1, keepdim=True).values.detach()
    lse = torch.log(torch.exp(lf - m).sum(dim=-1)) + m[..., 0]
    safe_labels = labels.clamp(min=0).long()
    gold = torch.gather(lf, -1, safe_labels[..., None])[..., 0]
    nll = lse - gold
    mask = (labels >= 0).float()
    n = mask.sum()
    return (nll * mask).sum() / n.clamp(min=1.0), n


def forward_train(
    params: Params,
    batch: Dict[str, torch.Tensor],
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total loss, metrics) of one microbatch: ``batch["tokens"]`` (b, L)
    and, for a frontend config, ``batch["extra"]`` (b, n_extra, feat).  The
    loss is over the text positions only (the frontend's are cut off), each
    predicting the next token, the last one ignored; the total adds the MoE
    aux losses summed over the layers."""
    tokens = batch["tokens"]
    extra = batch.get("extra")
    params = compute_params(params, cfg)
    x, positions = embed_inputs(params, tokens, cfg, extra)
    x, aux = backbone(params, x, cfg, positions)
    n_extra = 0 if extra is None else extra.shape[1]
    logits = logits_from(params, x[:, n_extra:], cfg)
    labels = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -1)], dim=1)
    loss, n_tok = lm_loss(logits, labels)
    total = loss + aux["moe_lb_loss"] + aux["moe_z_loss"]
    return total, {"loss": loss, "n_tokens": n_tok, **aux}


def prefill(
    params: Params, tokens: torch.Tensor, cfg: ModelConfig,
    extra: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Full-sequence forward producing last-position logits (b, 1, V): the
    compute-bound phase of serving.  Attention runs through K6 and every SSD
    layer through K7 (twice).  As in the reference, it populates no decode
    cache: the serving loop primes its caches step by step.  ``extra``: the
    frontend's features, prepended (``pos`` counts them)."""
    params = compute_params(params, cfg)
    x, positions = embed_inputs(params, tokens, cfg, extra)
    x, _ = backbone(params, x, cfg, positions)
    return logits_from(params, x[:, -1:], cfg), {"pos": x.shape[1]}


# ==================================================================== decode


def make_cache(cfg: ModelConfig, batch: int, seq_len: int, device=None) -> Dict[str, Any]:
    """Zero-initialized decode caches on ``device`` (None: the card).  ``pos``
    is a host int; the rest are tensors."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    plan = head_plan(cfg)
    hd = cfg.resolved_head_dim
    cache_len = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    kinds = cfg.layer_kinds
    caches: Dict[str, Any] = {"pos": 0}
    n_attn = sum(1 for k in kinds if k in ("attn", "moe"))
    if n_attn or cfg.shared_attn_every:
        caches["row_start"] = torch.zeros((batch,), dtype=torch.int32, device=dev)
    if n_attn:
        caches["attn"] = {
            "k": torch.zeros((n_attn, batch, cache_len, plan.pad_kv, hd), dtype=dt, device=dev),
            "v": torch.zeros((n_attn, batch, cache_len, plan.pad_kv, hd), dtype=dt, device=dev),
            "slot_pos": torch.full((cache_len,), -1, dtype=torch.int32, device=dev),
        }
    n_ssm = sum(1 for k in kinds if k == "ssm")
    if n_ssm:
        dims = ssm_dims(cfg.d_model, cfg.ssm)
        caches["ssm"] = {
            "state": torch.zeros(
                (n_ssm, batch, dims["n_heads"], cfg.ssm.head_dim, cfg.ssm.d_state),
                dtype=torch.float32, device=dev,
            ),
            "conv": torch.zeros(
                (n_ssm, batch, cfg.ssm.d_conv - 1, dims["conv_dim"]), dtype=dt, device=dev
            ),
        }
    if cfg.shared_attn_every:
        splan = shared_attn_plan(cfg)
        n_shared = len(kinds) // cfg.shared_attn_every
        shape = (n_shared, batch, cache_len, splan.pad_kv, hd)
        caches["shared_attn"] = {
            "k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev),
        }
    return caches


def _decode_attn_block(p, x, cfg, plan, cache_k, cache_v, slot_pos, pos, window,
                       row_start=None):
    """One attention (+ MLP or MoE) decode step; writes the new K/V into its
    slot of ``cache_k`` / ``cache_v`` in place."""
    b = x.shape[0]
    xn = rms_norm(x, p["norm1"], cfg.rms_eps)
    q = torch.einsum("bld,dhk->blhk", xn, p["wq"])
    k = torch.einsum("bld,dhk->blhk", xn, p["wk"])
    v = torch.einsum("bld,dhk->blhk", xn, p["wv"])
    posb = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posb, cfg.rope_theta)
    k = apply_rope(k, posb, cfg.rope_theta)
    slot = pos % cache_k.shape[1]
    cache_k[:, slot] = k[:, 0]
    cache_v[:, slot] = v[:, 0]
    o = decode_attention(
        q, cache_k, cache_v, slot_pos, pos,
        groups=plan.groups, grouped=plan.grouped,
        window=window, softcap=cfg.attn_logit_softcap, row_start=row_start,
    )
    h = x + torch.einsum("blhk,hkd->bld", o.to(x.dtype), p["wo"])
    if "w_gate" in p:
        h = h + swiglu(rms_norm(h, p["norm2"], cfg.rms_eps), p["w_gate"], p["w_up"], p["w_down"])
    elif "moe" in p:
        b2, l2, d2 = h.shape
        flat = rms_norm(h, p["norm2"], cfg.rms_eps).reshape(b2 * l2, d2)
        y, _ = moe_ffn(p["moe"], flat, cfg.moe)
        h = h + y.reshape(b2, l2, d2)
    return h


def decode_step(
    params: Params,
    caches: Dict[str, Any],
    token: torch.Tensor,            # (b, 1) int
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One serving step: next-token logits (b, 1, V) and the caches.

    Unlike the reference, which returns new cache arrays, the port updates
    the cache tensors in place (one slot of K/V, the SSM state and conv rows)
    and returns the same dict with ``pos`` advanced.  ``attn`` and ``moe``
    layers share the attention caches, in layer order."""
    pos = int(caches["pos"])
    params = compute_params(params, cfg)
    plan = head_plan(cfg)
    splan = shared_attn_plan(cfg)
    x = params["embed"][token].to(torch_dtype(cfg.dtype))
    if "attn" in caches:
        slot_pos = caches["attn"]["slot_pos"]
        slot_pos[pos % slot_pos.shape[0]] = pos
    elif "shared_attn" in caches:
        cache_len = caches["shared_attn"]["k"].shape[2]
        slot_pos = torch.arange(cache_len, dtype=torch.int32, device=x.device)
    row_start = caches.get("row_start")
    every = cfg.shared_attn_every
    layers_done = 0
    used = {"attn": 0, "ssm": 0, "shared": 0}
    layers = {kind: _unstack(stack) for kind, stack in params["stacks"].items()}
    for kind, start, count in _layer_runs(cfg):
        for i in range(start, start + count):
            p = layers[kind][i]
            cache = "ssm" if kind == "ssm" else "attn"
            j = used[cache]
            if cache == "attn":
                x = _decode_attn_block(
                    p, x, cfg, plan, caches["attn"]["k"][j], caches["attn"]["v"][j],
                    slot_pos, pos, cfg.sliding_window, row_start,
                )
            else:
                y, state, conv = ssm_decode_step(
                    p["ssm"], rms_norm(x, p["norm1"], cfg.rms_eps), cfg.ssm, cfg.rms_eps,
                    caches["ssm"]["state"][j], caches["ssm"]["conv"][j],
                )
                x = x + y
                caches["ssm"]["state"][j] = state
                caches["ssm"]["conv"][j] = conv
            used[cache] += 1
            layers_done += 1
            if every and layers_done % every == 0:
                s = used["shared"]
                x = _decode_attn_block(
                    params["shared_attn"], x, cfg, splan, caches["shared_attn"]["k"][s],
                    caches["shared_attn"]["v"][s], slot_pos, pos, None, row_start,
                )
                used["shared"] += 1
    caches["pos"] = pos + 1
    return logits_from(params, x, cfg), caches
