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
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.engine import resolve_device
from ..kernels import ops
from ..parallel.sharding import assign, local_range, whole_dim, write_slot
from .config import ModelConfig
from .layers import (
    HeadPlan,
    ParamDecl,
    apply_rope,
    decode_attention,
    repeat_kv,
    rms_norm,
    swiglu,
    torch_dtype,
    tree_abstract,
    tree_init,
    tree_logical,
)
from .mamba import declare_ssm, ssm_decode_step, ssm_dims, ssm_forward
from .moe import declare_moe, moe_ffn

Params = Dict[str, Any]
AUX_KEYS = ("moe_lb_loss", "moe_z_loss")


# ===================================================================== decls


def _attn_decls(cfg: ModelConfig, plan: HeadPlan) -> Dict[str, ParamDecl]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "norm1": ParamDecl((d,), (None,), init="ones"),
        "wq": ParamDecl((d, plan.pad_q, hd), ("fsdp", "heads", None), init="scaled"),
        "wk": ParamDecl((d, plan.pad_kv, hd), ("fsdp", "kv_heads", None), init="scaled"),
        "wv": ParamDecl((d, plan.pad_kv, hd), ("fsdp", "kv_heads", None), init="scaled"),
        "wo": ParamDecl((plan.pad_q, hd, d), ("heads", None, "fsdp"), init="scaled"),
    }


def _mlp_decls(cfg: ModelConfig) -> Dict[str, ParamDecl]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "norm2": ParamDecl((d,), (None,), init="ones"),
        "w_gate": ParamDecl((d, f), ("fsdp", "mlp"), init="scaled"),
        "w_up": ParamDecl((d, f), ("fsdp", "mlp"), init="scaled"),
        "w_down": ParamDecl((f, d), ("mlp", "fsdp"), init="scaled"),
    }


def _layer_decls(cfg: ModelConfig, kind: str, plan: HeadPlan) -> Dict[str, Any]:
    if kind == "attn":
        return {**_attn_decls(cfg, plan), **_mlp_decls(cfg)}
    if kind == "moe":
        return {
            **_attn_decls(cfg, plan),
            "norm2": ParamDecl((cfg.d_model,), (None,), init="ones"),
            "moe": declare_moe(cfg.d_model, cfg.moe),
        }
    if kind == "ssm":
        return {
            "norm1": ParamDecl((cfg.d_model,), (None,), init="ones"),
            "ssm": declare_ssm(cfg.d_model, cfg.ssm),
        }
    raise ValueError(kind)


def _stack_decls(decls: Any, n: int) -> Any:
    """Prepend a layer axis of size n (logical axis "stack") to every decl."""
    if isinstance(decls, ParamDecl):
        return ParamDecl((n,) + decls.shape, ("stack",) + decls.logical, decls.init, decls.scale)
    return {k: _stack_decls(v, n) for k, v in decls.items()}


def head_plan(cfg: ModelConfig, tp: int = 1) -> HeadPlan:
    """The reference's plan at tensor-parallel degree ``tp``: query heads
    zero-padded to a multiple of ``tp`` where they do not divide it."""
    return HeadPlan.plan(cfg.n_heads, cfg.n_kv_heads, tp)


def shared_attn_plan(cfg: ModelConfig, tp: int = 1) -> HeadPlan:
    h = cfg.shared_attn_heads or cfg.n_heads
    return HeadPlan.plan(h, h, tp)  # shared block is MHA (zamba2)


def declare_params(cfg: ModelConfig, tp: int = 1) -> Dict[str, Any]:
    d = cfg.d_model
    plan = head_plan(cfg, tp)
    kinds = cfg.layer_kinds
    decls: Dict[str, Any] = {
        "embed": ParamDecl((cfg.vocab_size, d), ("vocab", None), init="normal"),
        "final_norm": ParamDecl((d,), (None,), init="ones"),
    }
    if not cfg.tie_embeddings:
        decls["lm_head"] = ParamDecl((d, cfg.vocab_size), (None, "vocab"), init="scaled")
    if cfg.frontend is not None:
        decls["frontend_proj"] = ParamDecl(
            (cfg.frontend.feature_dim, d), (None, None), init="scaled"
        )
    decls["stacks"] = {
        kind: _stack_decls(_layer_decls(cfg, kind, plan), sum(1 for k in kinds if k == kind))
        for kind in sorted(set(kinds))
    }
    if cfg.shared_attn_every:
        decls["shared_attn"] = {
            **_attn_decls(cfg, shared_attn_plan(cfg, tp)),
            **_mlp_decls(cfg),
        }
    return decls


def init_params(cfg: ModelConfig, seed: int = 0, device=None, tp: int = 1) -> Params:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``, made
    on ``device`` (None: the card; raises without one), whole, with the
    heads padded for tensor-parallel degree ``tp``.  The reference's
    initializers, not its numbers: a JAX key draws other values.  On a mesh
    every rank makes the same tree, and ``train/step.shard_params`` cuts it
    to the rank's shards."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return tree_init(declare_params(cfg, tp), gen, torch_dtype(cfg.param_dtype), dev)


def abstract_params(cfg: ModelConfig, tp: int = 1) -> Params:
    """The params' shapes and dtype on the meta device (no storage)."""
    return tree_abstract(declare_params(cfg, tp), torch_dtype(cfg.param_dtype))


def param_logical_axes(cfg: ModelConfig, tp: int = 1) -> Params:
    """Every param's logical axes (the reference's tuples), in the params'
    tree."""
    return tree_logical(declare_params(cfg, tp))


def params_from_jax(tree: Any, cfg: ModelConfig, device=None, tp: int = 1) -> Params:
    """The reference's parameter tree (nested dicts of numpy arrays, any float
    dtype), made at tensor-parallel degree ``tp`` (its padded heads
    included), as the port's, in ``cfg.param_dtype`` on ``device`` (None: the
    card).  Both packages then compute the same function.  Raises if a
    leaf's shape is not the one ``declare_params(cfg, tp)`` gives."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.param_dtype)

    def convert(x, want, path):
        if isinstance(x, dict):
            return {k: convert(v, want[k], f"{path}/{k}") for k, v in x.items()}
        if tuple(np.shape(x)) != tuple(want.shape):
            raise ValueError(f"{path}: shape {np.shape(x)}, expected {tuple(want.shape)} at tp {tp}")
        return torch.tensor(np.asarray(x, dtype=np.float32), device=dev).to(dtype)

    return convert(tree, abstract_params(cfg, tp), "")


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


def no_shard(t, logical):
    """The ``shard`` hook of one rank: every tensor stays as it is."""
    return t


def _attention(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    plan: HeadPlan,
    positions: torch.Tensor,
    window: Optional[int],
    shard: Callable,
) -> torch.Tensor:
    """Project q/k/v, apply RoPE, repeat K/V to the query heads, and attend
    through K6 (with ``cfg.attn_logit_softcap``) on each rank's batch rows
    and heads (``ops.flash_attention_local``).  K6 casts p to v's dtype,
    which is the reference's ``attn_p_dtype`` whenever that equals
    ``cfg.dtype``.  The ``shard`` calls are the reference's: the weights
    gathered at use to their tensor-parallel layout (FSDP's all-gather),
    q / k / v and the repeated K/V by heads."""
    wq = shard(p["wq"], (None, "heads", None))
    wk = shard(p["wk"], (None, "kv_heads", None))
    wv = shard(p["wv"], (None, "kv_heads", None))
    wo = shard(p["wo"], ("heads", None, None))
    q = shard(torch.einsum("bld,dhk->blhk", x, wq), ("batch", "seq", "heads", None))
    k = shard(torch.einsum("bld,dhk->blhk", x, wk), ("batch", "seq", "kv_heads", None))
    v = shard(torch.einsum("bld,dhk->blhk", x, wv), ("batch", "seq", "kv_heads", None))
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    kr = shard(repeat_kv(k, plan.groups)[:, :, : plan.pad_q], ("batch", "seq", "heads", None))
    vr = shard(repeat_kv(v, plan.groups)[:, :, : plan.pad_q], ("batch", "seq", "heads", None))
    o = ops.flash_attention_local(q, kr, vr, causal=True, window=window,
                                  softcap=cfg.attn_logit_softcap)
    o = shard(o, ("batch", "seq", "heads", None))
    return torch.einsum("blhk,hkd->bld", o.to(x.dtype), wo)


def _attn_block(p, x, cfg, plan, positions, window, shard):
    h = x + _attention(
        p, rms_norm(x, p["norm1"], cfg.rms_eps), cfg, plan, positions, window, shard
    )
    if "w_gate" in p:  # dense MLP, its weights gathered at use
        h = h + swiglu(
            rms_norm(h, p["norm2"], cfg.rms_eps),
            shard(p["w_gate"], (None, "mlp")),
            shard(p["w_up"], (None, "mlp")),
            shard(p["w_down"], ("mlp", None)),
        )
    return h


def _moe_block(p, x, cfg, plan, positions, window, shard):
    h = x + _attention(
        p, rms_norm(x, p["norm1"], cfg.rms_eps), cfg, plan, positions, window, shard
    )
    b, l, d = h.shape
    flat = rms_norm(h, p["norm2"], cfg.rms_eps).reshape(b * l, d)
    y, aux = moe_ffn(p["moe"], flat, cfg.moe, constrain=shard)
    return h + y.reshape(b, l, d), aux


def _ssm_block(p, x, cfg, shard):
    return x + ssm_forward(
        p["ssm"], rms_norm(x, p["norm1"], cfg.rms_eps), cfg.ssm, cfg.rms_eps, shard=shard
    )


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
    tp: int = 1,
    shard: Callable = no_shard,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Every layer in order, the shared block after every
    ``shared_attn_every`` core layers (zamba2); returns the hidden states and
    the MoE aux losses summed over the layers.

    With ``cfg.remat`` and autograd recording, each stacked layer's body runs
    under ``torch.utils.checkpoint`` (non-reentrant): only its input is kept
    and its forward runs again in the backward, as the reference's
    ``jax.checkpoint`` of the scanned body (the shared block is not wrapped
    there either).  ``tp`` sets the head plan (padded heads); ``shard``
    re-places tensors at the reference's sites (``train/step.make_shard_fn``),
    and the hidden states after each run of same-kind layers."""
    plan = head_plan(cfg, tp)
    splan = shared_attn_plan(cfg, tp)
    every = cfg.shared_attn_every
    window = cfg.sliding_window
    bodies: Dict[str, Callable] = {
        "attn": lambda p, h: _attn_block(p, h, cfg, plan, positions, window, shard),
        "moe": lambda p, h: _moe_block(p, h, cfg, plan, positions, window, shard),
        "ssm": lambda p, h: _ssm_block(p, h, cfg, shard),
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
                x = _attn_block(params["shared_attn"], x, cfg, splan, positions, None, shard)
        x = shard(x, ("batch", "seq", None))
    return x, aux


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``table`` (V, d) at ``tokens``.  On a mesh the table's
    rows are split by vocab over 'model': each rank looks up the tokens in
    its rows (zero for the others, through ``ops.on_local_shards``) and the
    output is a partial sum over those ranks, the gradient of each rank's
    rows its own (partial over the ranks that split the tokens)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not isinstance(table, DTensor):
        return F.embedding(tokens, table)
    dm = table.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, dm, [Replicate()] * dm.ndim, run_check=False)
    t_pl = ops.local_placements(table, (0,))
    k_pl = ops.local_placements(tokens, (0,))
    out_pl = [Partial() if t.is_shard() else k for t, k in zip(t_pl, k_pl)]
    grad_pl = [t if t.is_shard() else (Partial() if k.is_shard() else t)
               for t, k in zip(t_pl, k_pl)]
    lo = local_range(table.shape, dm, t_pl, 0)[0]

    def lookup(w, tok):
        local = tok - lo
        hit = (local >= 0) & (local < w.shape[0])
        return F.embedding(local.clamp(0, w.shape[0] - 1), w) * hit[..., None].to(w.dtype)

    return ops.on_local_shards(lookup, out_pl, (t_pl, k_pl), (grad_pl, k_pl))(table, tokens)


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
    emb = embed_lookup(params["embed"], tokens).to(dt)
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
    lf = whole_dim(logits.float(), -1)          # on a mesh: gathered over 'model'
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
    tp: int = 1,
    shard: Callable = no_shard,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total loss, metrics) of one microbatch: ``batch["tokens"]`` (b, L)
    and, for a frontend config, ``batch["extra"]`` (b, n_extra, feat).  The
    loss is over the text positions only (the frontend's are cut off), each
    predicting the next token, the last one ignored; the total adds the MoE
    aux losses summed over the layers.  On a mesh the params and the batch
    are DTensors and ``shard`` places the activations (``train/step.py``);
    the logits, split by vocab over 'model', are gathered whole there for the
    loss (its max, log-sum-exp and the gold logits' gather then run on each
    rank's rows alone)."""
    tokens = batch["tokens"]
    extra = batch.get("extra")
    params = compute_params(params, cfg)
    x, positions = embed_inputs(params, tokens, cfg, extra)
    x = shard(x, ("batch", "seq", None))
    x, aux = backbone(params, x, cfg, positions, tp, shard)
    n_extra = 0 if extra is None else extra.shape[1]
    logits = shard(logits_from(params, x[:, n_extra:], cfg), ("batch", "seq", "vocab"))
    labels = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -1)], dim=1)
    loss, n_tok = lm_loss(logits, labels)
    total = loss + aux["moe_lb_loss"] + aux["moe_z_loss"]
    return total, {"loss": loss, "n_tokens": n_tok, **aux}


def prefill(
    params: Params, tokens: torch.Tensor, cfg: ModelConfig, tp: int = 1,
    shard: Callable = no_shard, extra: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Full-sequence forward producing last-position logits (b, 1, V): the
    compute-bound phase of serving.  Attention runs through K6 and every SSD
    layer through K7 (twice).  As in the reference, it populates no decode
    cache: the serving loop primes its caches step by step.  ``extra``: the
    frontend's features, prepended (``pos`` counts them).  ``tp`` and
    ``shard`` as in ``backbone``."""
    params = compute_params(params, cfg)
    x, positions = embed_inputs(params, tokens, cfg, extra)
    x = shard(x, ("batch", "seq", None))
    x, _ = backbone(params, x, cfg, positions, tp, shard)
    return logits_from(params, x[:, -1:], cfg), {"pos": x.shape[1]}


# ==================================================================== decode


def make_cache(cfg: ModelConfig, batch: int, seq_len: int, tp: int = 1,
               device=None) -> Dict[str, Any]:
    """Zero-initialized decode caches on ``device`` (None: the card), with
    the kv heads of the head plan at tensor-parallel degree ``tp``.  ``pos``
    is a host int; the rest are tensors (``train/step.shard_caches`` places
    them on a mesh)."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    plan = head_plan(cfg, tp)
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
        splan = shared_attn_plan(cfg, tp)
        n_shared = len(kinds) // cfg.shared_attn_every
        shape = (n_shared, batch, cache_len, splan.pad_kv, hd)
        caches["shared_attn"] = {
            "k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev),
        }
    return caches


def _decode_attn_block(p, x, cfg, plan, cache_k, cache_v, slot_pos, pos, window, shard,
                       row_start=None):
    """One attention (+ MLP or MoE) decode step; writes the new K/V into its
    slot of ``cache_k`` / ``cache_v`` in place (on a mesh, on the ranks whose
    shard of the cache holds the slot)."""
    b = x.shape[0]
    xn = rms_norm(x, p["norm1"], cfg.rms_eps)
    # the weights at their tensor-parallel layout, as the prefill's
    # attention takes them (``_attention``): used as stored (FSDP-split),
    # DTensor may split the projection's flattened heads × head_dim unevenly
    # over 'model', which it cannot view back as heads (internvl2's 3 kv
    # heads at tp 16)
    q = torch.einsum("bld,dhk->blhk", xn, shard(p["wq"], (None, "heads", None)))
    k = torch.einsum("bld,dhk->blhk", xn, shard(p["wk"], (None, "kv_heads", None)))
    v = torch.einsum("bld,dhk->blhk", xn, shard(p["wv"], (None, "kv_heads", None)))
    posb = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posb, cfg.rope_theta)
    k = apply_rope(k, posb, cfg.rope_theta)
    slot = pos % cache_k.shape[1]
    write_slot(cache_k, 1, slot, k[:, 0])
    write_slot(cache_v, 1, slot, v[:, 0])
    cache_k = shard(cache_k, ("batch", "cache_seq", "kv_heads", None))
    cache_v = shard(cache_v, ("batch", "cache_seq", "kv_heads", None))
    o = decode_attention(
        q, cache_k, cache_v, slot_pos, pos,
        groups=plan.groups, grouped=plan.grouped,
        window=window, softcap=cfg.attn_logit_softcap, row_start=row_start,
    )
    h = x + torch.einsum("blhk,hkd->bld", o.to(x.dtype), shard(p["wo"], ("heads", None, None)))
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
    tp: int = 1,
    shard: Callable = no_shard,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One serving step: next-token logits (b, 1, V) and the caches.

    Unlike the reference, which returns new cache arrays, the port updates
    the cache tensors in place (one slot of K/V, the SSM state and conv rows)
    and returns the same dict with ``pos`` advanced.  ``attn`` and ``moe``
    layers share the attention caches, in layer order.  On a mesh the caches
    are DTensors laid out by ``train/step.cache_logical_axes`` (a full
    attention cache split by slots over 'model': the softmax over the slots
    then spans those ranks)."""
    pos = int(caches["pos"])
    params = compute_params(params, cfg)
    plan = head_plan(cfg, tp)
    splan = shared_attn_plan(cfg, tp)
    x = embed_lookup(params["embed"], token).to(torch_dtype(cfg.dtype))
    if "attn" in caches:
        slot_pos = caches["attn"]["slot_pos"]
        write_slot(slot_pos, 0, pos % slot_pos.shape[0], torch.tensor(pos, dtype=torch.int32))
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
                    slot_pos, pos, cfg.sliding_window, shard, row_start,
                )
            else:
                y, state, conv = ssm_decode_step(
                    p["ssm"], rms_norm(x, p["norm1"], cfg.rms_eps), cfg.ssm, cfg.rms_eps,
                    caches["ssm"]["state"][j], caches["ssm"]["conv"][j],
                )
                x = x + y
                assign(caches["ssm"]["state"][j], state)
                assign(caches["ssm"]["conv"][j], conv)
            used[cache] += 1
            layers_done += 1
            if every and layers_done % every == 0:
                s = used["shared"]
                x = _decode_attn_block(
                    params["shared_attn"], x, cfg, splan, caches["shared_attn"]["k"][s],
                    caches["shared_attn"]["v"][s], slot_pos, pos, None, shard, row_start,
                )
                used["shared"] += 1
    caches["pos"] = pos + 1
    return logits_from(params, x, cfg), caches
