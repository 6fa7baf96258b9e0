"""Train / serve steps: placement, microbatch accumulation and mixed
precision, the port of ``repro.train.step``.

The reference's recipe, on a mesh of any shape:
  * params: logical axes from the model decls → ('data' fsdp, 'model' tp),
    laid out by ``shape_aware_spec`` (an axis that does not divide its dim is
    dropped); the batch's leading dim over ('pod', 'data');
  * gradient accumulation over microbatches — each microbatch's gradients
    are constrained to the params' layout (their data-parallel reduction:
    a reduce-scatter where FSDP splits the param, an all-reduce where it
    is whole) in the params' dtype, "compressed" to bf16 and summed in fp32:
    ``a + g.to(bfloat16).to(float32)``;
  * the optimizer update in fp32 masters, params re-cast to ``param_dtype``
    (``optim/adamw.py``), each rank on its own shards.

On a mesh of several ranks params, optimizer state, batch and activations
are DTensors over the mesh's ``DeviceMesh`` (``parallel/sharding.place``),
and the steps run under ``implicit_replication`` (a plain tensor made
inside the model, such as the RoPE angles, counts as replicated).  On one
rank nothing is placed and ``shard`` is the identity.  Gradients come from
``torch.autograd.grad`` through ``forward_train``, whose attention (K6) and
SSD (K7) are ``torch.autograd.Function``s on each rank's local heads
(``ops.flash_attention_local``, ``mamba.ssd_local``): the kernels run
forward (and again in remat's recompute), the backward recomputes their
plain versions.  The dry-run's inputs (``abstract_train_inputs``,
``abstract_prefill_inputs``, ``abstract_decode_inputs``) have the real
steps' shapes, dtypes and layouts and no storage: tensors on the meta
device, placed as ``shard_params`` / ``shard_caches`` place real ones
(``launch/dryrun.py`` traces the steps on them).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..launch.mesh import mesh_chips
from ..models.config import ModelConfig, ShapeSpec
from ..models.layers import torch_dtype
from ..models.model import (
    abstract_params,
    decode_step,
    forward_train,
    make_cache,
    no_shard,
    param_logical_axes,
    prefill,
)
from ..optim.adamw import (
    AdamWConfig,
    OptState,
    abstract_opt_state,
    apply_updates,
    tree_leaves,
    tree_map,
)
from ..parallel.sharding import MeshRules, NamedSharding, PartitionSpec, place

Params = Any


def shape_aware_spec(shape: Tuple[int, ...], logical, mesh, rules: MeshRules) -> PartitionSpec:
    """Resolve logical axes to a PartitionSpec, dropping axes whose mesh extent
    does not divide the corresponding dimension (replication is exact)."""
    base = rules.resolve(logical, mesh)
    out = []
    for i, entry in enumerate(base):
        if entry is None:
            out.append(None)
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        size = int(np.prod([mesh.shape[a] for a in axes]))
        out.append(entry if shape[i] % size == 0 else None)
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def map_with_logical(abstract, logical, fn):
    """``fn(leaf, logical_axes)`` over a nested-dict tree and its tree of
    logical axes (tuples, which are leaves here); a leaf that is not a
    tensor (a cache's host ``pos``) is kept as it is."""
    if isinstance(abstract, dict):
        return {k: map_with_logical(v, logical[k], fn) for k, v in abstract.items()}
    return fn(abstract, logical) if isinstance(abstract, torch.Tensor) else abstract


def param_shardings(cfg: ModelConfig, mesh, rules: MeshRules, tp: int):
    """Every param's ``NamedSharding`` (spec by ``shape_aware_spec``)."""
    return map_with_logical(
        abstract_params(cfg, tp),
        param_logical_axes(cfg, tp),
        lambda a, lg: NamedSharding(mesh, shape_aware_spec(tuple(a.shape), lg, mesh, rules)),
    )


def make_shard_fn(mesh, rules: MeshRules) -> Callable:
    """The model's ``shard(t, logical)`` hook: ``t`` placed by its logical
    axes (``shape_aware_spec``); the identity on a mesh of one rank."""
    if mesh_chips(mesh) == 1:
        return no_shard

    def shard(t, logical):
        return place(t, mesh, shape_aware_spec(tuple(t.shape), logical, mesh, rules))

    return shard


def place_tree(tree, shardings):
    """Each tensor leaf of ``tree`` placed by its ``NamedSharding`` (a tree
    of the same structure); a mesh of one rank leaves it as it is."""
    if isinstance(tree, dict):
        return {k: place_tree(v, shardings[k]) for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor) or mesh_chips(shardings.mesh) == 1:
        return tree
    return place(tree, shardings.mesh, shardings.spec)


def shard_params(params: Params, mesh, rules: MeshRules, cfg: ModelConfig, tp: int) -> Params:
    """Whole params (every rank holds the same) cut to this rank's shards by
    ``param_shardings``: DTensors on ``mesh``; on one rank the params."""
    return place_tree(params, param_shardings(cfg, mesh, rules, tp))


def cache_logical_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """Logical axes for decode caches: full-attention caches shard the sequence
    slots over 'model' (flash-decoding across those ranks); ring-buffered SWA
    caches are small and shard kv heads when divisible."""
    axes: Dict[str, Any] = {"pos": ()}
    seq_axis = "cache_seq" if cfg.sliding_window is None else None
    kinds = cfg.layer_kinds
    if any(k in ("attn", "moe") for k in kinds) or cfg.shared_attn_every:
        axes["row_start"] = ("batch",)
    if any(k in ("attn", "moe") for k in kinds):
        axes["attn"] = {
            "k": ("stack", "batch", seq_axis, "kv_heads", None),
            "v": ("stack", "batch", seq_axis, "kv_heads", None),
            "slot_pos": (None,),
        }
    if any(k == "ssm" for k in kinds):
        axes["ssm"] = {
            "state": ("stack", "batch", "heads", None, None),
            "conv": ("stack", "batch", None, "mlp"),
        }
    if cfg.shared_attn_every:
        axes["shared_attn"] = {
            "k": ("stack", "batch", seq_axis, "kv_heads", None),
            "v": ("stack", "batch", seq_axis, "kv_heads", None),
        }
    return axes


def shard_caches(caches: Dict[str, Any], cfg: ModelConfig, mesh, rules: MeshRules):
    """``make_cache``'s caches placed by ``cache_logical_axes`` (on one rank
    the caches themselves)."""
    return place_tree(caches, map_with_logical(
        caches, cache_logical_axes(cfg),
        lambda t, lg: NamedSharding(mesh, shape_aware_spec(tuple(t.shape), lg, mesh, rules))))


def spmd(mesh):
    """The steps' context on ``mesh``: ``implicit_replication`` on a mesh of
    several ranks (plain tensors made inside the model are replicated
    values), nothing on one."""
    if mesh_chips(mesh) == 1:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def whole(t):
    """A DTensor's full value (a collective), or ``t`` itself."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


# ------------------------------------------------------------------ train


@dataclasses.dataclass(frozen=True)
class TrainPlan:
    cfg: ModelConfig
    opt: AdamWConfig
    accum_steps: int
    microbatch: int          # global sequences per microbatch
    seq_len: int
    tp: int


def plan_for(
    cfg: ModelConfig,
    shape: ShapeSpec,
    mesh,
    opt: Optional[AdamWConfig] = None,
    seqs_per_device: int = 1,
) -> TrainPlan:
    """Pick grad-accumulation: each rank sees ``seqs_per_device`` sequences
    per microstep (the reference's rule over the mesh's 'pod' × 'data')."""
    dp = 1
    for ax in ("pod", "data"):
        if ax in mesh.axis_names:
            dp *= mesh.shape[ax]
    tp = mesh.shape.get("model", 1)
    micro = dp * seqs_per_device
    if shape.global_batch % micro != 0:
        micro = dp if shape.global_batch % dp == 0 else shape.global_batch
    micro = min(micro, shape.global_batch)
    accum = max(1, shape.global_batch // micro)
    return TrainPlan(
        cfg=cfg,
        opt=opt or AdamWConfig(),
        accum_steps=accum,
        microbatch=micro,
        seq_len=shape.seq_len,
        tp=tp,
    )


def make_train_step(plan: TrainPlan, mesh, rules: MeshRules) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``batch['tokens']``: (accum, microbatch, seq) integer tensor on the
    params' device (on a mesh a DTensor, the microbatch dim over
    ('pod', 'data')); ``batch['extra']`` (accum, microbatch, n_extra, feat)
    for a frontend config.  The params and the state are updated in place
    (``apply_updates``) and returned; ``metrics`` holds the mean microbatch
    ``loss`` and the update's ``grad_norm`` (0-d plain tensors, the same on
    every rank) and ``lr``."""
    cfg, opt = plan.cfg, plan.opt
    shard = make_shard_fn(mesh, rules)
    specs = tree_leaves(param_shardings(cfg, mesh, rules, plan.tp))

    def train_step(params: Params, opt_state: OptState, batch: Dict[str, torch.Tensor]):
        with spmd(mesh):
            live = tree_map(lambda p: p.detach().requires_grad_(True), params)
            leaves = tree_leaves(live)
            gacc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
            loss_sum = 0.0
            for i in range(plan.accum_steps):
                micro = {k: v[i] for k, v in batch.items()}
                total, metrics = forward_train(live, micro, cfg, plan.tp, shard)
                grads = torch.autograd.grad(total, leaves, allow_unused=True)
                # the DP reduction onto the params' layout, bf16 gradient
                # "compression", fp32 accumulation
                for acc, g, sh in zip(gacc, grads, specs):
                    if g is not None:
                        acc.add_(place_tree(g, sh).to(torch.bfloat16))
                del grads, total
                loss_sum = loss_sum + whole(metrics["loss"].detach())
            for acc in gacc:
                acc.div_(plan.accum_steps)
            acc_iter = iter(gacc)
            grads_tree = tree_map(lambda _: next(acc_iter), params)
            del live, leaves, gacc
            new_params, new_opt, om = apply_updates(
                opt, params, grads_tree, opt_state, torch_dtype(cfg.param_dtype)
            )
        return new_params, new_opt, {"loss": loss_sum / plan.accum_steps, **om}

    return train_step


# ------------------------------------------------------------------ serve


def make_prefill_step(cfg: ModelConfig, mesh, rules: MeshRules, tp: int = 1) -> Callable:
    """(params, tokens, extra=None) -> (last-position logits, {"pos"}), no
    gradients; on a mesh the params placed by ``shard_params`` and the
    logits a DTensor (``.full_tensor()`` gathers them)."""
    shard = make_shard_fn(mesh, rules)

    @torch.no_grad()
    def prefill_step(params, tokens, extra=None):
        with spmd(mesh):
            return prefill(params, tokens, cfg, tp, shard, extra)

    return prefill_step


def make_decode_step(cfg: ModelConfig, mesh, rules: MeshRules, tp: int = 1) -> Callable:
    """(params, caches, token) -> (logits, caches), no gradients; on a mesh
    the caches placed by ``shard_caches`` and updated in place on each
    rank's shard."""
    shard = make_shard_fn(mesh, rules)

    @torch.no_grad()
    def serve_step(params, caches, token):
        with spmd(mesh):
            return decode_step(params, caches, token, cfg, tp, shard)

    return serve_step


# -------------------------------------------------- abstract inputs (dry-run)


def _abstract(shape: Tuple[int, ...], dtype, logical, mesh, rules: MeshRules):
    """A meta tensor of ``shape`` placed by its logical axes."""
    t = torch.empty(shape, dtype=dtype, device="meta")
    return place_tree(t, NamedSharding(mesh, shape_aware_spec(shape, logical, mesh, rules)))


def abstract_train_inputs(cfg: ModelConfig, plan: TrainPlan, mesh, rules: MeshRules):
    """(params, opt_state, batch) of ``make_train_step`` with no storage:
    params placed by ``param_shardings`` (``shard_params``), the optimizer
    state laid out as the params (its step a concrete 0), the tokens
    (accum, microbatch, seq) int32 with the microbatch over 'batch', and a
    frontend config's features (accum, microbatch, n_extra, feat)."""
    params = shard_params(abstract_params(cfg, plan.tp), mesh, rules, cfg, plan.tp)
    opt_state = abstract_opt_state(params)
    lead = (plan.accum_steps, plan.microbatch)
    batch = {"tokens": _abstract(lead + (plan.seq_len,), torch.int32, (None, "batch", None),
                                 mesh, rules)}
    if cfg.frontend is not None:
        fe = cfg.frontend
        batch["extra"] = _abstract(lead + (fe.n_extra_tokens, fe.feature_dim),
                                   torch_dtype(cfg.dtype), (None, "batch", None, None),
                                   mesh, rules)
    return params, opt_state, batch


def abstract_prefill_inputs(cfg: ModelConfig, shape: ShapeSpec, mesh, rules: MeshRules, tp: int):
    """(params, tokens (batch, seq) int32, extra or None) of
    ``make_prefill_step`` with no storage, placed as the real ones."""
    params = shard_params(abstract_params(cfg, tp), mesh, rules, cfg, tp)
    tokens = _abstract((shape.global_batch, shape.seq_len), torch.int32, ("batch", None),
                       mesh, rules)
    extra = None
    if cfg.frontend is not None:
        fe = cfg.frontend
        extra = _abstract((shape.global_batch, fe.n_extra_tokens, fe.feature_dim),
                          torch_dtype(cfg.dtype), ("batch", None, None), mesh, rules)
    return params, tokens, extra


def abstract_decode_inputs(cfg: ModelConfig, shape: ShapeSpec, mesh, rules: MeshRules, tp: int):
    """(params, caches, token (batch, 1) int32) of ``make_decode_step`` with
    no storage: ``make_cache``'s caches on the meta device placed by
    ``shard_caches``, at position seq_len − 1 (the context full: every
    slot live)."""
    params = shard_params(abstract_params(cfg, tp), mesh, rules, cfg, tp)
    caches = make_cache(cfg, shape.global_batch, shape.seq_len, tp, device="meta")
    caches["pos"] = shape.seq_len - 1
    caches = shard_caches(caches, cfg, mesh, rules)
    token = _abstract((shape.global_batch, 1), torch.int32, ("batch", None), mesh, rules)
    return params, caches, token
