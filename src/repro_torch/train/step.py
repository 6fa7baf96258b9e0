"""Train / serve steps: microbatch accumulation and mixed precision, the port
of ``repro.train.step``.

The reference's recipe on one rank:
  * gradient accumulation over microbatches — each microbatch's gradients are
    "compressed" to bf16 (the reduction dtype of its data-parallel
    all-reduce) and summed in fp32: ``a + g.to(bfloat16).to(float32)``;
  * the optimizer update in fp32 masters, params re-cast to ``param_dtype``
    (``optim/adamw.py``).

Gradients come from ``torch.autograd.grad`` through ``forward_train``, whose
attention (K6) and SSD (K7) are ``torch.autograd.Function``s: the kernels run
forward (and again in remat's recompute), the backward recomputes their
plain versions.  Multi-rank training (data parallelism over ('pod', 'data'),
FSDP and TP) is ROADMAP item 12d: every step builder here takes a mesh of
one rank and raises on a larger one (``rules`` are taken for the
reference's signature), and the serve steps have no tensor parallel degree
(the reference's ``tp`` argument).  The dry-run's ``abstract_*`` inputs wait
for the ``launch/`` tools (item 12c).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from ..launch.mesh import mesh_chips
from ..models.config import ModelConfig, ShapeSpec
from ..models.layers import torch_dtype
from ..models.model import decode_step, forward_train, prefill
from ..optim.adamw import AdamWConfig, OptState, apply_updates, tree_leaves, tree_map
from ..parallel.sharding import MeshRules

Params = Any


def require_one_rank(mesh, what: str) -> None:
    """Raise unless ``mesh`` has one rank: the port trains and serves the LM
    on one card."""
    if mesh_chips(mesh) > 1:
        raise NotImplementedError(
            f"{what} on a mesh of {mesh_chips(mesh)} ranks ({dict(mesh.shape)}) is not ported: "
            "multi-rank training (data parallel, FSDP, TP over torch.distributed) is ROADMAP "
            "item 12d; the port runs one rank"
        )


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
    params' device; ``batch['extra']`` (accum, microbatch, n_extra, feat)
    for a frontend config.  The params and the state are updated in place
    (``apply_updates``) and returned; ``metrics`` holds the mean microbatch
    ``loss`` and the update's ``grad_norm`` (0-d tensors) and ``lr``."""
    require_one_rank(mesh, "training")
    cfg, opt = plan.cfg, plan.opt

    def train_step(params: Params, opt_state: OptState, batch: Dict[str, torch.Tensor]):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        leaves = tree_leaves(live)
        gacc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
        loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for i in range(plan.accum_steps):
            micro = {k: v[i] for k, v in batch.items()}
            total, metrics = forward_train(live, micro, cfg)
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
            # bf16 gradient "compression", fp32 accumulation
            for acc, g in zip(gacc, grads):
                if g is not None:
                    acc.add_(g.to(torch.bfloat16))
            del grads, total
            loss_sum = loss_sum + metrics["loss"].detach()
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


def make_prefill_step(cfg: ModelConfig, mesh, rules: MeshRules) -> Callable:
    require_one_rank(mesh, "prefill")

    @torch.no_grad()
    def prefill_step(params, tokens, extra=None):
        return prefill(params, tokens, cfg, extra=extra)

    return prefill_step


def make_decode_step(cfg: ModelConfig, mesh, rules: MeshRules) -> Callable:
    require_one_rank(mesh, "decode")

    @torch.no_grad()
    def serve_step(params, caches, token):
        return decode_step(params, caches, token, cfg)

    return serve_step
