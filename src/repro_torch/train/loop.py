"""Fault-tolerant training loop: the port of ``repro.train.loop``.

  * resume-from-checkpoint: the loop is a function of (checkpoint, step);
    batches come from the seekable pipeline (``batch_at(step)``), so a
    killed job restarted on the same or a DIFFERENT mesh reproduces the same
    parameter trajectory (elastic re-meshing: ``CheckpointManager.restore``
    places the whole stored arrays by the new mesh's shardings);
  * crash injection: ``fail_at_step`` raises mid-run for the restart tests;
  * metrics stream to JSONL for offline inspection.

The trainer runs on any ``ParseMesh``, its tensors on the card unless
``device="cpu"``.  On a mesh of several ranks every rank runs it alike:
params are made whole from the seed and cut to the rank's shards by
``param_shardings``, the optimizer state is laid out like the params, and
every rank builds the same global batch from ``batch_at(step)`` and keeps
its own rows (no scatter); rank 0 alone writes checkpoints and the metrics
file.  ``checkpoint_every=0`` writes no checkpoint at all, for a state too
large to go to disk (zamba2-2.7b at full width: ~47 GB).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.engine import resolve_device
from ..models.config import ModelConfig, ShapeSpec
from ..models.layers import torch_dtype
from ..models.model import init_params
from ..optim.adamw import AdamWConfig, OptState, init_opt_state
from ..parallel.sharding import MeshRules, NamedSharding, adapt_rules_for
from .checkpoint import CheckpointManager
from .step import make_train_step, param_shardings, place_tree, plan_for, shape_aware_spec


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 20           # 0: never write a checkpoint
    keep_checkpoints: int = 3
    log_every: int = 10
    seed: int = 0
    fail_at_step: Optional[int] = None   # crash injection for restart tests


class Trainer:
    def __init__(
        self,
        cfg: ModelConfig,
        shape: ShapeSpec,
        mesh,
        workdir,
        tcfg: Optional[TrainerConfig] = None,
        opt: Optional[AdamWConfig] = None,
        pipeline=None,
        device=None,
    ):
        self.cfg = cfg
        self.shape = shape
        self.mesh = mesh
        self.device = resolve_device(device)
        self.tcfg = tcfg or TrainerConfig()
        self.rules = adapt_rules_for(cfg, mesh, MeshRules())
        self.plan = plan_for(cfg, shape, mesh, opt or AdamWConfig())
        self.workdir = Path(workdir)
        self.ckpt = CheckpointManager(self.workdir / "ckpt", keep=self.tcfg.keep_checkpoints)
        self.metrics_path = self.workdir / "metrics.jsonl"
        if pipeline is None:
            from ..data.pipeline import SyntheticLM

            pipeline = SyntheticLM(
                vocab_size=cfg.vocab_size,
                seq_len=shape.seq_len,
                global_batch=shape.global_batch,
                seed=self.tcfg.seed,
            )
        self.pipeline = pipeline
        self._shardings = param_shardings(cfg, mesh, self.rules, self.plan.tp)
        self._step = make_train_step(self.plan, mesh, self.rules)

    # ------------------------------------------------------------- state

    def init_state(self):
        params = init_params(self.cfg, seed=self.tcfg.seed, device=self.device,
                             tp=self.plan.tp)
        params = place_tree(params, self._shardings)
        return params, init_opt_state(params)

    def restore_or_init(self):
        latest = self.ckpt.latest_step()
        if latest is None:
            return 0, *self.init_state()
        sh = self._shardings
        step, (params, opt_state), _ = self.ckpt.restore(
            self.init_state(), shardings=(sh, OptState(step=None, master=sh, m=sh, v=sh)))
        return step, params, opt_state

    def _place(self, t: torch.Tensor, logical) -> torch.Tensor:
        """A whole batch tensor (the same on every rank) cut to this rank's
        rows by ``logical``."""
        spec = shape_aware_spec(tuple(t.shape), logical, self.mesh, self.rules)
        return place_tree(t, NamedSharding(self.mesh, spec))

    # -------------------------------------------------------------- data

    def device_batch(self, step: int) -> Dict[str, torch.Tensor]:
        """The step's batch as (accum, microbatch, seq) int64 tokens on the
        device; a frontend config gets the reference's zero ``extra``
        features (accum, microbatch, n_extra, feat) in ``cfg.dtype``.  On a
        mesh both are DTensors, the microbatch dim over ('pod', 'data')."""
        raw = self.pipeline.batch_at(step)
        accum, micro = self.plan.accum_steps, self.plan.microbatch
        toks = raw["tokens"].reshape(accum, micro, self.plan.seq_len)
        tokens = torch.from_numpy(toks.astype(np.int64)).to(self.device)
        batch = {"tokens": self._place(tokens, (None, "batch", None))}
        if self.cfg.frontend is not None:
            fe = self.cfg.frontend
            extra = torch.zeros(
                (accum, micro, fe.n_extra_tokens, fe.feature_dim),
                dtype=torch_dtype(self.cfg.dtype), device=self.device,
            )
            batch["extra"] = self._place(extra, (None, "batch", None, None))
        return batch

    # -------------------------------------------------------------- run

    def run(self) -> Dict[str, Any]:
        start, params, opt_state = self.restore_or_init()
        history = []
        every = self.tcfg.checkpoint_every
        writer = self.mesh.rank == 0
        with self.metrics_path.open("a") if writer else contextlib.nullcontext() as mf:
            for step in range(start, self.tcfg.total_steps):
                if self.tcfg.fail_at_step is not None and step == self.tcfg.fail_at_step:
                    raise RuntimeError(f"injected failure at step {step}")
                t0 = time.time()
                batch = self.device_batch(step)
                params, opt_state, metrics = self._step(params, opt_state, batch)
                loss = float(metrics["loss"])
                if every and ((step + 1) % every == 0 or step + 1 == self.tcfg.total_steps):
                    self.ckpt.save(step + 1, (params, opt_state), extra={"loss": loss})
                rec = {
                    "step": step + 1,
                    "loss": loss,
                    "grad_norm": float(metrics["grad_norm"]),
                    "lr": float(metrics["lr"]),
                    "dt": time.time() - t0,
                }
                history.append(rec)
                if writer and ((step + 1) % self.tcfg.log_every == 0 or step == start):
                    mf.write(json.dumps(rec) + "\n")
                    mf.flush()
        self.ckpt.wait()
        return {"history": history, "final_loss": history[-1]["loss"] if history else None}
