"""Multi-pod dry-run: trace every (arch × shape × mesh) cell once, per rank.

The port's counterpart of ``repro/launch/dryrun.py``.  Where the reference
lowers and compiles each step on 512 placeholder XLA host devices, the port
traces the eager step once on the production mesh of PyTorch's fake process
group (``launch/mesh.make_production_mesh``: 256 or 512 ranks in this one
process, rank 0's view; every collective returns at once), on inputs with
no storage, under ``launch/op_stats.OpRecorder``.  Per cell:

  1. the production mesh and the shape-adapted sharding rules
     (``adapt_rules_for``);
  2. every input as a meta tensor placed as the real one would be
     (``train/step.abstract_*_inputs``: DTensors over the mesh, no storage);
  3. one call of ``make_train_step`` (train shapes) or ``make_prefill_step``
     / ``make_decode_step`` (serve shapes) under the recorder: every ATen op
     on the rank's local shards, every collective DTensor issues, every
     kernel launch modeled by its ``cost`` (the recorder models the card
     unless ``--device cpu``, where the kernels' plain versions run);
  4. ``analyze_compiled`` on the record: per-rank flops, bytes, collective
     bytes by kind and peak live bytes (``memory_per_device``), × chips, and
     the roofline terms on the H100's constants;
  5. the cell's record appended to a JSON results file, written atomically
     (resumable: cells already there are skipped unless ``--force``).  A
     cell that fails is recorded with its error and the sweep goes on.

DTensor under ``FakeTensorMode`` fails on this mesh (its redistribute
planner reads a value, ``aten._local_scalar_dense``, for a ``_StridedShard``
input), so the traced tensors are meta tensors instead, on the fake mesh
(``ParseMesh.device_mesh_for`` places them), and the planner's own tensors
stay real.  A train step with many microbatches is traced with 1 and 2 and
extrapolated (``op_stats.extrapolate``): the step repeats one body.

Also the parser's own cell (``--arch regex-parser``): the mesh layer's
device program (``DistributedEngine.device_program``: reach on the rank's
chunks, the product all-gather, the join, K2 and the column gather, no host
assembly) on the ``cuda`` backend at 1 Mi characters a chunk row over every
chunk rank ('pod' × 'data').

Usage:
  python -m repro_torch.launch.dryrun --all                  # every cell, both meshes
  python -m repro_torch.launch.dryrun --arch zamba2-2.7b --shape prefill_32k --mesh pod
  python -m repro_torch.launch.dryrun --list
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from pathlib import Path
from typing import Dict, Optional

RESULTS = Path(__file__).resolve().parents[3] / "experiments" / "torch_dryrun_results.json"

PARSER_ARCH = "regex-parser"
PARSER_PATTERN = "(a|b|ab)+"
PARSER_CHUNK = 1 << 20        # characters a chunk row


def _load(path: Path) -> dict:
    if path.exists():
        return json.loads(path.read_text())
    return {}


def _save(path: Path, data: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(data, indent=1, sort_keys=True))
    tmp.replace(path)


def cell_key(arch: str, shape: str, mesh_name: str) -> str:
    return f"{arch}|{shape}|{mesh_name}"


def parser_cell(mesh, mesh_name: str, *, k: int = PARSER_CHUNK) -> Dict:
    """The parser's device program on ``mesh`` (one text, one chunk row of
    ``k`` characters a chunk rank), traced on the ``cuda`` backend; returns
    the cell's record (the ``Roofline``'s dict, ``trace_s``, ``ok``)."""
    import torch

    from ..core.engine import ParserEngine
    from ..core.reference import ParallelArtifacts
    from ..analyze.roofline import analyze_compiled
    from .mesh import mesh_chips
    from .op_stats import OpRecorder, meta_like

    art = ParallelArtifacts.generate(PARSER_PATTERN)
    eng = ParserEngine(art.matrices, backend="cuda", device="meta", mesh=mesh)
    dist = eng.dist
    t = eng.tables
    chunk_rows = dist.chunk_devices
    grid = torch.empty((1, 1, k), dtype=torch.int32, device="meta")   # this rank's row
    N, I, F = meta_like((t.N, t.I, t.F))
    t0 = time.time()
    rec = OpRecorder("cuda")
    rec.track(N, I, F, grid)
    with rec:
        dist.device_program(N, I, F, grid, (), dist.chunk_axes)
    dt = time.time() - t0
    # the ME-DFA-equivalent useful work: the build's mat-vecs (2·n·ℓp²)
    # forward and backward, and reach's products (2·n·ℓp³)
    lp = t.ell_pad
    n = chunk_rows * k
    model_flops = 2.0 * n * lp * lp * (lp + 2)
    r = analyze_compiled(rec.stats, arch=PARSER_ARCH, shape=f"text_{chunk_rows}x{k}",
                         mesh_name=mesh_name, chips=mesh_chips(mesh), model_flops=model_flops)
    return {**r.to_dict(), "trace_s": dt, "ok": True}


def _model_flops(cfg, shape) -> float:
    from ..analyze.roofline import model_attn_flops, model_forward_flops, model_train_flops

    n_tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return model_train_flops(cfg.active_params(), n_tokens) + model_attn_flops(
            cfg, shape.seq_len, n_tokens, train=True)
    if shape.kind == "prefill":
        return model_forward_flops(cfg.active_params(), n_tokens) + model_attn_flops(
            cfg, shape.seq_len, n_tokens, train=False)
    # one new token a sequence: 2·N_active·batch + the cache's attention
    return model_forward_flops(cfg.active_params(), shape.global_batch) + model_attn_flops(
        cfg, shape.seq_len, shape.global_batch, train=False, decode=True)


def trace_step(cfg, shape, mesh, rules, *, device: str = "cuda", seqs_per_device: int = 1,
               plan=None):
    """Trace one step of ``cfg`` at ``shape`` on ``mesh`` on abstract
    inputs: returns (``OpStats`` of one rank, the ops of the last trace for
    the lint).  A train step of more than 2 microbatches is traced with 1
    and 2 and extrapolated to its count (``plan``: the ``TrainPlan`` to
    trace, default ``plan_for``'s)."""
    from ..train.step import (
        abstract_decode_inputs,
        abstract_prefill_inputs,
        abstract_train_inputs,
        make_decode_step,
        make_prefill_step,
        make_train_step,
        plan_for,
    )
    from .op_stats import OpRecorder, extrapolate

    def run(step, args):
        rec = OpRecorder(device)
        rec.track(args)
        with rec:
            step(*args)
        return rec

    tp = mesh.shape.get("model", 1)
    if shape.kind == "train":
        plan = plan or plan_for(cfg, shape, mesh, seqs_per_device=seqs_per_device)
        if plan.accum_steps <= 2:
            rec = run(make_train_step(plan, mesh, rules), abstract_train_inputs(cfg, plan, mesh, rules))
            return rec.stats, rec.ops
        recs = []
        for accum in (1, 2):
            p = dataclasses.replace(plan, accum_steps=accum)
            recs.append(run(make_train_step(p, mesh, rules),
                            abstract_train_inputs(cfg, p, mesh, rules)))
        return extrapolate(recs[0].stats, recs[1].stats, plan.accum_steps), recs[1].ops
    if shape.kind == "prefill":
        params, tokens, extra = abstract_prefill_inputs(cfg, shape, mesh, rules, tp)
        args = (params, tokens) if extra is None else (params, tokens, extra)
        rec = run(make_prefill_step(cfg, mesh, rules, tp), args)
    else:
        rec = run(make_decode_step(cfg, mesh, rules, tp),
                  abstract_decode_inputs(cfg, shape, mesh, rules, tp))
    return rec.stats, rec.ops


def run_cell(cfg, shape, mesh, mesh_name: str, *, device: str = "cuda",
             seqs_per_device: int = 1) -> Dict:
    """One (config × shape × mesh) cell: its record (the ``Roofline``'s
    dict, the lint's findings, ``trace_s``, ``ok``), or a skip."""
    from ..analyze.program import lint_trace
    from ..analyze.roofline import analyze_compiled
    from ..parallel.sharding import MeshRules, adapt_rules_for
    from .mesh import mesh_chips

    skip = dict(cfg.skip_shapes).get(shape.name)
    if skip:
        return {"ok": True, "skipped": skip}
    rules = adapt_rules_for(cfg, mesh, MeshRules())
    t0 = time.time()
    stats, ops = trace_step(cfg, shape, mesh, rules, device=device,
                            seqs_per_device=seqs_per_device)
    dt = time.time() - t0
    r = analyze_compiled(stats, arch=cfg.name, shape=shape.name, mesh_name=mesh_name,
                         chips=mesh_chips(mesh), model_flops=_model_flops(cfg, shape))
    lint = [str(f) for f in lint_trace(ops, f"{cfg.name}:{shape.name}@{mesh_name}")]
    return {**r.to_dict(), "trace_s": dt, "lint": sorted(set(lint)), "ok": True}


def _report(key: str, rec: Dict) -> None:
    print(f"  [OK] {key} trace={rec['trace_s']:.1f}s bottleneck={rec['bottleneck']} "
          f"t=(c {rec['t_compute']:.2e}, m {rec['t_memory']:.2e}, n {rec['t_collective']:.2e}) "
          f"mem/rank={rec['memory_per_device'] / 1e9:.2f}GB "
          f"useful={rec['useful_ratio']:.3f} frac={rec['roofline_fraction']:.3f}")


def main(argv: Optional[list] = None) -> int:
    from ..configs import ARCH_IDS, get_config
    from ..models.config import SHAPE_BY_NAME, SHAPES
    from .mesh import make_production_mesh

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, help=f"one of {ARCH_IDS + [PARSER_ARCH]}")
    ap.add_argument("--shape", default=None, help="train_4k|prefill_32k|decode_32k|long_500k")
    ap.add_argument("--mesh", default="both", choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--seqs-per-device", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the device the traced kernels model (cpu: their plain versions)")
    ap.add_argument("--out", default=str(RESULTS))
    args = ap.parse_args(argv)

    out = Path(args.out)
    results = _load(out)
    if args.list:
        for k, v in sorted(results.items()):
            status = "SKIP" if v.get("skipped") else ("OK" if v.get("ok") else "FAIL")
            print(f"{status:5s} {k}")
        return 0

    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = [s.name for s in SHAPES] if (args.all or args.shape is None) else [args.shape]
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]

    failures = 0
    for mesh_name in meshes:
        mesh = make_production_mesh(multi_pod=(mesh_name == "multipod"))
        for arch in archs:
            cells = ([(PARSER_ARCH, None)] if arch == PARSER_ARCH
                     else [(arch, s) for s in shapes])
            for arch_, shape_name in cells:
                if shape_name is None:
                    key = cell_key(PARSER_ARCH, "text", mesh_name)
                else:
                    key = cell_key(arch_, shape_name, mesh_name)
                if not args.force and key in results and results[key].get("ok"):
                    print(f"  [CACHED] {key}")
                    continue
                print(f"== {key}", flush=True)
                try:
                    if shape_name is None:
                        rec = parser_cell(mesh, mesh_name)
                    else:
                        rec = run_cell(get_config(arch_), SHAPE_BY_NAME[shape_name], mesh,
                                       mesh_name, device=args.device,
                                       seqs_per_device=args.seqs_per_device)
                    results[key] = rec
                    if rec.get("skipped"):
                        print(f"  [SKIP] {key}: {rec['skipped']}")
                    else:
                        _report(key, rec)
                except Exception as e:  # record the failure, keep going
                    failures += 1
                    results[key] = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                    print(f"  [FAIL] {key}: {e}")
                    traceback.print_exc(limit=3)
                _save(out, results)
    _save(out, results)
    print(f"done; {failures} failures; results in {out}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
