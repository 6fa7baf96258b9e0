"""repro_torch's dry-run (``launch/dryrun.py``) on fake process groups.

The fake process group is global to a process, so everything here runs in
one subprocess (``WORKER``), which prints its findings as JSON:

* ``make_production_mesh`` gives the reference's shapes and axes
  (``repro/launch/mesh.py``: (16, 16) ('data', 'model'), (2, 16, 16)
  ('pod', 'data', 'model')), the reference's built on 512 forced XLA host
  devices in the same process;
* on a fake (2, 2) ('data', 'model') mesh, the abstract inputs
  (``abstract_train_inputs`` / ``abstract_prefill_inputs`` /
  ``abstract_decode_inputs``) have the placements and local shapes that
  ``shard_params`` / ``shard_caches`` and the batch's own placement give
  real CPU tensors on the same mesh, leaf for leaf;
* smoke dry-run cells on that mesh (zamba2 and mixtral smoke; a train shape
  of 4 × 32 tokens, accum 2 × microbatch 2, and a decode shape over a
  32-slot cache), traced on meta tensors modeling the CPU: each rank's dot
  flops equal, exactly, what the recorder counts when the same step runs on
  real CPU tensors on the same mesh; times the 4 ranks they are at least a
  one-rank real CPU step's ``FlopCounterMode`` count at the same head
  padding (tp 2), and at most 1.5 times it: the excess is the work DTensor
  repeats on every rank (MoE's routing, whole on each rank; the SSM's
  replicated layers), reported, not a tolerance of the count;
* each cell's record has the reference's ``Roofline.to_dict()`` keys, and
  ``model_flops`` equals the reference's formula on the reference's smoke
  config;
* the CLI on the production meshes: the parser's cell on ``pod`` and
  ``multipod`` (its device program: K1, the product all-gather over the
  chunk ranks, K3 in the join, K2, the column gather; modeled launches),
  written atomically, and a second run finds both cells cached.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 400

WORKER = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import dataclasses, json, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)

out = {}
from repro.launch.mesh import make_production_mesh as ref_production_mesh
from repro_torch.launch.mesh import ParseMesh, make_production_mesh, mesh_chips
for multi in (False, True):
    r = ref_production_mesh(multi_pod=multi)
    out[f"ref_mesh_{multi}"] = [list(r.axis_names), [int(r.shape[a]) for a in r.axis_names],
                                int(r.devices.size)]

from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.tensor import DTensor
from torch.utils.flop_counter import FlopCounterMode
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
from repro_torch.configs import get_smoke
from repro_torch.launch import dryrun, op_stats
from repro_torch.models.config import SHAPE_BY_NAME
from repro_torch.models.model import init_params, make_cache
from repro_torch.optim.adamw import init_opt_state
from repro_torch.parallel.sharding import MeshRules, adapt_rules_for
from repro_torch.train import step as S

import types
mesh = ParseMesh((2, 2), ("data", "model"))
one = types.SimpleNamespace(shape={"data": 1}, axis_names=("data",))   # one rank's mesh
TP = 2
SHAPES = {"train_4k": dict(global_batch=4, seq_len=32), "decode_32k": dict(global_batch=4, seq_len=32)}

def layout(tree):
    if isinstance(tree, dict):
        return {k: layout(v) for k, v in sorted(tree.items())}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: layout(getattr(tree, f)) for f in tree._fields if f != "step"}
    if isinstance(tree, (tuple, list)):
        return [layout(v) for v in tree]
    if isinstance(tree, DTensor):
        return [str(tree.placements), list(tree.to_local().shape), str(tree.dtype)]
    if isinstance(tree, torch.Tensor):
        return ["plain", list(tree.shape), str(tree.dtype)]
    return repr(tree)

def placed(t, logical, rules):
    return S.place_tree(t, S.NamedSharding(mesh, S.shape_aware_spec(tuple(t.shape), logical, mesh, rules)))

def real_inputs(cfg, shape, rules, plan=None):
    params = S.shard_params(init_params(cfg, 0, device="cpu", tp=TP), mesh, rules, cfg, TP)
    gen = torch.Generator().manual_seed(0)
    if shape.kind == "train":
        tok = torch.randint(0, cfg.vocab_size, (plan.accum_steps, plan.microbatch, shape.seq_len),
                            generator=gen).to(torch.int32)
        return params, init_opt_state(params), {"tokens": placed(tok, (None, "batch", None), rules)}
    caches = make_cache(cfg, shape.global_batch, shape.seq_len, TP, device="cpu")
    caches["pos"] = shape.seq_len - 1
    caches = S.shard_caches(caches, cfg, mesh, rules)
    tok = torch.zeros((shape.global_batch, 1), dtype=torch.int32)
    return params, caches, placed(tok, ("batch", None), rules)

cells = {}
for arch in ("zamba2-2.7b", "mixtral-8x22b"):
    cfg = get_smoke(arch)
    rules = adapt_rules_for(cfg, mesh, MeshRules())
    # abstract inputs against real ones (prefill's tokens too)
    pre = dataclasses.replace(SHAPE_BY_NAME["prefill_32k"], global_batch=4, seq_len=32)
    a_params, a_tok, _ = S.abstract_prefill_inputs(cfg, pre, mesh, rules, TP)
    r_tok = placed(torch.zeros((4, 32), dtype=torch.int32), ("batch", None), rules)
    out[f"placed_prefill_{arch}"] = layout((a_params, a_tok)) == layout(
        (S.shard_params(init_params(cfg, 0, device="cpu", tp=TP), mesh, rules, cfg, TP), r_tok))
    for sname, kw in SHAPES.items():
        shape = dataclasses.replace(SHAPE_BY_NAME[sname], **kw)
        plan = S.plan_for(cfg, shape, mesh) if shape.kind == "train" else None
        if plan is not None:
            abstract = S.abstract_train_inputs(cfg, plan, mesh, rules)
        else:
            abstract = S.abstract_decode_inputs(cfg, shape, mesh, rules, TP)
        real = real_inputs(cfg, shape, rules, plan)
        out[f"placed_{arch}_{sname}"] = layout(abstract) == layout(real)
        rec = dryrun.run_cell(cfg, shape, mesh, "smoke", device="cpu")
        # the same step on the real inputs, recorded as it runs
        if plan is not None:
            fn = S.make_train_step(plan, mesh, rules)
        else:
            fn = S.make_decode_step(cfg, mesh, rules, TP)
        live = op_stats.OpRecorder("cpu", meta_only=False)
        with live:
            fn(*real)
        # one rank, real tensors, the same head padding
        params1 = init_params(cfg, 0, device="cpu", tp=TP)
        if plan is not None:
            plan1 = dataclasses.replace(plan, tp=TP)
            tok = torch.randint(0, cfg.vocab_size, (plan.accum_steps, plan.microbatch,
                                shape.seq_len), generator=torch.Generator().manual_seed(0))
            fn1, args1 = S.make_train_step(plan1, one, MeshRules()), (
                params1, init_opt_state(params1), {"tokens": tok.to(torch.int32)})
        else:
            caches = make_cache(cfg, shape.global_batch, shape.seq_len, TP, device="cpu")
            caches["pos"] = shape.seq_len - 1
            fn1, args1 = S.make_decode_step(cfg, one, MeshRules(), TP), (
                params1, caches, torch.zeros((shape.global_batch, 1), dtype=torch.int32))
        with FlopCounterMode(display=False) as fc:
            fn1(*args1)
        cells[f"{arch}|{sname}"] = {
            "record": rec, "live_dot_flops": live.stats.dot_flops,
            "one_rank_flop_counter": fc.get_total_flops(),
            "n_tokens": shape.global_batch * shape.seq_len, "kind": shape.kind,
            "seq_len": shape.seq_len, "global_batch": shape.global_batch}
out["cells"] = cells

# the CLI on the production meshes: the parser's cell, then again from the file
path = sys.argv[1]
out["cli_rc"] = dryrun.main(["--arch", "regex-parser", "--mesh", "both", "--out", path])
out["cli_rc_again"] = dryrun.main(["--arch", "regex-parser", "--mesh", "both", "--out", path])
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def worker(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"), os.environ.get("PYTHONPATH", "")]),
        JAX_PLATFORMS="cpu")
    path = tmp / "results.json"
    proc = subprocess.run([sys.executable, "-c", WORKER, str(path)], env=env, cwd=tmp,
                          capture_output=True, text=True, timeout=TIMEOUT_S)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    assert proc.returncode == 0 and lines, proc.stdout[-3000:] + proc.stderr[-6000:]
    return json.loads(lines[-1][len("RESULT "):]), json.loads(path.read_text()), proc.stdout


@pytest.mark.parametrize("multi", [False, True])
def test_production_mesh_equals_the_reference(worker, multi):
    from repro_torch.launch.mesh import PRODUCTION

    out, _, _ = worker
    axes, sizes, n = out[f"ref_mesh_{multi}"]
    shape, names = PRODUCTION[multi]
    assert (list(names), list(shape), 512 if multi else 256) == (axes, sizes, n)


@pytest.mark.parametrize("case", ["zamba2-2.7b_train_4k", "zamba2-2.7b_decode_32k",
                                  "mixtral-8x22b_train_4k", "mixtral-8x22b_decode_32k",
                                  "prefill_zamba2-2.7b", "prefill_mixtral-8x22b"])
def test_abstract_inputs_are_placed_as_real_ones(worker, case):
    out, _, _ = worker
    assert out[f"placed_{case}"] is True


CELLS = ["zamba2-2.7b|train_4k", "zamba2-2.7b|decode_32k", "mixtral-8x22b|train_4k",
         "mixtral-8x22b|decode_32k"]


@pytest.mark.parametrize("cell", CELLS)
def test_smoke_cell_counts_what_the_step_runs(worker, cell):
    out, _, _ = worker
    c = out["cells"][cell]
    rec = c["record"]
    per_rank = rec["coll_detail"]["dot_flops_per_device"]
    assert rec["ok"] and not rec.get("skipped")
    assert per_rank == c["live_dot_flops"]
    ratio = per_rank * rec["chips"] / c["one_rank_flop_counter"]
    assert 1.0 <= ratio <= 1.5, ratio
    assert rec["chips"] == 4 and rec["coll_bytes"] > 0 and rec["memory_per_device"] > 0
    assert rec["lint"] == []


@pytest.mark.parametrize("cell", CELLS)
def test_smoke_cell_record_follows_the_reference(worker, cell):
    from repro.configs import get_smoke as ref_get_smoke
    from repro.launch import analysis as ref_analysis

    out, _, _ = worker
    c = out["cells"][cell]
    rec = c["record"]
    dummy = ref_analysis.Roofline("a", "s", "m", 1, 1.0, 1.0, 1.0)
    assert set(dummy.to_dict()) <= set(rec)
    cfg = ref_get_smoke(cell.split("|")[0])
    if c["kind"] == "train":
        want = ref_analysis.model_train_flops(cfg.active_params(), c["n_tokens"]) + \
            ref_analysis.model_attn_flops(cfg, c["seq_len"], c["n_tokens"], train=True)
    else:
        want = ref_analysis.model_forward_flops(cfg.active_params(), c["global_batch"]) + \
            ref_analysis.model_attn_flops(cfg, c["seq_len"], c["global_batch"], train=False,
                                          decode=True)
    assert rec["model_flops"] == want


@pytest.mark.parametrize("mesh_name", ["pod", "multipod"])
def test_parser_cell_on_the_production_mesh(worker, mesh_name):
    out, results, stdout = worker
    assert out["cli_rc"] == 0 and out["cli_rc_again"] == 0
    key = f"regex-parser|text|{mesh_name}"
    assert f"[CACHED] {key}" in stdout
    rec = results[key]
    chips, chunk_ranks = (256, 16) if mesh_name == "pod" else (512, 32)
    assert rec["ok"] and rec["chips"] == chips and rec["shape"] == f"text_{chunk_ranks}x1048576"
    launches = rec["coll_detail"]["kernel_launches"]
    assert launches["reach_chunk_product"] == 1 and launches["build_merge_packed"] == 1
    assert launches["semiring_matmul"] > 0
    # the product all-gather and the column gather, over the chunk ranks
    assert rec["coll_detail"]["coll_ops_per_device"] == 2
    assert rec["coll_detail"]["all-gather"] > 0
