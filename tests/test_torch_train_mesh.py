"""repro_torch's LM stack on a mesh of several ranks, on the CPU against the
reference.

* Specs: for every config, at (16, 16) ('data', 'model') and (2, 16, 16)
  ('pod', 'data', 'model'), ``param_logical_axes`` equals the reference's
  tree, ``shape_aware_spec`` of every leaf of ``abstract_params(cfg, tp)``
  and of every ``make_cache`` leaf equals the reference's, and so does
  ``cache_logical_axes``.
* Head padding: the reference's params made at tp 2 and 4 (internvl2's 7
  heads pad to 14 and 8) give the reference's prefill logits on one rank
  (2e-3, the bound of ``tests/test_torch_models.py``).
* Four gloo ranks on a (2, 2) ('data', 'model') mesh, each a subprocess
  (a ``FileStore`` rendezvous, one torch thread), against the reference's
  ``Trainer`` on four forced XLA host devices, also (2, 2), started from the
  same initial state (the reference's, written as a step-0 checkpoint that
  both trainers restore — the port's onto its mesh): tinyllama, zamba2,
  mixtral and internvl2 (padded heads) smoke configs, f32 compute over bf16
  params, 2 steps at the reference's default optimizer.
  Each step's loss within 1e-5 (the reference's own 1-device vs (2, 2) gap
  in f32 is ≤ 1e-6 on the dense configs), its gradient norm within rtol
  1e-4 (the norm sees the gradients' scale, which Adam's step hides), and
  after step 2 every param within atol 2e-5 of the reference's (rtol 1e-3;
  the bf16 params within one bf16 ulp, rtol 2^-7), read from the two
  step-2 checkpoints, which each package writes whole.  MoE is compared at
  the same plan (accum 2 × microbatch 2), since capacity is per
  microbatch.
* The same four ranks against one rank of the port (a process that opens
  no process group): tinyllama and zamba2
  in f32 (params included), 4 steps at the default optimizer: losses within
  1e-5, gradient norms within rtol 1e-3 and the step-2 params within atol
  2e-5; the bf16 default within 2e-2 in the loss (the reference itself
  moves by up to 1.3e-2 between one device and (2, 2) in bf16).  At lr
  1e-3 Adam's sign-like first step turns the bf16 rounding of near-zero
  microbatch gradients (1 row a microbatch on one rank, 2 on the mesh) into
  whole-lr differences, so these runs keep the reference's default.
* One microbatch's gradients on (2, 2), gathered, against one rank's
  (tinyllama, zamba2, mixtral, f32): each leaf's relative L2 error within
  1e-3, the bound ``tests/test_torch_train.py`` holds at this
  initialization, where one rank's own f32 gradients miss an f64 evaluation
  by up to 2e-4.
* Elastic restore: the (2, 2) run's step-2 checkpoint restored on one rank
  and on a (1, 2) mesh of two ranks continues to the uninterrupted run's
  steps 3 and 4 (losses within 1e-5); the reference's ``CheckpointManager``
  loads it too.
* The (1, 2) runs install ``host_staged_collectives`` for the CPU, so the
  host-staged functional collectives (gloo ranks sharing one card) are held
  to the same results as gloo's own.
* Serve steps: ``make_prefill_step`` on (1, 2) and (2, 2) gives the
  one-rank logits within 2e-3 (f32); ``make_decode_step`` over a cache whose
  slots are split over 'model' (``shard_caches``), teacher-forced, ends on
  the prefill's last logits (2e-3, as ``test_serve_steps_run_without_grad``).
* Launches: each rank calls K6 and K7 (their plain versions here, counted
  by a patched ``KernelWrapper.run``) as often a microbatch as one rank
  does — zamba2 smoke: 2 K6 (the shared block twice) and 16 K7 (4 SSM
  layers, 2 passes, run again by remat) — on local tensors holding pad_q /
  tp attention heads and n_heads / tp SSM heads.
* The harness: every run, the one-rank ones included, is a subprocess, so
  the test process runs no model after the fixture, and a process group
  left open in it (as ``make_production_mesh`` leaves one) changes no
  one-rank run.  When a run fails, crashes or outlasts ``RUN_TIMEOUT_S``,
  the fixture fails with each process's name, exit code or "still running",
  and log tail, stacks included (``faulthandler``).
"""

import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.parallel import sharding as ref_sharding  # noqa: E402
from repro.train import step as ref_step  # noqa: E402
from repro.train.checkpoint import CheckpointManager as RefCheckpointManager  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.train import step  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REF_ARCHS = ["tinyllama-1.1b", "zamba2-2.7b", "mixtral-8x22b", "internvl2-1b"]
PORT_ARCHS = ["tinyllama-1.1b", "zamba2-2.7b"]
F32 = dict(dtype="float32", param_dtype="float32", attn_p_dtype="float32")
GRAD_ARCHS = ["tinyllama-1.1b", "zamba2-2.7b", "mixtral-8x22b"]
RUN_TIMEOUT_S = 700


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _shape_mesh(shape, axes):
    """A mesh shape alone (what the spec functions read), for both packages."""
    return types.SimpleNamespace(shape=dict(zip(axes, shape)), axis_names=tuple(axes))


MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]


# ------------------------------------------------------------------ specs


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_logical_axes_equal_the_reference(arch):
    for tp in (1, 16):
        want = ref_model.param_logical_axes(ref_get_config(arch), tp)
        assert model.param_logical_axes(get_config(arch), tp) == want, (arch, tp)


def _ref_specs(abstract, logical, mesh, rules):
    return {jax.tree_util.keystr(k): tuple(ref_step.shape_aware_spec(a.shape, lg, mesh, rules))
            for (k, a), lg in zip(jax.tree_util.tree_flatten_with_path(abstract)[0],
                                  jax.tree.structure(abstract).flatten_up_to(logical))}


def _port_specs(tree, logical, mesh, rules, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_port_specs(tree[k], logical[k], mesh, rules, f"{prefix}['{k}']"))
        elif isinstance(tree[k], torch.Tensor):
            out[f"{prefix}['{k}']"] = tuple(step.shape_aware_spec(tuple(tree[k].shape), logical[k],
                                                                  mesh, rules))
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference(arch):
    rcfg, pcfg = ref_get_config(arch), get_config(arch)
    for shape, axes in MESHES:
        mesh, tp = _shape_mesh(shape, axes), shape[-1]
        rrules = ref_sharding.adapt_rules_for(rcfg, mesh, ref_sharding.MeshRules())
        prules = sharding.adapt_rules_for(pcfg, mesh, sharding.MeshRules())
        want = _ref_specs(ref_model.abstract_params(rcfg, tp),
                          ref_model.param_logical_axes(rcfg, tp), mesh, rrules)
        abstract = model.abstract_params(pcfg, tp)
        got = _port_specs(abstract, model.param_logical_axes(pcfg, tp), mesh, prules)
        assert got == want, (arch, shape)
        shardings = step.param_shardings(pcfg, mesh, prules, tp)
        assert shardings["embed"].spec == got["['embed']"]
        assert all(t.device.type == "meta" for t in adamw.tree_leaves(abstract))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_the_reference(arch):
    rcfg, pcfg = ref_get_config(arch), get_config(arch)
    assert step.cache_logical_axes(pcfg) == ref_step.cache_logical_axes(rcfg)
    for shape, axes in MESHES:
        mesh, tp = _shape_mesh(shape, axes), shape[-1]
        rrules = ref_sharding.adapt_rules_for(rcfg, mesh, ref_sharding.MeshRules())
        prules = sharding.adapt_rules_for(pcfg, mesh, sharding.MeshRules())
        rcache = jax.eval_shape(lambda: ref_model.make_cache(rcfg, 64, 4096, tp))
        del rcache["pos"]
        lg = dict(ref_step.cache_logical_axes(rcfg))
        del lg["pos"]
        want = _ref_specs(rcache, lg, mesh, rrules)
        pcache = model.make_cache(pcfg, 64, 4096, tp, device="meta")
        got = _port_specs(pcache, step.cache_logical_axes(pcfg), mesh, prules)
        assert got == want, (arch, shape)


# ------------------------------------------------------------- head padding


@pytest.mark.parametrize("tp", [2, 4])
def test_padded_heads_prefill_equals_the_reference(tp):
    arch = "internvl2-1b"
    rcfg = dataclasses.replace(ref_get_smoke(arch), **F32, remat=False)
    pcfg = dataclasses.replace(get_smoke(arch), **F32, remat=False)
    plan = model.head_plan(pcfg, tp)
    assert (plan.pad_q, plan.pad_kv) == {2: (14, 2), 4: (8, 2)}[tp]
    rparams = jax.tree.map(np.asarray, jax.jit(lambda k: ref_model.init_params(rcfg, k, tp))(
        jax.random.PRNGKey(5)))
    pparams = model.params_from_jax(rparams, pcfg, device="cpu", tp=tp)
    assert pparams["stacks"]["attn"]["wq"].shape[2] == plan.pad_q
    with pytest.raises(ValueError, match="expected"):
        model.params_from_jax(rparams, pcfg, device="cpu", tp=1)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, pcfg.vocab_size, (2, 12)).astype(np.int32)
    fe = pcfg.frontend
    extra = rng.standard_normal((2, fe.n_extra_tokens, fe.feature_dim)).astype(np.float32)
    want, _ = ref_model.prefill(jax.tree.map(jnp.asarray, rparams), jnp.asarray(toks), rcfg, tp,
                                extra=jnp.asarray(extra))
    got, _ = model.prefill(pparams, torch.tensor(toks).long(), pcfg, tp,
                           extra=torch.tensor(extra))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, rtol=0)


def test_placements_follow_the_spec():
    mesh = _shape_mesh((2, 2, 2), ("pod", "data", "model"))
    from torch.distributed.tensor import Replicate, Shard

    spec = sharding.PartitionSpec(("pod", "data"), None, "model")
    assert sharding.placements(spec, mesh) == [Shard(0), Shard(0), Shard(2)]
    assert sharding.placements(sharding.PartitionSpec(), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError, match="mesh's axis order"):
        sharding.placements(sharding.PartitionSpec(("data", "pod")), mesh)


# -------------------------------------------------------- the runs (fixture)

REF_CODE = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
from repro.configs import get_smoke
from repro.launch.mesh import make_host_mesh
from repro.models.config import ShapeSpec
from repro.train.checkpoint import CheckpointManager
from repro.train.loop import Trainer, TrainerConfig
root, archs = sys.argv[1], json.loads(sys.argv[2])
assert len(jax.devices()) == 4
out = {}
for arch in archs:
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32", attn_p_dtype="float32")
    tr = Trainer(cfg, ShapeSpec("t", 32, 4, "train"), make_host_mesh((2, 2), ("data", "model")),
                 f"{root}/ref/{arch}", TrainerConfig(total_steps=2, checkpoint_every=2,
                                                     log_every=1, seed=0))
    params, opt = tr.init_state()
    for d in (f"{root}/ref/{arch}/ckpt", f"{root}/port/{arch}/ckpt"):
        CheckpointManager(d).save(0, (params, opt))
    hist = tr.run()["history"]
    out[arch] = {"losses": [h["loss"] for h in hist], "grad_norms": [h["grad_norm"] for h in hist],
                 "plan": [tr.plan.accum_steps, tr.plan.microbatch, tr.plan.tp]}
with open(f"{root}/ref/results.json", "w") as f:
    json.dump(out, f)
"""

RANK_CODE = r"""
import dataclasses, faulthandler, json, os, sys, time, warnings
warnings.simplefilter("ignore")
faulthandler.dump_traceback_later(680, exit=True)          # a hung rank shows where
import numpy as np, torch, torch.distributed as dist
rank, world, root, mode = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
if mode != "one":           # one rank opens no process group
    dist.init_process_group("gloo", init_method=f"file://{root}/store_{mode}", rank=rank,
                            world_size=world)
from repro_torch.configs import get_smoke
from repro_torch.kernels import ops
from repro_torch.launch.mesh import (STAGED_TRAFFIC, ParseMesh, host_staged_collectives,
                                     make_host_mesh)
from repro_torch.models import model
from repro_torch.models.config import ShapeSpec
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.parallel import sharding
from repro_torch.train import step
from repro_torch.train.loop import Trainer, TrainerConfig

calls, heads = {}, {}
def counting(wrapper, dim):
    plain = wrapper.run
    def run(*tensors, **static):
        key = wrapper.name + ("/" + static["outputs"] if "outputs" in static else "")
        calls[key] = calls.get(key, 0) + 1
        heads.setdefault(key, set()).add(int(tensors[0].shape[dim]))
        assert all(type(t) is torch.Tensor for t in tensors if t is not None)
        return plain(*tensors, **static)
    wrapper.run = run
counting(ops.flash_attention, 2)
counting(ops.ssd_chunk, 0)

F32 = dict(dtype="float32", param_dtype="float32", attn_p_dtype="float32")
SHAPE = ShapeSpec("t", 32, 4, "train")
mesh = (make_host_mesh() if mode == "one"
        else ParseMesh((2, 2) if mode == "mesh4" else (1, 2), ("data", "model")))
out = {"rank": rank}

def train(name, cfg, workdir, steps, every, opt=None):
    calls.clear(); heads.clear()
    tr = Trainer(cfg, SHAPE, mesh, workdir, TrainerConfig(total_steps=steps, checkpoint_every=every,
                 log_every=1, seed=0), opt=opt, device="cpu")
    t0 = time.perf_counter()
    hist = tr.run()["history"]
    out[name] = {"losses": [h["loss"] for h in hist], "grad_norms": [h["grad_norm"] for h in hist],
                 "plan": [tr.plan.accum_steps, tr.plan.microbatch, tr.plan.tp],
                 "seconds": time.perf_counter() - t0,
                 "calls": dict(calls), "heads": {k: sorted(v) for k, v in heads.items()}}

def grads_one(arch):
    # one microbatch's gradients on one rank
    cfg = dataclasses.replace(get_smoke(arch), **F32)
    params = model.init_params(cfg, seed=3, device="cpu")
    toks = torch.tensor(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 32))).long()
    live = tree_map(lambda p: p.requires_grad_(True), params)
    total, _ = model.forward_train(live, {"tokens": toks}, cfg)
    got = torch.autograd.grad(total, tree_leaves(live))
    np.savez(f"{root}/one_grads_{arch}.npz", loss=total.detach().numpy(), *[g.numpy() for g in got])

def serve_one():
    cfg = dataclasses.replace(get_smoke("tinyllama-1.1b"), **F32)
    params = model.init_params(cfg, seed=1, device="cpu")
    toks = torch.tensor(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 6))).long()
    logits, _ = step.make_prefill_step(cfg, mesh, sharding.MeshRules())(params, toks)
    out["serve"] = logits.tolist()

def grads(arch):
    # one microbatch's gradients, gathered whole (rank 0 writes them)
    cfg = dataclasses.replace(get_smoke(arch), **F32)
    rules = sharding.adapt_rules_for(cfg, mesh, sharding.MeshRules())
    tp = mesh.shape["model"]
    params = step.shard_params(model.init_params(cfg, seed=3, device="cpu", tp=tp), mesh, rules,
                               cfg, tp)
    specs = tree_leaves(step.param_shardings(cfg, mesh, rules, tp))
    toks = torch.tensor(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 32))).long()
    with step.spmd(mesh):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        batch = {"tokens": step.make_shard_fn(mesh, rules)(toks, ("batch", None))}
        total, _ = model.forward_train(live, batch, cfg, tp, step.make_shard_fn(mesh, rules))
        got = torch.autograd.grad(total, tree_leaves(live))
        got = [step.whole(step.place_tree(g, sh)).detach().numpy() for g, sh in zip(got, specs)]
        loss = step.whole(total).detach().numpy()
    if rank == 0:
        np.savez(f"{root}/grads_{arch}.npz", loss=loss, *got)

def places(t):
    return [p.dim if p.is_shard() else None for p in t.placements]

def serve(name):
    cfg = dataclasses.replace(get_smoke("tinyllama-1.1b"), **F32)
    rules = sharding.adapt_rules_for(cfg, mesh, sharding.MeshRules())
    tp = mesh.shape["model"]
    params = step.shard_params(model.init_params(cfg, seed=1, device="cpu", tp=tp), mesh, rules,
                               cfg, tp)
    toks = torch.tensor(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 6))).long()
    logits, _ = step.make_prefill_step(cfg, mesh, rules, tp)(params, toks)
    caches = step.shard_caches(model.make_cache(cfg, 2, 8, tp, device="cpu"), cfg, mesh, rules)
    dec = step.make_decode_step(cfg, mesh, rules, tp)
    for t in range(6):
        last, caches = dec(params, caches, toks[:, t:t + 1])
    x = torch.arange(24.0).reshape(4, 6)
    placed = sharding.constrain(x, mesh, rules, ("batch", "embed"))
    out[name] = {"prefill": logits.full_tensor().tolist(), "decode": last.full_tensor().tolist(),
                 "cache_k": places(caches["attn"]["k"]),
                 "cache_k_local": list(caches["attn"]["k"].to_local().shape),
                 "wq": places(params["stacks"]["attn"]["wq"]),
                 "constrain": places(placed),
                 "constrain_whole": bool(torch.equal(placed.full_tensor(), x))}

if mode == "one":
    # the one-rank runs the meshes are held against: the jobs named in argv[5]
    for job in json.loads(sys.argv[5]):
        if job == "train":
            for arch in ("tinyllama-1.1b", "zamba2-2.7b"):
                train(f"f32/{arch}", dataclasses.replace(get_smoke(arch), **F32),
                      f"{root}/one_f32/{arch}", 4, 2)
                train(f"bf16/{arch}", get_smoke(arch), f"{root}/one_bf16/{arch}", 2, 0)
        elif job == "grads":
            for arch in ("tinyllama-1.1b", "zamba2-2.7b", "mixtral-8x22b"):
                grads_one(arch)
        elif job == "elastic":
            train("elastic", dataclasses.replace(get_smoke("tinyllama-1.1b"), **F32),
                  f"{root}/el1", 4, 0)
        else:
            assert job == "serve", job
            serve_one()
elif mode == "mesh4":
    for arch in ("tinyllama-1.1b", "zamba2-2.7b"):
        cfg = dataclasses.replace(get_smoke(arch), **F32)
        train(f"f32/{arch}", cfg, f"{root}/f32/{arch}", 4, 2)
        train(f"bf16/{arch}", get_smoke(arch), f"{root}/bf16/{arch}", 2, 0)
    for arch in ("tinyllama-1.1b", "zamba2-2.7b", "mixtral-8x22b"):
        grads(arch)
    serve("serve")
    deadline = time.monotonic() + 600
    while not os.path.exists(f"{root}/ref/results.json"):
        assert time.monotonic() < deadline, "the reference's run never finished"
        time.sleep(0.5)
    for arch in json.loads(sys.argv[5]):
        cfg = dataclasses.replace(get_smoke(arch), dtype="float32", attn_p_dtype="float32")
        train(f"ref/{arch}", cfg, f"{root}/port/{arch}", 2, 2)
else:
    # the (1, 2) runs go through the host-staged collectives (installed for the CPU here)
    host_staged_collectives("CPU")
    cfg = dataclasses.replace(get_smoke("tinyllama-1.1b"), **F32)
    train("elastic", cfg, f"{root}/el12", 4, 0)
    serve("serve")
    out["staged"] = STAGED_TRAFFIC
tag = "one_" + "_".join(json.loads(sys.argv[5])) if mode == "one" else f"{mode}_rank{rank}"
with open(f"{root}/{tag}.json", "w") as f:
    json.dump(out, f)
if dist.is_initialized():
    dist.destroy_process_group()
"""


# every subprocess writes its threads' stacks into its log when it crashes,
# and on SIGUSR1, which ``_finish`` sends to those still running when it
# gives up on them
DUMP_STACKS = ("import faulthandler, signal; "
               "faulthandler.enable(); faulthandler.register(signal.SIGUSR1)\n")


def _start(code, log, *args, name):
    """A subprocess ``name`` running ``code`` with ``args``, its output into
    ``log``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    with open(log, "w") as out:
        proc = subprocess.Popen([sys.executable, "-c", DUMP_STACKS + code, *map(str, args)],
                                env=env, stdout=out, stderr=subprocess.STDOUT)
    proc.log, proc.name = Path(log), name
    return proc


def _finish(procs, what, timeout_s=RUN_TIMEOUT_S):
    """Wait for every process.  When one fails, or ``timeout_s`` runs out,
    dump the stacks of those still running, kill them, and fail with every
    process's name, exit code (or that it was still running) and log tail,
    the failed ones first."""
    deadline = time.monotonic() + timeout_s
    try:
        while True:
            codes = [proc.poll() for proc in procs]
            if any(code not in (None, 0) for code in codes):
                raise AssertionError(_report(procs, f"{what}: a process failed"))
            if None not in codes:
                return
            if time.monotonic() >= deadline:
                raise AssertionError(_report(procs, f"{what}: timed out after {timeout_s} s"))
            time.sleep(0.2)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _report(procs, headline, tail=4000):
    """``headline``, then each process's state and the tail of its log;
    those still running first dump their stacks there (SIGUSR1) and are
    killed."""
    running = [proc for proc in procs if proc.poll() is None]
    for proc in running:
        proc.send_signal(signal.SIGUSR1)
    if running:
        time.sleep(1.0)
    for proc in running:
        proc.kill()
        proc.wait()
    order = sorted(procs, key=lambda p: (p in running, p.returncode == 0))
    parts = [headline]
    for proc in order:
        state = ("still running (stacks dumped, then killed)" if proc in running
                 else f"exit code {proc.returncode}")
        text = proc.log.read_text(errors="replace") if proc.log.exists() else "(no log)"
        parts.append(f"--- {proc.name}: {state}; {proc.log}, last {tail} bytes:\n{text[-tail:]}")
    return "\n".join(parts)


def _one_rank(root, jobs):
    """The one-rank runs ``jobs`` (``RANK_CODE``'s mode "one") in a process of
    their own, which opens no process group, whatever this one has open."""
    return _start(RANK_CODE, root / f"one_{'_'.join(jobs)}.log", 0, 1, root, "one",
                  json.dumps(jobs), name=f"one rank ({', '.join(jobs)})")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every multi-rank run, and the one-rank runs it is held against, each
    in a subprocess: this process runs no model, it waits and reads."""
    root = tmp_path_factory.mktemp("mesh")
    t0 = time.perf_counter()
    ref = _start(REF_CODE, root / "ref.log", root, json.dumps(REF_ARCHS), name="reference")
    ranks = [_start(RANK_CODE, root / f"mesh4_{r}.log", r, 4, root, "mesh4", json.dumps(REF_ARCHS),
                    name=f"mesh4 rank {r}") for r in range(4)]
    _finish([ref, *ranks, _one_rank(root, ["train", "grads"])], "4-rank / reference / one rank")
    # elastic restore: the (2, 2) run's step-2 checkpoint, on one rank and on (1, 2)
    ck = root / "f32" / "tinyllama-1.1b" / "ckpt" / "step_0000000002"
    for d in ("el1", "el12"):
        shutil.copytree(ck, root / d / "ckpt" / ck.name)
    pair = [_start(RANK_CODE, root / f"mesh2_{r}.log", r, 2, root, "mesh2", name=f"mesh2 rank {r}")
            for r in range(2)]
    _finish([*pair, _one_rank(root, ["elastic", "serve"])], "(1, 2) mesh / one rank")
    load = lambda p: json.loads(p.read_text())  # noqa: E731
    one = {**load(root / "one_train_grads.json"), **load(root / "one_elastic_serve.json")}
    one["serve"] = np.array(one["serve"])
    return types.SimpleNamespace(
        root=root, one=one, ref=load(root / "ref" / "results.json"),
        mesh4=[load(root / f"mesh4_rank{r}.json") for r in range(4)],
        mesh2=[load(root / f"mesh2_rank{r}.json") for r in range(2)],
        seconds=time.perf_counter() - t0)


def _checkpoint(path):
    """{leaf index: float32 array} and dtypes of a checkpoint directory."""
    manifest = json.loads((path / "manifest.json").read_text())
    with np.load(path / "arrays.npz") as data:
        arrays = {}
        for i, dt in enumerate(manifest["dtypes"]):
            a = data[f"leaf_{i}"]
            arrays[i] = ((a.astype(np.uint32) << 16).view(np.float32) if dt == "bfloat16"
                         else a.astype(np.float32))
    return arrays, manifest


def _same_params(got_dir, want_dir):
    got, gm = _checkpoint(got_dir)
    want, wm = _checkpoint(want_dir)
    assert gm["shapes"] == wm["shapes"] and gm["dtypes"] == wm["dtypes"]
    n_params = (len(got) - 1) // 4             # (params, OptState(step, master, m, v))
    for i in list(range(n_params)) + list(range(n_params + 1, 2 * n_params + 1)):
        rtol = 2 ** -7 if gm["dtypes"][i] == "bfloat16" else 1e-3
        np.testing.assert_allclose(got[i], want[i], rtol=rtol, atol=2e-5, err_msg=f"leaf {i}")
    assert int(got[n_params]) == int(want[n_params])


def _wait_for(log, text):
    deadline = time.monotonic() + 60
    while text not in (log.read_text() if log.exists() else ""):
        assert time.monotonic() < deadline, f"{log} never printed {text!r}"
        time.sleep(0.05)


SLEEPER = "import time\nprint('{}', flush=True)\ntime.sleep(600)\n"
FAULTS = {"exit 3": "import sys\nprint('rank 1 breaks', flush=True)\nsys.exit(3)\n",
          "segfault": "import ctypes\nprint('rank 1 breaks', flush=True)\nctypes.string_at(0)\n"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_finish_names_the_failed_process_with_its_log(tmp_path, fault):
    ref = _start(SLEEPER.format("reference at step 1"), tmp_path / "ref.log", name="reference")
    _wait_for(ref.log, "step 1")
    rank = _start(FAULTS[fault], tmp_path / "r1.log", name="mesh4 rank 1")
    with pytest.raises(AssertionError) as err:
        _finish([ref, rank], "4-rank / reference")
    msg = str(err.value)
    code = {"exit 3": 3, "segfault": -signal.SIGSEGV}[fault]
    assert msg.startswith("4-rank / reference: a process failed")
    assert msg.index(f"mesh4 rank 1: exit code {code}") < msg.index("reference: still running")
    assert "rank 1 breaks" in msg and "reference at step 1" in msg
    assert "most recent call first" in msg                 # the running one's stack
    if fault == "segfault":                                # and the crashed one's
        assert "Segmentation fault" in msg and 'File "<string>", line 4 in <module>' in msg
    assert ref.poll() is not None


def test_finish_names_a_hung_process_and_where_it_hung(tmp_path):
    hung = _start(SLEEPER.format("rank 0 at step 3"), tmp_path / "r0.log", name="mesh2 rank 0")
    _wait_for(hung.log, "step 3")
    with pytest.raises(AssertionError) as err:
        _finish([hung], "(1, 2) mesh", timeout_s=1)
    msg = str(err.value)
    assert msg.startswith("(1, 2) mesh: timed out after 1 s")
    assert "mesh2 rank 0: still running" in msg and "rank 0 at step 3" in msg
    assert 'File "<string>", line 4 in <module>' in msg    # the sleep, after DUMP_STACKS
    assert hung.poll() is not None


def test_one_rank_runs_hold_with_a_process_group_left_open(tmp_path):
    """A process group left open in this process (``make_production_mesh``
    leaves its fake one of 256 ranks) makes ``make_host_mesh`` raise here;
    the fixture's one-rank runs read none of it, in a process of their own."""
    import torch.distributed as dist

    make_production_mesh()
    try:
        with pytest.raises(ValueError, match="process group of 256"):
            make_host_mesh()
        _finish([_one_rank(tmp_path, ["serve"])], "one rank")
    finally:
        dist.destroy_process_group()
    got = json.loads((tmp_path / "one_serve.json").read_text())["serve"]
    cfg = dataclasses.replace(get_smoke("tinyllama-1.1b"), **F32)
    params = model.init_params(cfg, seed=1, device="cpu")
    toks = torch.tensor(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 6))).long()
    want, _ = step.make_prefill_step(cfg, make_host_mesh(), sharding.MeshRules())(params, toks)
    np.testing.assert_array_equal(np.array(got, np.float32), want.numpy())


# ------------------------------------------------------- 4 ranks, (2, 2)


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_mesh_trainer_equals_the_reference(runs, arch):
    want = runs.ref[arch]
    for rep in runs.mesh4:
        got = rep[f"ref/{arch}"]
        assert got["plan"] == want["plan"] == [2, 2, 2]
        np.testing.assert_allclose(got["losses"], want["losses"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(got["grad_norms"], want["grad_norms"], rtol=1e-3)
    step2 = "ckpt/step_0000000002"
    _same_params(runs.root / "port" / arch / step2, runs.root / "ref" / arch / step2)


@pytest.mark.parametrize("arch", PORT_ARCHS)
def test_mesh_trainer_equals_one_rank(runs, arch):
    want = runs.one[f"f32/{arch}"]
    for rep in runs.mesh4:
        got = rep[f"f32/{arch}"]
        assert got["plan"] == [2, 2, 2]
        np.testing.assert_allclose(got["losses"], want["losses"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(got["grad_norms"], want["grad_norms"], rtol=1e-3)
    step2 = "ckpt/step_0000000002"
    _same_params(runs.root / "f32" / arch / step2, runs.root / "one_f32" / arch / step2)


@pytest.mark.parametrize("arch", PORT_ARCHS)
def test_mesh_trainer_bf16_is_close_to_one_rank(runs, arch):
    want = runs.one[f"bf16/{arch}"]
    for rep in runs.mesh4:
        np.testing.assert_allclose(rep[f"bf16/{arch}"]["losses"], want["losses"], atol=2e-2,
                                   rtol=0)


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_mesh_gradients_equal_one_rank(runs, arch):
    n_leaves = len(adamw.tree_leaves(model.abstract_params(get_smoke(arch), 1)))
    with np.load(runs.root / f"grads_{arch}.npz") as got, \
            np.load(runs.root / f"one_grads_{arch}.npz") as want:
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-6)
        assert len(got.files) == len(want.files) == n_leaves + 1
        for i in range(n_leaves):
            g, w = got[f"arr_{i}"], want[f"arr_{i}"]
            assert g.shape == w.shape, i
            rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
            assert rel <= 1e-3, (arch, i, rel)
            assert np.abs(g).max() > 0 or np.abs(w).max() == 0, i


@pytest.mark.parametrize("where", ["one rank", "(1, 2)"])
def test_elastic_restore_continues_the_trajectory(runs, where):
    want = runs.mesh4[0]["f32/tinyllama-1.1b"]["losses"][2:]
    got = ([runs.one["elastic"]["losses"]] if where == "one rank"
           else [rep["elastic"]["losses"] for rep in runs.mesh2])
    for losses in got:
        np.testing.assert_allclose(losses, want, atol=1e-5, rtol=0)


def test_mesh_checkpoint_loads_in_the_reference(runs):
    path = runs.root / "f32" / "tinyllama-1.1b" / "ckpt"
    arrays, manifest = _checkpoint(path / "step_0000000002")
    cfg = dataclasses.replace(ref_get_smoke("tinyllama-1.1b"), **F32)
    from repro.optim.adamw import init_opt_state

    params = ref_model.init_params(cfg, jax.random.PRNGKey(0))
    like = (params, init_opt_state(params))
    step_, (rparams, ropt), _ = RefCheckpointManager(path).restore(like, step=2)
    assert step_ == 2 and int(ropt.step) == 2
    for i, leaf in enumerate(jax.tree.leaves(rparams)):
        np.testing.assert_array_equal(np.asarray(leaf), arrays[i])


@pytest.mark.parametrize("mode", ["mesh2", "mesh4"])
def test_mesh_serve_steps_equal_one_rank(runs, mode):
    want = runs.one["serve"]
    for rep in getattr(runs, mode):
        if mode == "mesh2":       # every collective went through the host-staged ops
            assert {"all_gather_into_tensor", "all_reduce"} <= set(rep["staged"])
        s = rep["serve"]
        np.testing.assert_allclose(np.array(s["prefill"]), want, atol=2e-3, rtol=0)
        np.testing.assert_allclose(np.array(s["decode"]), want, atol=2e-3, rtol=0)
        split = mode == "mesh4"                                  # a 'data' axis of 1 splits nothing
        assert s["cache_k"] == [1 if split else None, 2]         # batch over 'data', slots 'model'
        assert s["cache_k_local"][2] == 8 // 2                   # 4 of 8 slots
        assert s["wq"] == [1 if split else None, 2]              # fsdp, heads
        assert s["constrain"] == [0 if split else None, None] and s["constrain_whole"]


def test_mesh_launches_per_rank_equal_one_rank(runs):
    cfg = get_smoke("zamba2-2.7b")
    n_ssm, n_shared = cfg.layer_kinds.count("ssm"), cfg.n_layers // cfg.shared_attn_every
    per_micro = {"flash_attention": n_shared, "ssd_chunk/state": 2 * n_ssm,
                 "ssd_chunk/y": 2 * n_ssm}                             # remat runs SSD twice
    assert per_micro == {"flash_attention": 2, "ssd_chunk/state": 8, "ssd_chunk/y": 8}
    from repro_torch.models.mamba import ssm_dims

    nh = ssm_dims(cfg.d_model, cfg.ssm)["n_heads"]
    for rep in runs.mesh4:
        run = rep["bf16/zamba2-2.7b"]
        n_micro = 2 * run["plan"][0]                                   # 2 steps
        assert run["calls"] == {k: v * n_micro for k, v in per_micro.items()}
        assert run["heads"]["flash_attention"] == [model.shared_attn_plan(cfg, 2).pad_q // 2]
        # K7's programs: local batch rows (1) x chunks x local heads
        nc = 32 // cfg.ssm.chunk
        assert run["heads"]["ssd_chunk/state"] == [1 * nc * nh // 2]
