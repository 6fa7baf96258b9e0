"""repro_torch's ``Trainer`` end to end on the CPU, and its checkpoints.

The port of the reference's ``tests/test_train_e2e.py`` with the same
configs and bounds (loss decreases; crash → resume matches within 1e-4; the
hybrid and the MoE configs train), on ``device="cpu"``; the checkpoint
manager's own cases (``tests/test_checkpoint.py``); and checkpoints crossing
packages: one written by the reference's ``CheckpointManager`` (its
``Trainer``) restores in the port's, and the next step's loss equals the
reference's within 1e-4, and the other way round.  The cross-package runs
compute in f32 (tinyllama smoke), so both packages compute one function,
with bf16 params (the reference's ``Trainer`` donates the params and its f32
masters, which must then be separate buffers); a bf16 tree round-trips bit
for bit both ways.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.launch.mesh import make_host_mesh as ref_host_mesh  # noqa: E402
from repro.models.config import ShapeSpec as RefShapeSpec  # noqa: E402
from repro.train.checkpoint import CheckpointManager as RefCheckpointManager  # noqa: E402
from repro.train.loop import Trainer as RefTrainer  # noqa: E402
from repro.train.loop import TrainerConfig as RefTrainerConfig  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models.config import ShapeSpec  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.loop import Trainer, TrainerConfig  # noqa: E402

SHAPE = ShapeSpec("tiny_train", seq_len=32, global_batch=4, kind="train")
F32_COMPUTE = dict(dtype="float32", attn_p_dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensor ops: under a parallel test run every worker's intra-op
    thread pool competes for the same cores, so this module runs one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mesh():
    return make_host_mesh()


# --------------------------------------------- the reference's e2e cases


def test_loss_decreases(mesh, tmp_path):
    cfg = get_smoke("tinyllama-1.1b")
    t = Trainer(cfg, SHAPE, mesh, tmp_path,
                TrainerConfig(total_steps=12, checkpoint_every=100, log_every=4),
                opt=AdamWConfig(lr_peak=5e-3, warmup_steps=2, total_steps=12), device="cpu")
    r = t.run()
    losses = [h["loss"] for h in r["history"]]
    assert all(np.isfinite(l) for l in losses)
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    logged = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [rec["step"] for rec in logged] == [1, 4, 8, 12]


def test_crash_resume_exact_trajectory(mesh, tmp_path):
    cfg = get_smoke("tinyllama-1.1b")
    a = Trainer(cfg, SHAPE, mesh, tmp_path / "a",
                TrainerConfig(total_steps=6, checkpoint_every=3, log_every=1), device="cpu")
    ra = a.run()

    b1 = Trainer(cfg, SHAPE, mesh, tmp_path / "b",
                 TrainerConfig(total_steps=6, checkpoint_every=3, log_every=1,
                               fail_at_step=4), device="cpu")
    with pytest.raises(RuntimeError, match="injected failure"):
        b1.run()
    b2 = Trainer(cfg, SHAPE, mesh, tmp_path / "b",
                 TrainerConfig(total_steps=6, checkpoint_every=3, log_every=1), device="cpu")
    rb = b2.run()
    assert [h["step"] for h in rb["history"]] == [4, 5, 6]      # resumed from step 3
    assert abs(ra["final_loss"] - rb["final_loss"]) < 1e-4


def test_hybrid_arch_trains(mesh, tmp_path):
    cfg = get_smoke("zamba2-2.7b")
    t = Trainer(cfg, ShapeSpec("t", seq_len=16, global_batch=2, kind="train"),
                mesh, tmp_path, TrainerConfig(total_steps=3, checkpoint_every=100),
                device="cpu")
    r = t.run()
    assert np.isfinite(r["final_loss"])


def test_moe_arch_trains(mesh, tmp_path):
    cfg = get_smoke("mixtral-8x22b")
    t = Trainer(cfg, ShapeSpec("t", seq_len=16, global_batch=2, kind="train"),
                mesh, tmp_path, TrainerConfig(total_steps=3, checkpoint_every=100),
                device="cpu")
    r = t.run()
    assert np.isfinite(r["final_loss"])


def test_no_checkpoint_when_every_is_zero(mesh, tmp_path):
    t = Trainer(get_smoke("tinyllama-1.1b"), ShapeSpec("t", 16, 2, "train"), mesh, tmp_path,
                TrainerConfig(total_steps=2, checkpoint_every=0), device="cpu")
    t.run()
    assert t.ckpt.all_steps() == []


def test_trainer_defaults_to_the_card(mesh, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(get_smoke("tinyllama-1.1b"), SHAPE, mesh, tmp_path)


def test_device_batch_equals_the_reference(mesh, tmp_path):
    """Tokens reshaped to (accum, microbatch, seq), and a frontend config's
    zero ``extra``, as the reference's ``device_batch`` gives them."""
    arch = "internvl2-1b"
    shape = dict(name="t", seq_len=16, global_batch=2, kind="train")
    ref = RefTrainer(ref_get_smoke(arch), RefShapeSpec(**shape), ref_host_mesh(),
                     tmp_path / "r", RefTrainerConfig(total_steps=1))
    port = Trainer(get_smoke(arch), ShapeSpec(**shape), mesh, tmp_path / "p",
                   TrainerConfig(total_steps=1), device="cpu")
    want, got = ref.device_batch(3), port.device_batch(3)
    assert set(got) == set(want) == {"tokens", "extra"}
    assert np.array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    assert tuple(got["extra"].shape) == want["extra"].shape and not got["extra"].any()
    assert str(got["extra"].dtype).endswith(str(want["extra"].dtype))


# ----------------------------------------------------- checkpoint manager


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "w": torch.randn(8, 4, generator=g),
        "b16": torch.randn(4, generator=g).bfloat16(),
        "nested": {"step": torch.tensor(7, dtype=torch.int32)},
    }


def test_save_restore_roundtrip(tmp_path):
    m = CheckpointManager(tmp_path, keep=2)
    t = _tree()
    m.save(10, t, extra={"loss": 1.5})
    step, got, extra = m.restore(_tree(1))
    assert step == 10 and extra["loss"] == 1.5
    for k in ("w", "b16"):
        assert got[k].dtype == t[k].dtype and torch.equal(got[k], t[k])
    assert int(got["nested"]["step"]) == 7


def test_keep_k_gc_and_atomic_publish(tmp_path):
    m = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        m.save(s, _tree(s))
    assert m.all_steps() == [3, 4]
    (tmp_path / "step_0000000009.tmp").mkdir()                 # a crash mid-write
    (tmp_path / "step_0000000009.tmp" / "garbage").write_text("x")
    assert m.latest_step() == 4 and m.restore(_tree())[0] == 4


def test_restore_shape_mismatch_raises(tmp_path):
    m = CheckpointManager(tmp_path)
    m.save(1, {"w": torch.zeros(4, 4)})
    with pytest.raises(ValueError):
        m.restore({"w": torch.zeros(8, 4)})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore({"w": torch.zeros(4, 4)})


def test_async_save_snapshots_before_returning(tmp_path):
    m = CheckpointManager(tmp_path)
    t = _tree()
    want = t["w"].clone()
    m.async_save(5, t)
    t["w"].add_(1.0)                                           # updated in place after the call
    m.wait()
    assert torch.equal(m.restore(_tree())[1]["w"], want)


def test_bf16_trees_cross_packages_bit_for_bit(tmp_path):
    port_tree = _tree(3)
    CheckpointManager(tmp_path / "p").save(1, port_tree)
    like = {"w": jnp.zeros((8, 4)), "b16": jnp.zeros((4,), jnp.bfloat16),
            "nested": {"step": jnp.int32(0)}}
    _, got, _ = RefCheckpointManager(tmp_path / "p").restore(like)
    assert str(got["b16"].dtype) == "bfloat16"
    assert np.array_equal(np.asarray(got["b16"]).view(np.uint16),
                          port_tree["b16"].view(torch.int16).numpy().view(np.uint16))
    assert np.array_equal(np.asarray(got["w"]), port_tree["w"].numpy())

    ref_tree = {"w": jax.random.normal(jax.random.PRNGKey(0), (8, 4)),
                "b16": jax.random.normal(jax.random.PRNGKey(1), (4,), jnp.bfloat16),
                "nested": {"step": jnp.int32(9)}}
    RefCheckpointManager(tmp_path / "r").save(2, ref_tree)
    _, got, _ = CheckpointManager(tmp_path / "r").restore(_tree())
    assert got["b16"].dtype == torch.bfloat16
    assert np.array_equal(got["b16"].view(torch.int16).numpy().view(np.uint16),
                          np.asarray(ref_tree["b16"]).view(np.uint16))
    assert np.array_equal(got["w"].numpy(), np.asarray(ref_tree["w"]))
    assert int(got["nested"]["step"]) == 9


# ----------------------------------------------- checkpoints across packages

CROSS_SHAPE = dict(name="t", seq_len=16, global_batch=2, kind="train")


def _ref_trainer(workdir, steps, every):
    cfg = dataclasses.replace(ref_get_smoke("tinyllama-1.1b"), **F32_COMPUTE)
    return RefTrainer(cfg, RefShapeSpec(**CROSS_SHAPE), ref_host_mesh(), workdir,
                      RefTrainerConfig(total_steps=steps, checkpoint_every=every, log_every=1))


def _port_trainer(workdir, steps, every):
    cfg = dataclasses.replace(get_smoke("tinyllama-1.1b"), **F32_COMPUTE)
    return Trainer(cfg, ShapeSpec(**CROSS_SHAPE), make_host_mesh(), workdir,
                   TrainerConfig(total_steps=steps, checkpoint_every=every, log_every=1),
                   device="cpu")


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    want = _ref_trainer(tmp_path / "ref", 3, 2).run()["history"]      # writes steps 2 and 3
    first = _ref_trainer(tmp_path / "cross", 2, 2).run()["history"]   # the reference stops at 2
    assert [h["loss"] for h in first] == [h["loss"] for h in want[:2]]
    got = _port_trainer(tmp_path / "cross", 3, 100).run()["history"]  # the port resumes
    assert [h["step"] for h in got] == [3]
    assert abs(got[0]["loss"] - want[2]["loss"]) < 1e-4


def test_port_checkpoint_resumes_in_the_reference(tmp_path):
    want = _port_trainer(tmp_path / "port", 3, 2).run()["history"]
    first = _port_trainer(tmp_path / "cross", 2, 2).run()["history"]
    assert [h["loss"] for h in first] == [h["loss"] for h in want[:2]]
    got = _ref_trainer(tmp_path / "cross", 3, 100).run()["history"]
    assert [h["step"] for h in got] == [3]
    assert abs(got[0]["loss"] - want[2]["loss"]) < 1e-4
