"""repro_torch's optimizer, data sources, REgen and model sharding rules on
the CPU against the reference's.

AdamW's ``apply_updates`` carries the same random tree through 5 steps in
both packages (clipping active, 1-D leaves undecayed) within rtol 1e-6 (and
atol 1e-7, one f32 ulp at the tree's scale of 1, for the elements that pass
near 0: the two packages' f32 ``pow`` and norm sums differ in the last bit), and
``lr_at`` follows the same schedule; ``SyntheticLM``, ``CorpusLM`` and
``RegexStructured`` batches and REgen's patterns and strings are equal bit
for bit; ``adapt_rules_for`` gives the reference's rules for every config.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.data import pipeline as ref_pipeline  # noqa: E402
from repro.data import regen as ref_regen  # noqa: E402
from repro.launch.mesh import make_host_mesh as ref_host_mesh  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.parallel import sharding as ref_sharding  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import regex as rx  # noqa: E402
from repro_torch.data import pipeline, regen  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402


# ------------------------------------------------------------------ AdamW


def _tree(rng, scale=1.0):
    return {
        "w": (rng.standard_normal((8, 4)) * scale).astype(np.float32),
        "b": (rng.standard_normal((4,)) * scale).astype(np.float32),
        "nested": {"k": (rng.standard_normal((3, 5, 2)) * scale).astype(np.float32),
                   "norm": (rng.standard_normal((5,)) * scale).astype(np.float32)},
    }


@pytest.mark.parametrize("clip_norm", [1.0, 1e3])
def test_apply_updates_equals_the_reference_over_five_steps(clip_norm):
    cfg = adamw.AdamWConfig(lr_peak=1e-2, warmup_steps=2, total_steps=8, weight_decay=0.1,
                            clip_norm=clip_norm)
    rcfg = ref_adamw.AdamWConfig(**vars(cfg))
    rng = np.random.default_rng(0)
    params = _tree(rng)
    rparams = jax.tree.map(jnp.asarray, params)
    rstate = ref_adamw.init_opt_state(rparams)
    pparams = adamw.tree_map(torch.tensor, params)
    pstate = adamw.init_opt_state(pparams)
    clipped = 0
    for _ in range(5):
        grads = _tree(rng, scale=3.0)       # global norm ~15: clipped at clip_norm 1
        rparams, rstate, rm = ref_adamw.apply_updates(
            rcfg, rparams, jax.tree.map(jnp.asarray, grads), rstate, jnp.float32)
        pparams, pstate, pm = adamw.apply_updates(
            cfg, pparams, adamw.tree_map(torch.tensor, grads), pstate, torch.float32)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(rm["grad_norm"]), rtol=1e-6)
        assert pm["lr"] == pytest.approx(float(rm["lr"]), rel=1e-6)
        clipped += float(rm["grad_norm"]) > clip_norm
        for name, want, got in (("master", rstate.master, pstate.master), ("m", rstate.m, pstate.m),
                                ("v", rstate.v, pstate.v), ("params", rparams, pparams)):
            for w, g in zip(jax.tree.leaves(want), adamw.tree_leaves(got)):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7,
                                           err_msg=name)
        assert int(pstate.step) == int(rstate.step)
    assert clipped == (5 if clip_norm == 1.0 else 0)


def test_one_dim_leaves_are_not_decayed():
    """With zero gradients the Adam direction is 0: only the decay moves a
    leaf, and only leaves of two or more dims."""
    cfg = adamw.AdamWConfig(lr_peak=1e-1, warmup_steps=1, weight_decay=0.5)
    params = adamw.tree_map(torch.tensor, _tree(np.random.default_rng(1)))
    before = adamw.tree_map(torch.clone, params)
    state = adamw.init_opt_state(params)
    zeros = adamw.tree_map(torch.zeros_like, params)
    params, state, _ = adamw.apply_updates(cfg, params, zeros, state, torch.float32)
    assert torch.equal(params["b"], before["b"]) and torch.equal(params["nested"]["norm"],
                                                                 before["nested"]["norm"])
    assert not torch.equal(params["w"], before["w"])
    assert not torch.equal(params["nested"]["k"], before["nested"]["k"])


def test_bf16_params_are_the_cast_masters():
    cfg = adamw.AdamWConfig(warmup_steps=1)
    rng = np.random.default_rng(2)
    params = adamw.tree_map(lambda a: torch.tensor(a).bfloat16(), _tree(rng))
    state = adamw.init_opt_state(params)
    grads = adamw.tree_map(torch.tensor, _tree(rng))
    params, state, _ = adamw.apply_updates(cfg, params, grads, state)
    for p, m in zip(adamw.tree_leaves(params), adamw.tree_leaves(state.master)):
        assert p.dtype == torch.bfloat16 and m.dtype == torch.float32
        assert torch.equal(p, m.bfloat16())


def test_lr_schedule_equals_the_reference():
    cfg = adamw.AdamWConfig(lr_peak=3e-4, lr_min=3e-5, warmup_steps=10, total_steps=50)
    rcfg = ref_adamw.AdamWConfig(**vars(cfg))
    for step in list(range(0, 60)) + [1000]:
        want = float(ref_adamw.lr_at(rcfg, jnp.int32(step)))
        assert adamw.lr_at(cfg, step) == pytest.approx(want, rel=1e-6, abs=1e-12), step


def test_global_norm_over_slices(monkeypatch):
    """A leaf larger than CHUNK is summed slice by slice: the same norm."""
    rng = np.random.default_rng(3)
    tree = {"a": torch.tensor(rng.standard_normal((64, 8)).astype(np.float32)),
            "b": torch.tensor(rng.standard_normal((7,)).astype(np.float32))}
    whole = float(adamw.global_norm(tree))
    monkeypatch.setattr(adamw, "CHUNK", 16)
    assert list(adamw._slices(tree["a"]))[0].shape == (2, 8)
    assert float(adamw.global_norm(tree)) == pytest.approx(whole, rel=1e-6)
    want = float(ref_adamw.global_norm(jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)))
    assert whole == pytest.approx(want, rel=1e-6)


# ------------------------------------------------------------------- data


@pytest.mark.parametrize("step", [0, 1, 17])
def test_synthetic_and_corpus_batches_equal_the_reference(step):
    for seed in (0, 3):
        want = ref_pipeline.SyntheticLM(vocab_size=100, seq_len=8, global_batch=4,
                                        seed=seed).batch_at(step)["tokens"]
        got = pipeline.SyntheticLM(vocab_size=100, seq_len=8, global_batch=4,
                                   seed=seed).batch_at(step)["tokens"]
        assert got.dtype == want.dtype == np.int32 and np.array_equal(got, want)
    corpus = bytes(range(256)) * 4
    want = ref_pipeline.CorpusLM(corpus=corpus, seq_len=16, global_batch=3, seed=5).batch_at(step)
    got = pipeline.CorpusLM(corpus=corpus, seq_len=16, global_batch=3, seed=5).batch_at(step)
    assert np.array_equal(got["tokens"], want["tokens"])


def test_regex_structured_equals_the_reference():
    ref = ref_pipeline.RegexStructured(pattern="(ka=(a|b)+;)+", seq_len=32, global_batch=3,
                                       seed=1)
    port = pipeline.RegexStructured(pattern="(ka=(a|b)+;)+", seq_len=32, global_batch=3,
                                    seed=1, backend="torch", device="cpu")
    for step in (0, 2):
        want, got = ref.batch_at(step), port.batch_at(step)
        assert np.array_equal(got["tokens"], want["tokens"])
        assert np.array_equal(got["spans"], want["spans"])
    assert (got["spans"][:, :, 0] >= 0).any()


def test_regex_structured_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.RegexStructured(pattern="(a|b)+", seq_len=8, global_batch=1)


def test_regen_patterns_and_strings_equal_the_reference():
    for seed in range(50):
        r_rng, p_rng = (np.random.Generator(np.random.Philox(seed)) for _ in range(2))
        r_ast, p_ast = ref_regen.random_regex(8, r_rng), regen.random_regex(8, p_rng)
        assert isinstance(p_ast, rx.Node)
        assert repr(p_ast) == repr(r_ast), seed     # frozen dataclasses: structural
        for _ in range(3):
            assert regen.sample_string(p_ast, p_rng) == ref_regen.sample_string(r_ast, r_rng)


# --------------------------------------------------------------- sharding


def _shape_mesh(shape, axes):
    """A mesh shape alone (what ``adapt_rules_for`` reads), for both packages."""
    return types.SimpleNamespace(shape=dict(zip(axes, shape)), axis_names=tuple(axes))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_adapt_rules_for_equals_the_reference(arch):
    got = sharding.adapt_rules_for(get_config(arch), make_host_mesh(), sharding.MeshRules())
    want = ref_sharding.adapt_rules_for(ref_get_config(arch), ref_host_mesh(),
                                        ref_sharding.MeshRules())
    assert got.rules == want.rules
    for shape, axes in (((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))):
        got = sharding.adapt_rules_for(get_config(arch), _shape_mesh(shape, axes),
                                       sharding.MeshRules())
        want = ref_sharding.adapt_rules_for(ref_get_config(arch), _shape_mesh(shape, axes),
                                            ref_sharding.MeshRules())
        assert got.rules == want.rules, (arch, shape)


def test_constrain_is_the_identity_on_one_rank():
    mesh, rules = make_host_mesh(), sharding.MeshRules()
    x = torch.arange(6.0).reshape(2, 3)
    assert sharding.constrain(x, mesh, rules, ("batch", "embed")) is x
    spec = sharding.logical_sharding(mesh, rules, ("batch", "embed")).spec
    assert spec == sharding.PartitionSpec("data")
