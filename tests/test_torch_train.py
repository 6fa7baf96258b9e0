"""repro_torch's training path on the CPU against the reference's.

* The autograd Functions around K6 and K7 (``ops.FlashAttention``,
  ``ops.SSDChunk``: the plain versions forward here, their recompute
  backward) pass ``torch.autograd.gradcheck`` in f64, causal, windowed and
  softcapped; ``"state"`` and ``"y"``.
* The attention logit softcap: ``prefill`` and ``decode_step`` logits equal
  the reference's within 2e-3 with ``attn_logit_softcap=30``.
* ``lm_loss``, and ``forward_train``'s loss (rtol 1e-4) and gradients on
  the seven smoke configs of the kinds (zamba2, tinyllama, mamba2, mixtral,
  llama4-scout, internvl2 with its ``extra``, musicgen), f32, remat on,
  against ``jax.grad`` of the reference.  Elementwise, every leaf within
  rtol 2e-4, atol 2e-5 (the reference's kernel-test tolerances) with the
  attention logits at unit scale: the reference's initializer gives them a
  scale that makes the f32 gradient ill-conditioned (its own f32 gradient
  misses an f64 evaluation of the same function by more than that bound, up
  to 2.7e-3 on tinyllama's embedding), so at that initialization each
  leaf's relative L2 error is held within 1e-3 instead.
* ``make_train_step`` with 2 microbatches carries the same params through 3
  steps in both packages: losses within rtol 1e-4, params within rtol 1e-3
  and atol 2e-5 (each microbatch's gradients are rounded to bf16; one that
  rounds the other way in the two packages moves its Adam step by up to
  lr·2^-8 = 4e-6 a step at lr 1e-3).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.launch.mesh import make_host_mesh as ref_host_mesh  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models.config import ShapeSpec as RefShapeSpec  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.parallel.sharding import MeshRules as RefMeshRules  # noqa: E402
from repro.train import step as ref_step  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.models.config import ShapeSpec  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel.sharding import MeshRules  # noqa: E402
from repro_torch.train import step  # noqa: E402

TRAIN_ARCHS = ["zamba2-2.7b", "tinyllama-1.1b", "mamba2-2.7b", "mixtral-8x22b",
               "llama4-scout-17b-a16e", "internvl2-1b", "musicgen-medium"]
F32 = dict(dtype="float32", param_dtype="float32", attn_p_dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensor ops: under a parallel test run every worker's intra-op
    thread pool competes for the same cores, so this module runs one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _f32(cfg):
    return dataclasses.replace(cfg, **F32)


def _tokens(cfg, b, L, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, L)).astype(np.int32)


def _ref_init(cfg, seed):
    return jax.tree.map(np.asarray, jax.jit(lambda k: ref_model.init_params(cfg, k))(
        jax.random.PRNGKey(seed)))


def _unit_scale_attention(tree, d_model):
    """The same weights with every wq and wk scaled by sqrt(heads / d_model):
    q·k/sqrt(hd) then has unit scale (the reference's ``scaled`` initializer
    divides by sqrt(heads), the penultimate axis, not by the fan-in d_model)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _unit_scale_attention(v, d_model)
        elif k in ("wq", "wk"):
            out[k] = (v * np.sqrt(v.shape[-2] / d_model)).astype(v.dtype)
        else:
            out[k] = v
    return out


# ------------------------------------------------------- autograd Functions


def _f64(*shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g, dtype=torch.float64, requires_grad=True)


@pytest.mark.parametrize("static", [dict(causal=True), dict(causal=True, window=3),
                                    dict(causal=True, softcap=2.0),
                                    dict(causal=False, window=2, softcap=0.5)],
                         ids=["causal", "window", "softcap", "window-softcap"])
def test_flash_attention_function_gradcheck(static):
    q, k, v = (_f64(1, 7, 2, 4, seed=s) for s in range(3))
    out = ops.flash_attention(q, k, v, **static)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert torch.autograd.gradcheck(lambda a, b, c: ops.flash_attention(a, b, c, **static),
                                    (q, k, v))


@pytest.mark.parametrize("outputs", ["state", "y", "both"])
def test_ssd_chunk_function_gradcheck(outputs):
    P, q, hp, n = 2, 5, 3, 2
    xdt, B, C = _f64(P, q, hp, seed=0), _f64(P, q, n, seed=1), _f64(P, q, n, seed=2)
    cs = torch.cumsum(-torch.rand(P, q, 1, dtype=torch.float64,
                                  generator=torch.Generator().manual_seed(3)), 1)
    cs.requires_grad_(True)
    S = _f64(P, hp, n, seed=4)
    if outputs == "state":
        fn, args = (lambda a, b, c, d: ops.ssd_chunk(a, b, c, d, None, outputs="state")[1],
                    (xdt, cs, B, C))
    else:
        pick = (lambda o: o[0]) if outputs == "y" else (lambda o: o)
        fn, args = (lambda a, b, c, d, e: pick(ops.ssd_chunk(a, b, c, d, e, outputs=outputs)),
                    (xdt, cs, B, C, S))
    got = ops.ssd_chunk(xdt, cs, B, C, S if outputs != "state" else None, outputs=outputs)
    assert type(next(t for t in got if t is not None).grad_fn).__name__ == "SSDChunkBackward"
    assert torch.autograd.gradcheck(fn, args)


def test_ssd_backward_is_finite_under_steep_decay():
    """exp(cs_i − cs_j) above the diagonal overflows f32 under a steep decay;
    the plain version masks before the exponential, so its recomputed
    gradients stay finite (a mask after it would give 0 · inf = NaN)."""
    P, q, hp, n = 2, 16, 4, 4
    g = torch.Generator().manual_seed(0)
    xdt, B, C = (torch.randn(P, q, k, generator=g, requires_grad=True) for k in (hp, n, n))
    cs = torch.cumsum(-torch.rand(P, q, 1, generator=g) * 50, 1).requires_grad_(True)
    S = torch.randn(P, hp, n, generator=g, requires_grad=True)
    assert float((cs[:, 0] - cs[:, -1]).min()) > 89        # exp of it is inf in f32
    y, _ = ops.ssd_chunk(xdt, cs, B, C, S, outputs="y")
    y.sum().backward()
    assert all(torch.isfinite(t.grad).all() for t in (xdt, cs, B, C, S))


def test_no_grad_keeps_the_plain_call():
    q = torch.randn(1, 4, 2, 8, requires_grad=True)
    with torch.no_grad():
        assert ops.flash_attention(q, q, q).grad_fn is None
    assert ops.flash_attention(q.detach(), q.detach(), q.detach()).grad_fn is None
    with pytest.raises(TypeError, match="unexpected"):
        ops.flash_attention(q, q, q, outputs="y")


# ---------------------------------------------------------------- softcap


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "zamba2-2.7b"])
def test_softcap_prefill_and_decode_equal_the_reference(arch):
    rcfg = dataclasses.replace(_f32(ref_get_smoke(arch)), attn_logit_softcap=30.0)
    pcfg = dataclasses.replace(_f32(get_smoke(arch)), attn_logit_softcap=30.0)
    rparams = _ref_init(rcfg, 11)
    pparams = model.params_from_jax(rparams, pcfg, device="cpu")
    toks = _tokens(rcfg, 2, 12, seed=5)
    want, _ = jax.jit(lambda p, t: ref_model.prefill(p, t, rcfg))(rparams, jnp.asarray(toks))
    with torch.no_grad():
        got, _ = model.prefill(pparams, torch.tensor(toks).long(), pcfg)
    assert np.abs(got.numpy() - np.asarray(want)).max() < 2e-3
    plain = dataclasses.replace(pcfg, attn_logit_softcap=None)
    with torch.no_grad():
        uncapped, _ = model.prefill(pparams, torch.tensor(toks).long(), plain)
    assert np.abs(uncapped.numpy() - got.numpy()).max() > 1e-3      # the cap bites
    step_fn = jax.jit(lambda p, c, t: ref_model.decode_step(p, c, t, rcfg))
    rc, pc = ref_model.make_cache(rcfg, 2, 16), model.make_cache(pcfg, 2, 16, device="cpu")
    for t in range(6):
        want, rc = step_fn(rparams, rc, jnp.asarray(toks[:, t : t + 1]))
        with torch.no_grad():
            got, pc = model.decode_step(pparams, pc, torch.tensor(toks[:, t : t + 1]).long(),
                                        pcfg)
        assert np.abs(got.numpy() - np.asarray(want)).max() < 2e-3, t


# ------------------------------------------------------ loss and gradients


def test_lm_loss_equals_the_reference():
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((2, 5, 11)) * 3).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    labels[0, 1] = labels[1, 4] = -1
    want, wn = ref_model.lm_loss(jnp.asarray(logits), jnp.asarray(labels))
    got, n = model.lm_loss(torch.tensor(logits), torch.tensor(labels))
    assert float(n) == float(wn) == 8
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    none = torch.full((2, 5), -1)
    assert float(model.lm_loss(torch.tensor(logits), none)[0]) == 0.0


def _batches(cfg, b=2, L=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, L)).astype(np.int32)
    ref, port = {"tokens": jnp.asarray(toks)}, {"tokens": torch.tensor(toks).long()}
    if cfg.frontend is not None:
        fe = cfg.frontend
        extra = rng.standard_normal((b, fe.n_extra_tokens, fe.feature_dim)).astype(np.float32)
        ref["extra"], port["extra"] = jnp.asarray(extra), torch.tensor(extra)
    return ref, port


def _both_grads(rcfg, pcfg, rparams, rbatch, pbatch):
    (rtotal, rmetrics), rgrads = jax.jit(jax.value_and_grad(
        lambda p, b: ref_model.forward_train(p, b, rcfg), has_aux=True))(
        jax.tree.map(jnp.asarray, rparams), rbatch)
    live = adamw.tree_map(lambda t: t.requires_grad_(True),
                          model.params_from_jax(rparams, pcfg, device="cpu"))
    ops.reset_launches()
    total, metrics = model.forward_train(live, pbatch, pcfg)
    grads = torch.autograd.grad(total, adamw.tree_leaves(live))
    assert ops.flash_attention.launches == 0 and ops.ssd_chunk.launches == 0   # CPU: plain
    paths = [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_flatten_with_path(rgrads)[0]]
    return (float(rtotal), rmetrics, jax.tree.leaves(rgrads)), \
        (float(total.detach()), metrics, grads), paths


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_forward_train_loss_and_grads_equal_jax_grad(arch):
    rcfg, pcfg = _f32(ref_get_smoke(arch)), _f32(get_smoke(arch))
    assert rcfg.remat and pcfg.remat
    rbatch, pbatch = _batches(rcfg, seed=1)
    init = _ref_init(rcfg, 3)

    # the reference's initialization: losses, and each leaf's relative L2 error
    (rl, rm, rg), (pl, pm, pg), paths = _both_grads(rcfg, pcfg, init, rbatch, pbatch)
    np.testing.assert_allclose(pl, rl, rtol=1e-4)
    for key in ("loss", "moe_lb_loss", "moe_z_loss", "n_tokens"):
        np.testing.assert_allclose(float(pm[key]), float(rm[key]), rtol=1e-4, atol=1e-7,
                                   err_msg=key)
    for path, want, got in zip(paths, rg, pg):
        want, got = np.asarray(want), got.numpy()
        assert got.shape == want.shape, path
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert rel <= 1e-3, (arch, path, rel)

    # unit-scale attention logits: every element within the kernel tolerances
    unit = _unit_scale_attention(init, rcfg.d_model)
    (rl, _, rg), (pl, _, pg), paths = _both_grads(rcfg, pcfg, unit, rbatch, pbatch)
    np.testing.assert_allclose(pl, rl, rtol=1e-4)
    for path, want, got in zip(paths, rg, pg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5,
                                   err_msg=f"{arch} {path}")
        assert np.abs(got.numpy()).max() > 0, path            # every leaf has a gradient


# ------------------------------------------------------------- train step


def test_train_step_with_two_microbatches_equals_the_reference():
    arch = "tinyllama-1.1b"
    rcfg, pcfg = _f32(ref_get_smoke(arch)), _f32(get_smoke(arch))
    shape = dict(name="t", seq_len=16, global_batch=4, kind="train")
    opt = dict(lr_peak=1e-3, warmup_steps=1, total_steps=10)
    rplan = dataclasses.replace(
        ref_step.plan_for(rcfg, RefShapeSpec(**shape), ref_host_mesh(),
                          ref_adamw.AdamWConfig(**opt)), accum_steps=2, microbatch=2)
    pplan = dataclasses.replace(
        step.plan_for(pcfg, ShapeSpec(**shape), make_host_mesh(), adamw.AdamWConfig(**opt)),
        accum_steps=2, microbatch=2)
    assert dataclasses.asdict(pplan)["accum_steps"] == 2
    rfn = jax.jit(ref_step.make_train_step(rplan, ref_host_mesh(), RefMeshRules()))
    pfn = step.make_train_step(pplan, make_host_mesh(), MeshRules())
    init = _unit_scale_attention(_ref_init(rcfg, 4), rcfg.d_model)
    rparams = jax.tree.map(jnp.asarray, init)
    ropt = ref_adamw.init_opt_state(rparams)
    pparams = model.params_from_jax(init, pcfg, device="cpu")
    popt = adamw.init_opt_state(pparams)
    for s in range(3):
        toks = _tokens(rcfg, 4, 16, seed=10 + s).reshape(2, 2, 16)
        rparams, ropt, rm = rfn(rparams, ropt, {"tokens": jnp.asarray(toks)})
        pparams, popt, pm = pfn(pparams, popt, {"tokens": torch.tensor(toks).long()})
        np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(rm["grad_norm"]), rtol=1e-3)
        for want, got in zip(jax.tree.leaves(rparams), adamw.tree_leaves(pparams)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=2e-5)
    assert int(popt.step) == int(ropt.step) == 3


def test_plan_for_equals_the_reference():
    for arch in ("zamba2-2.7b", "mixtral-8x22b"):
        for gb in (1, 2, 3, 8):
            shape = dict(name="t", seq_len=2048, global_batch=gb, kind="train")
            want = ref_step.plan_for(ref_get_smoke(arch), RefShapeSpec(**shape), ref_host_mesh())
            got = step.plan_for(get_smoke(arch), ShapeSpec(**shape), make_host_mesh())
            assert (got.accum_steps, got.microbatch, got.seq_len, got.tp) == (
                want.accum_steps, want.microbatch, want.seq_len, want.tp)


def test_serve_steps_run_without_grad():
    cfg = _f32(get_smoke("tinyllama-1.1b"))
    params = model.init_params(cfg, seed=1, device="cpu")
    pre = step.make_prefill_step(cfg, make_host_mesh(), MeshRules())
    dec = step.make_decode_step(cfg, make_host_mesh(), MeshRules())
    toks = torch.tensor(_tokens(cfg, 1, 6)).long()
    logits, _ = pre(params, toks)
    caches = model.make_cache(cfg, 1, 8, device="cpu")
    for t in range(6):
        last, caches = dec(params, caches, toks[:, t : t + 1])
    assert logits.grad_fn is None and float((last - logits).abs().max()) < 2e-3
