"""repro_torch's LM backbone on the CPU against the reference's.

The same parameters (the reference's ``init_params`` carried over by
``params_from_jax``) and the same numpy tokens go through both packages at
smoke size in f32: ``prefill`` logits and every ``decode_step``'s logits agree
within 2e-3 max |Δ| (the reference's decode ≡ forward bound,
``tests/test_models.py``).  Prefill runs the plain versions of K6 and K7 here.
Every layer kind is covered: attention, SSM, the zamba2 hybrid, MoE (mixtral,
llama4-scout with its shared expert) and the frontend stubs (internvl2,
musicgen), whose prefill takes the same seeded ``extra`` features in both
packages.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro_torch.configs import ARCH_IDS as PORT_ARCH_IDS  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers, model  # noqa: E402

PARITY_ARCHS = ["zamba2-2.7b", "tinyllama-1.1b", "mamba2-2.7b", "mixtral-8x22b",
                "llama4-scout-17b-a16e", "internvl2-1b", "musicgen-medium"]
F32 = dict(dtype="float32", param_dtype="float32", attn_p_dtype="float32", remat=False)


def _f32(cfg):
    return dataclasses.replace(cfg, **F32)


@pytest.fixture(scope="module", params=PARITY_ARCHS)
def pair(request):
    """(reference cfg, params, jitted decode; port cfg, params) at f32."""
    arch = request.param
    rcfg, pcfg = _f32(ref_get_smoke(arch)), _f32(get_smoke(arch))
    rparams = jax.jit(lambda k: ref_model.init_params(rcfg, k))(jax.random.PRNGKey(7))
    pparams = model.params_from_jax(jax.tree.map(np.asarray, rparams), pcfg, device="cpu")
    step = jax.jit(lambda p, c, t: ref_model.decode_step(p, c, t, rcfg))
    return arch, rcfg, rparams, step, pcfg, pparams


def _tokens(cfg, b, L, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, L)).astype(np.int32)


def _extra(cfg, b, seed=0):
    """The frontend's features (b, n_extra, feature_dim), or None."""
    if cfg.frontend is None:
        return None
    fe = cfg.frontend
    shape = (b, fe.n_extra_tokens, fe.feature_dim)
    return np.random.default_rng(seed + 100).standard_normal(shape).astype(np.float32)


def test_config_registry_equals_the_reference():
    assert PORT_ARCH_IDS == ARCH_IDS
    for arch in ARCH_IDS:
        for port, ref in ((get_config(arch), ref_get_config(arch)),
                          (get_smoke(arch), ref_get_smoke(arch))):
            assert dataclasses.asdict(port) == dataclasses.asdict(ref), arch
            assert port.n_params == ref.n_params and port.layer_kinds == ref.layer_kinds


def test_params_mirror_the_reference_tree():
    for arch in PARITY_ARCHS + ["h2o-danube-3-4b"]:
        cfg = get_smoke(arch)
        got = model.init_params(cfg, seed=3, device="cpu")
        want = ref_model.abstract_params(ref_get_smoke(arch))
        flat_got = {k: tuple(v.shape) for k, v in _flatten(got)}
        flat_want = {k: tuple(v.shape) for k, v in _flatten(want)}
        assert flat_got == flat_want, arch
        assert all(v.dtype == torch.bfloat16 for _, v in _flatten(got))
    again = model.init_params(get_smoke("zamba2-2.7b"), seed=3, device="cpu")
    assert torch.equal(again["embed"], model.init_params(get_smoke("zamba2-2.7b"), seed=3,
                                                         device="cpu")["embed"])


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_prefill_equals_reference(pair):
    arch, rcfg, rparams, _, pcfg, pparams = pair
    toks, extra = _tokens(rcfg, 2, 24), _extra(rcfg, 2)
    want, wcache = jax.jit(lambda p, t, e: ref_model.prefill(p, t, rcfg, extra=e))(
        rparams, jnp.asarray(toks), None if extra is None else jnp.asarray(extra))
    ops.reset_launches()
    got, cache = model.prefill(pparams, torch.tensor(toks, dtype=torch.int64), pcfg,
                               extra=None if extra is None else torch.tensor(extra))
    assert ops.flash_attention.launches == 0 and ops.ssd_chunk.launches == 0   # CPU: plain
    assert got.shape == (2, 1, pcfg.vocab_size) and cache["pos"] == int(wcache["pos"])
    assert np.abs(got.numpy() - np.asarray(want)).max() < 2e-3, arch


def test_every_decode_step_equals_reference(pair):
    arch, rcfg, rparams, step, pcfg, pparams = pair
    b, L = 2, 10
    toks = _tokens(rcfg, b, L, seed=1)
    rc = ref_model.make_cache(rcfg, b, 16)
    pc = model.make_cache(pcfg, b, 16, device="cpu")
    for t in range(L):
        want, rc = step(rparams, rc, jnp.asarray(toks[:, t : t + 1]))
        got, pc = model.decode_step(pparams, pc, torch.tensor(toks[:, t : t + 1]).long(), pcfg)
        assert np.abs(got.numpy() - np.asarray(want)).max() < 2e-3, (arch, t)
    assert pc["pos"] == L == int(rc["pos"])
    if "ssm" in pc:
        np.testing.assert_allclose(pc["ssm"]["state"].numpy(), np.asarray(rc["ssm"]["state"]),
                                   rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", PARITY_ARCHS + ["h2o-danube-3-4b"])
def test_decode_equals_forward(arch):
    """The port's own teacher-forced decode reproduces its prefill logits at
    every position (h2o-danube: a sliding window of 16 over 20 tokens, so the
    ring buffer wraps).  MoE configs get the reference test's capacity
    factor 8, so that no token is dropped in the full forward either."""
    cfg = _f32(get_smoke(arch))
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    params = model.init_params(cfg, seed=7, device="cpu")
    b, L = 1, 20 if arch == "h2o-danube-3-4b" else 10
    toks = torch.tensor(_tokens(cfg, b, L, seed=8)).long()
    x, pos = model.embed_inputs(params, toks, cfg)
    full = model.logits_from(params, model.backbone(params, x, cfg, pos)[0], cfg)
    caches = model.make_cache(cfg, b, 32, device="cpu")
    outs = []
    for t in range(L):
        lg, caches = model.decode_step(params, caches, toks[:, t : t + 1], cfg)
        outs.append(lg[:, 0])
    err = (torch.stack(outs, 1) - full).abs().max().item()
    assert err < 2e-3, (arch, err)


def test_bf16_prefill_is_close_to_the_reference():
    """bf16 as configured: both packages round activations to bf16 at their
    own places (the reference's jnp SSD keeps some products in bf16, the
    port's K7 plain version widens to f32), so the bound is bf16's: 5e-2 of
    the logits' scale."""
    rcfg, pcfg = ref_get_smoke("zamba2-2.7b"), get_smoke("zamba2-2.7b")
    rparams = jax.jit(lambda k: ref_model.init_params(rcfg, k))(jax.random.PRNGKey(2))
    pparams = model.params_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32), rparams),
                                    pcfg, device="cpu")
    toks = _tokens(rcfg, 1, 16, seed=4)
    want = np.asarray(jax.jit(lambda p, t: ref_model.prefill(p, t, rcfg)[0])(
        rparams, jnp.asarray(toks)), np.float32)
    got = model.prefill(pparams, torch.tensor(toks).long(), pcfg)[0].float().numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() < 5e-2 * max(1.0, np.abs(want).max())


def test_init_params_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_params(get_smoke("zamba2-2.7b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.make_cache(get_smoke("zamba2-2.7b"), 1, 8)


@pytest.mark.parametrize("n_q,n_kv,tp", [(40, 10, 16), (14, 2, 16), (24, 24, 16), (40, 8, 16),
                                         (32, 4, 16), (32, 32, 1)])
def test_head_plan_equals_the_reference(n_q, n_kv, tp):
    got = layers.HeadPlan.plan(n_q, n_kv, tp)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref_layers.HeadPlan.plan(n_q, n_kv, tp))


def test_layer_ops_equal_the_reference():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = np.tile(np.arange(5, dtype=np.int32), (2, 1)) + 3
    np.testing.assert_allclose(
        layers.apply_rope(torch.tensor(x), torch.tensor(pos), 10_000.0).numpy(),
        np.asarray(ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)),
        atol=1e-5)
    w = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        layers.rms_norm(torch.tensor(x), torch.tensor(w), 1e-5).numpy(),
        np.asarray(ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)), atol=1e-5)
    # decode attention against a ring-buffered cache, grouped and repeated, with row starts
    q = rng.standard_normal((2, 1, 6, 8)).astype(np.float32)
    kc, vc = (rng.standard_normal((2, 7, 3, 8)).astype(np.float32) for _ in range(2))
    kpos = np.array([7, 8, 9, 3, 4, 5, -1], np.int32)
    rs = np.array([0, 5], np.int32)
    for grouped, window in ((True, None), (False, 4), (True, 6)):
        got = layers.decode_attention(
            torch.tensor(q), torch.tensor(kc), torch.tensor(vc), torch.tensor(kpos), 9,
            groups=2, grouped=grouped, window=window, row_start=torch.tensor(rs))
        want = ref_layers.decode_attention(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kpos), jnp.asarray(9),
            groups=2, grouped=grouped, window=window, row_start=jnp.asarray(rs))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
