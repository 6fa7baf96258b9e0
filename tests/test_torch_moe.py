"""repro_torch's MoE layer on the CPU against the reference's.

``moe_ffn`` on the same f32 params and tokens (seeded numpy normals, no ties
in the router's top-k) gives the reference's output and both aux losses
within atol 1e-5, for llama4-scout's smoke config (top-1, shared expert) and
mixtral's (top-2), at 12 tokens, where the capacity (3 or 7 slots an
expert) drops assignments (the test asserts that some are dropped), and at
40; its gradients
equal ``jax.grad``'s; with ample capacity it is the dense mixture.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.config import MoEConfig  # noqa: E402

ARCHS = ["llama4-scout-17b-a16e", "mixtral-8x22b"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensor ops: under a parallel test run every worker's intra-op
    thread pool competes for the same cores, so this module runs one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(d, cfg, seed):
    rng = np.random.default_rng(seed)
    decls = ref_moe.declare_moe(d, cfg)
    return {k: (rng.standard_normal(v.shape) / np.sqrt(v.shape[-2])).astype(np.float32)
            for k, v in decls.items()}


def _dropped(x, params, cfg) -> int:
    """Assignments past the capacity, counted from the router's top-k."""
    logits = x @ params["router"]
    idx = np.argsort(-logits, axis=-1, kind="stable")[:, : cfg.top_k]
    counts = np.bincount(idx.reshape(-1), minlength=cfg.n_experts)
    return int(np.maximum(counts - moe.capacity(x.shape[0], cfg), 0).sum())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("T", [12, 40])
def test_moe_ffn_equals_the_reference(arch, T):
    rcfg, pcfg = ref_get_smoke(arch).moe, get_smoke(arch).moe
    assert dataclasses.asdict(rcfg) == dataclasses.asdict(pcfg)
    d = get_smoke(arch).d_model
    params = _params(d, rcfg, seed=T)
    x = np.random.default_rng(T + 1).standard_normal((T, d)).astype(np.float32)
    want_y, want_aux = ref_moe.moe_ffn(jax.tree.map(jnp.asarray, params), jnp.asarray(x), rcfg)
    got_y, got_aux = moe.moe_ffn({k: torch.tensor(v) for k, v in params.items()},
                                 torch.tensor(x), pcfg)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=1e-5)
    assert set(got_aux) == set(want_aux) == {"moe_lb_loss", "moe_z_loss"}
    for k in want_aux:
        np.testing.assert_allclose(float(got_aux[k]), float(want_aux[k]), atol=1e-5)
    if T == 12:
        assert _dropped(x, params, rcfg) > 0         # the drop rule is exercised
    assert moe.capacity(T, pcfg) == max(1, int(T * rcfg.top_k / rcfg.n_experts
                                               * rcfg.capacity_factor))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_gradients_equal_the_reference(arch):
    rcfg, pcfg = ref_get_smoke(arch).moe, get_smoke(arch).moe
    d = get_smoke(arch).d_model
    params = _params(d, rcfg, seed=3)
    x = np.random.default_rng(4).standard_normal((40, d)).astype(np.float32)

    def ref_loss(p, xx):
        y, aux = ref_moe.moe_ffn(p, xx, rcfg)
        return jnp.sum(jnp.sin(y)) + aux["moe_lb_loss"] + aux["moe_z_loss"]

    want_p, want_x = jax.grad(ref_loss, argnums=(0, 1))(jax.tree.map(jnp.asarray, params),
                                                         jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    y, aux = moe.moe_ffn(tp, tx, pcfg)
    (torch.sin(y).sum() + aux["moe_lb_loss"] + aux["moe_z_loss"]).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_x), rtol=2e-4, atol=2e-5)
    for k in params:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(want_p[k]), rtol=2e-4,
                                   atol=2e-5, err_msg=k)


def test_moe_routing_no_drop_exact():
    """With ample capacity, the MoE equals the dense mixture computed naively
    (the reference's ``test_moe_routing_no_drop_exact``)."""
    cfg = MoEConfig(n_experts=4, top_k=2, d_ff_expert=16, capacity_factor=8.0)
    params = {k: torch.tensor(v) for k, v in _params(8, cfg, seed=5).items()}
    x = torch.tensor(np.random.default_rng(6).standard_normal((10, 8)).astype(np.float32))
    y, aux = moe.moe_ffn(params, x, cfg)
    probs = torch.softmax(x @ params["router"], dim=-1)
    gates, idx = torch.topk(probs, 2, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    want = torch.zeros_like(x)
    for t in range(10):
        for j in range(2):
            e = int(idx[t, j])
            h = torch.nn.functional.silu(x[t] @ params["w_gate"][e]) * (x[t] @ params["w_up"][e])
            want[t] += gates[t, j] * (h @ params["w_down"][e])
    np.testing.assert_allclose(y.numpy(), want.numpy(), atol=1e-5)
    assert float(aux["moe_lb_loss"]) >= 0.0 and float(aux["moe_z_loss"]) >= 0.0
