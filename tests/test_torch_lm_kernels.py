"""repro_torch's LM kernel modules on the CPU: K6 (flash attention) and K7
(SSD chunk) as plain PyTorch versions, and the two-pass SSD built on K7.

Each plain version (``repro_torch/kernels/ref.py``) runs on the same numpy
inputs as the reference's Pallas kernel (``repro.kernels.ops``, interpret mode
on the CPU) and its pure-jnp oracle (``repro.kernels.ref``).  Tolerances are
the reference's own (``tests/test_kernels.py``): K6 atol 3e-5 in f32 and 3e-2
in bf16, K7 rtol = atol = 2e-4, the SSD layer 3e-4.  The CUDA kernels
themselves are held against these plain versions on the card by
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_oracles  # noqa: E402
from repro.models import mamba as ref_mamba  # noqa: E402
from repro_torch.core.scan import associative_prefix, exclusive_entries  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref, ssd_chunk_ref  # noqa: E402
from repro_torch.models import mamba  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(x: np.ndarray, dtype: str):
    """The same numpy values as a JAX and a torch array of ``dtype`` (bf16
    rounds identically: both round-to-nearest-even from f32)."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.tensor(x).to(td)


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else x.float().numpy()


@pytest.mark.parametrize("L", [40, 96])
@pytest.mark.parametrize("hd", [32, 64, 80])
@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_equals_reference_kernel(L, hd, window, dtype):
    rng = np.random.default_rng(L * 3 + hd)
    b, h = 2, 3
    q, k, v = (rng.standard_normal((b, L, h, hd)).astype(np.float32) for _ in range(3))
    (jq, tq), (jk, tk), (jv, tv) = _both(q, dtype), _both(k, dtype), _both(v, dtype)
    got = ops.flash_attention(tq, tk, tv, causal=True, window=window)   # CPU: plain
    assert got.dtype == DTYPES[dtype][1] and got.shape == (b, L, h, hd)
    kernel = ref_ops.flash_attention(jq, jk, jv, True, window, 32, 32)  # interpret
    oracle = ref_oracles.flash_attention_ref(jq, jk, jv, causal=True, window=window)
    atol = 3e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(_np(got), _np(kernel), atol=atol, rtol=0)
    np.testing.assert_allclose(_np(got), _np(oracle), atol=atol, rtol=0)


def test_flash_attention_plain_non_causal_and_longer_keys():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((1, 24, 2, 16)).astype(np.float32)
    k, v = (rng.standard_normal((1, 40, 2, 16)).astype(np.float32) for _ in range(2))
    for causal, window in ((False, None), (True, None), (True, 5), (False, 7)):
        got = flash_attention_ref(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                  causal=causal, window=window)
        want = ref_oracles.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                               causal=causal, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, rtol=0)


def _ssd_inputs(rng, P, q, hp, n):
    xdt = rng.standard_normal((P, q, hp)).astype(np.float32) * 0.3
    cs = np.cumsum(-np.abs(rng.uniform(0.01, 0.4, (P, q, 1))), axis=1).astype(np.float32)
    B = rng.standard_normal((P, q, n)).astype(np.float32) * 0.3
    C = rng.standard_normal((P, q, n)).astype(np.float32) * 0.3
    S = rng.standard_normal((P, hp, n)).astype(np.float32) * 0.3
    return xdt, cs, B, C, S


@pytest.mark.parametrize("q,hp,n", [(32, 16, 8), (64, 32, 16), (16, 8, 8), (48, 16, 16)])
def test_ssd_chunk_plain_equals_reference_kernel(q, hp, n):
    args = _ssd_inputs(np.random.default_rng(q + n), 4, q, hp, n)
    y, S_c = ops.ssd_chunk(*(torch.tensor(a) for a in args))             # CPU: plain
    ky, kS = ref_ops.ssd_chunk(*(jnp.asarray(a) for a in args))           # interpret
    oy, oS = ref_oracles.ssd_chunk_ref(*(jnp.asarray(a) for a in args))
    assert y.dtype == torch.float32 and S_c.shape == (4, n, hp)
    for got, want in ((y, ky), (S_c, kS), (y, oy), (S_c, oS)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("q,hp,n", [(32, 16, 8), (64, 32, 16), (1, 16, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunk_plain_single_outputs_equal_both(q, hp, n, dtype):
    """``outputs="state"`` and ``"y"`` give, bit for bit, the matching half of
    ``"both"`` and None for the other; a launch for S_c alone does not read
    C or S_prev (NaN there changes nothing)."""
    args = [torch.tensor(a) for a in _ssd_inputs(np.random.default_rng(q + hp), 3, q, hp, n)]
    td = DTYPES[dtype][1]
    args = [args[0].to(td), args[1], args[2].to(td), args[3].to(td), args[4]]
    y, S_c = ops.ssd_chunk(*args)
    y_only, none_s = ops.ssd_chunk(*args, outputs="y")
    none_y, s_only = ops.ssd_chunk(*args, outputs="state")
    assert none_s is None and none_y is None
    assert torch.equal(y_only, y) and torch.equal(s_only, S_c)
    nan_C, nan_S = torch.full_like(args[3], float("nan")), torch.full_like(args[4], float("nan"))
    _, s_blind = ops.ssd_chunk(args[0], args[1], args[2], nan_C, nan_S, outputs="state")
    assert torch.equal(s_blind, S_c)
    none_y, s_no_prev = ops.ssd_chunk(*args[:4], None, outputs="state")
    assert none_y is None and torch.equal(s_no_prev, S_c)
    with pytest.raises(ValueError, match="outputs"):
        ops.ssd_chunk(*args, outputs="S_c")
    for outputs in ("y", "both"):
        with pytest.raises(ValueError, match="needs S_prev"):
            ops.ssd_chunk(*args[:4], None, outputs=outputs)


def test_ssd_chunk_plain_takes_bf16_operands():
    """bf16 xdt / B / C are widened exactly; the result is the f32 one on the
    rounded inputs."""
    xdt, cs, B, C, S = _ssd_inputs(np.random.default_rng(9), 3, 32, 16, 16)
    r = [torch.tensor(a).to(torch.bfloat16) for a in (xdt, B, C)]
    y16, S16 = ssd_chunk_ref(r[0], torch.tensor(cs), r[1], r[2], torch.tensor(S))
    y32, S32 = ssd_chunk_ref(r[0].float(), torch.tensor(cs), r[1].float(), r[2].float(),
                             torch.tensor(S))
    assert torch.equal(y16, y32) and torch.equal(S16, S32)


def _ssd_layer_inputs(rng, b, l, nh, hp, g, n):
    xdt = rng.standard_normal((b, l, nh, hp)).astype(np.float32) * 0.3
    dA = -np.abs(rng.uniform(0.01, 0.4, (b, l, nh))).astype(np.float32)
    B = rng.standard_normal((b, l, g, n)).astype(np.float32) * 0.3
    C = rng.standard_normal((b, l, g, n)).astype(np.float32) * 0.3
    return xdt, dA, B, C


@pytest.mark.parametrize("b,l,nh,hp,g,n,chunk,with_state", [
    (2, 32, 2, 8, 1, 8, 8, False), (1, 48, 4, 16, 2, 16, 16, True),
    (2, 24, 2, 8, 1, 8, 16, True), (1, 7, 3, 8, 1, 4, 4, False),
])
def test_ssd_chunked_two_pass_equals_reference(b, l, nh, hp, g, n, chunk, with_state):
    rng = np.random.default_rng(l + nh + chunk)
    xdt, dA, B, C = _ssd_layer_inputs(rng, b, l, nh, hp, g, n)
    s0 = rng.standard_normal((b, nh, hp, n)).astype(np.float32) * 0.3 if with_state else None
    ops.reset_launches()
    y, state = mamba.ssd_chunked(*(torch.tensor(a) for a in (xdt, dA, B, C)), chunk,
                                 None if s0 is None else torch.tensor(s0))
    assert ops.ssd_chunk.launches == 0                 # CPU tensors: the plain version
    ref = jax.jit(ref_mamba.ssd_chunked, static_argnums=4)
    y_ref, state_ref = ref(*(jnp.asarray(a) for a in (xdt, dA, B, C)), chunk,
                           None if s0 is None else jnp.asarray(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(state.numpy(), np.asarray(state_ref), rtol=3e-4, atol=3e-4)


def test_ssd_chunked_equals_the_recurrence():
    """The two-pass SSD equals the per-step recurrence (the reference's
    ``tests/test_models.py`` oracle), final state included."""
    rng = np.random.default_rng(0)
    b, l, nh, hp, g, n = 2, 16, 4, 8, 1, 5
    xdt, dA, B, C = _ssd_layer_inputs(rng, b, l, nh, hp, g, n)
    y, state = mamba.ssd_chunked(*(torch.tensor(a) for a in (xdt, dA, B, C)), 4)
    s = np.zeros((b, nh, hp, n), np.float32)
    a = np.exp(dA)
    Bh, Ch = np.repeat(B, nh // g, axis=2), np.repeat(C, nh // g, axis=2)
    ys = []
    for t in range(l):
        s = a[:, t][..., None, None] * s + np.einsum("bhp,bhn->bhpn", xdt[:, t], Bh[:, t])
        ys.append(np.einsum("bhpn,bhn->bhp", s, Ch[:, t]))
    np.testing.assert_allclose(y.numpy(), np.stack(ys, 1), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(state.numpy(), s, rtol=2e-4, atol=2e-4)


def test_scan_takes_tuples_of_tensors():
    """The (decay, state) join: a tuple summary gives, element by element,
    the serial prefix of the affine monoid."""
    rng = np.random.default_rng(1)
    c, d = 7, 3
    a = torch.tensor(rng.uniform(0.2, 1.0, (c, d)).astype(np.float32))
    s = torch.tensor(rng.standard_normal((c, d, 2, 2)).astype(np.float32))
    prefix = associative_prefix(mamba._combine, (a, s))
    want_a, want_s = a[0], s[0]
    for i in range(c):
        if i:
            want_a, want_s = mamba._combine((a[i], s[i]), (want_a, want_s))
        torch.testing.assert_close(prefix[0][i], want_a)
        torch.testing.assert_close(prefix[1][i], want_s)
    init = torch.tensor(rng.standard_normal((d, 2, 2)).astype(np.float32))
    entries = exclusive_entries(mamba._combine, mamba._act, (a, s), init)
    state = init
    for i in range(c):
        torch.testing.assert_close(entries[i], state)
        state = mamba._act((a[i], s[i]), state)


def test_scan_single_tensor_path_is_unchanged():
    rng = np.random.default_rng(2)
    xs = torch.tensor((rng.random((9, 4, 4)) < 0.4).astype(np.float32))
    comb = lambda later, earlier: torch.clamp(later @ earlier, max=1.0)  # noqa: E731
    got = associative_prefix(comb, xs)
    want = xs.clone()
    for i in range(1, 9):
        want[i] = comb(xs[i], want[i - 1])
    assert torch.equal(got, want)
