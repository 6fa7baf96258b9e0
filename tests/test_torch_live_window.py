"""The live window of a fleet bucket's tables (``repro_torch/kernels/window.py``), on the CPU.

The fleet pads each tenant's tables to a power-of-two ℓp (``core/fleet.py``
``_compile_tables``, the reference's bucket policy), so e125 (ℓ = 257) lands
at ℓp 512.  Padded that way every table is block-diagonal, and K1 and K2 walk
only the live window ℓ' and write the rest from the block algebra.  Here:
ℓ' on each bucket's stack built by the port's ``_compile_tables``; ℓ' = ℓp on
tables broken on purpose; the fleet keeps the window with its gathered
stacks; and the windowed algebra, written in plain torch as the kernels
compute it, equals the JAX package's ``reach_chunk_product_ref`` and
``build_merge_chunk_ref`` (packed alike) on e125's ℓp-512 fleet stack, bit
for bit, all-PAD chunks, chunks with one real step first or last, and entries
with padded bits set among them.  The kernels themselves are held against
their plain versions on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.core.fleet import FleetEngine, TenantSpec, _compile_tables  # noqa: E402
from repro_torch.core.matrices import build_matrices, pack_bits_torch  # noqa: E402
from repro_torch.core.segments import compute_segments  # noqa: E402
from repro_torch.kernels import build, reach, window  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    build_merge_packed_ref,
    reach_chunk_product_ref,
    tenant_of_chunk,
)

E125 = "(a|b)*a(a|b){125}"
TRAFFIC = r"((GET|POST|PUT) /([a-z0-9]|/)* ([0-9]{3}) (ok|err|-)\n)+"
AB = [f"(a|b)*a(a|b){{{k}}}" for k in range(1, 9)]
LANE = 32          # the cuda backend's min_lane_pad


def _tables(pattern):
    return _compile_tables(build_matrices(compute_segments(pattern)), LANE)


def _stack(patterns):
    """The bucket's (T, Ab, Lb, Lb) stack as ``_BucketRunner`` builds it, and
    the tenants' compiled tables."""
    cts = [_tables(p) for p in patterns]
    return torch.from_numpy(np.stack([ct.N for ct in cts])), cts


def _round32(n):
    return -(-n // 32) * 32


# ----------------------------------------------------------- the window


@pytest.mark.parametrize("patterns,want", [
    ([E125], 288),
    ([E125] * 16, 288),
    ([TRAFFIC] * 3, 64),
    (AB, 32),
    ([AB[0]], 32),
])
def test_window_of_each_fleet_bucket(patterns, want):
    N, cts = _stack(patterns)
    assert len({(ct.n_classes, ct.ell_pad) for ct in cts}) == 1
    win = window.live_window(N)
    assert win.width == want
    assert win.width == _round32(max(ct.ell for ct in cts))
    # the tenant's real classes have D = 0, its PAD and the bucket's spare
    # classes D = I
    for t, ct in enumerate(cts):
        A1 = ct.matrices.N.shape[0]
        assert win.ident[t].tolist() == [0] * (A1 - 1) + [1] * (ct.n_classes - A1 + 1)
    if want < N.shape[-1]:
        assert (N.shape[-1], want) == (512, 288)


def test_a_stack_takes_its_widest_members_window():
    """e125 and e160 share the ℓp-512 bucket; the stack's window is the
    wider one's, and it holds for e125 too."""
    wide = "(a|b)*a(a|b){160}"
    N, cts = _stack([E125, wide])
    assert cts[0].ell_pad == cts[1].ell_pad == 512
    w0, w1 = (window.live_window(N[t]).width for t in range(2))
    assert w0 == 288 and w1 == _round32(cts[1].ell) > w0
    assert window.live_window(N).width == w1


def _break(N, how):
    N = N.clone()
    lp = N.shape[-1]
    pad = N.shape[-3] - 1
    if how == "arc into the padding":
        N[..., 0, 0, lp - 1] = 1.0
    elif how == "arc out of the padding":
        N[..., 1, lp - 1, 3] = 1.0
    elif how == "identity class zero on the last state":
        N[..., pad, lp - 1, lp - 1] = 0.0
    elif how == "identity class with an arc between padded states":
        N[..., pad, lp - 2, lp - 1] = 1.0
    elif how == "identity class not 0 or 1":
        N[..., pad, :, :] *= 0.5
    elif how == "real class 1 on the last state":
        N[..., 0, lp - 1, lp - 1] = 1.0
    return N


BROKEN = ["arc into the padding", "arc out of the padding",
          "identity class zero on the last state",
          "identity class with an arc between padded states", "identity class not 0 or 1",
          "real class 1 on the last state"]


@pytest.mark.parametrize("how", BROKEN)
@pytest.mark.parametrize("tenants", [1, 3])
def test_window_falls_back_to_lp_on_broken_tables(how, tenants):
    """No split ℓ' < ℓp holds once a class reaches the last padded states or
    an identity class is not the identity there: ℓ' = ℓp, and the plans are
    those of a table with no window (K1's strip kernel, K2's row kernel)."""
    N, _ = _stack([E125] * tenants)
    Nb = _break(N if tenants > 1 else N[0], how)
    lw = window.live_window(Nb).width
    assert lw == 512
    assert reach.plan(4, 512, lw) == reach.plan(4, 512) == ("strip", 0)
    assert build.plan(4, 512, 1024, lw) == build.plan(4, 512, 1024) == build.ROWS


def test_window_follows_the_table_not_the_tenants_ell():
    """An arc into padded state 300 of e125's table (ℓ = 257) widens the
    window to 320: the test on N decides, ℓ does not."""
    N, cts = _stack([E125])
    assert cts[0].ell == 257
    N = N.clone()
    N[0, 1, 5, 300] = 1.0
    assert window.live_window(N).width == 320
    N[0, 3, 400, 400] = 0.0                 # the PAD class loses state 400
    assert window.live_window(N).width == 416


def test_attach_keeps_the_window_while_the_table_is_unchanged():
    N, _ = _stack([E125] * 2)
    assert window.attached(N) is None and window.width(N) == 512
    win = window.live_window(N)
    window.attach(N, win)
    assert window.attached(N).width == 288 and window.width(N) == 288
    assert window.attached(N.clone()) is None
    N[0, 0, 0, 0] = 1.0                      # an in-place write drops it
    assert window.attached(N) is None
    with pytest.raises(ValueError, match="multiple of 32"):
        window.attach(N, win._replace(width=100))
    with pytest.raises(ValueError, match="int32"):
        window.attach(N, win._replace(ident=win.ident[:1]))


def test_fleet_attaches_each_gathered_stacks_window():
    """The bucket runner tests its members' tables on the host and keeps the
    window with each gathered stack: e125's at 288, TRAFFIC's at ℓp."""
    eng = FleetEngine(device="cpu")
    for j in range(3):
        eng.add_tenant(f"e{j}", TenantSpec(regex=E125, backend="torch"))
    eng.add_tenant("t", TenantSpec(regex=TRAFFIC, backend="torch"))
    for tid, want in (("e0", 288), ("t", 64)):
        runner = eng.runner(eng.tenant(tid).bucket_key)
        rows, _ = runner.host_batch(2, 8, {t: [np.zeros(3, np.int32)]
                                           for t in runner.tenant_rows})
        N = runner.operands(rows)[0]
        win = window.attached(N)
        assert win is not None and win.width == want
        direct = window.live_window(N)
        assert torch.equal(win.ident, direct.ident) and win.width == direct.width
        assert runner.operands(rows)[0] is N        # kept with the gathered stack


# --------------------------------------- the windowed algebra, bit for bit


def windowed_reach(N, ids, win):
    """K1's windowed arithmetic in plain torch: the product of the ℓ' live
    states, the padded diagonal 1 where every step's class has D = I."""
    lw, lp = win.width, N.shape[-1]
    C = ids.shape[0]
    live = reach_chunk_product_ref(N[..., :lw, :lw].contiguous(), ids)
    T = 1 if N.dim() == 3 else N.shape[0]
    tix = tenant_of_chunk(T, C)
    flag = win.ident[tix[:, None], ids.long()].bool().all(1).float()
    P = torch.zeros((C, lp, lp))
    P[:, :lw, :lw] = live
    pad = torch.arange(lw, lp)
    P[:, pad, pad] = flag[:, None]
    return P


def windowed_build_merge(N, ids, ef, eb, win):
    """K2's windowed arithmetic in plain torch: the packed columns of the ℓ'
    live states, and in every row the padded words of ef ∧ eb where every
    step's class has D = I, else 0."""
    lw = win.width
    C, k = ids.shape
    live = build_merge_packed_ref(N[..., :lw, :lw].contiguous(), ids,
                                  ef[:, :lw].contiguous(), eb[:, :lw].contiguous())
    T = 1 if N.dim() == 3 else N.shape[0]
    flag = win.ident[tenant_of_chunk(T, C)[:, None], ids.long()].bool().all(1)
    pad = pack_bits_torch((ef[:, lw:] != 0) & (eb[:, lw:] != 0)) * flag[:, None].int()
    return torch.cat([live, pad[:, None, :].expand(C, k, pad.shape[-1])], dim=-1)


def _jax_reach(N, ids):
    """The JAX package's reach_chunk_product_ref, chunk by chunk, each on its
    tenant's table."""
    T = N.shape[0]
    tix = tenant_of_chunk(T, ids.shape[0]).numpy()
    return np.stack([np.asarray(jax_ref.reach_chunk_product_ref(jnp.asarray(N[t].numpy()),
                                                                jnp.asarray(row.numpy())))
                     for t, row in zip(tix, ids)])


def _jax_build_merge(N, ids, ef, eb):
    T = N.shape[0]
    tix = tenant_of_chunk(T, ids.shape[0]).numpy()
    return np.stack([np.asarray(jax_ref.build_merge_chunk_ref(
        jnp.asarray(N[t].numpy()), jnp.asarray(row.numpy()), jnp.asarray(f.numpy()),
        jnp.asarray(b.numpy()))) for t, row, f, b in zip(tix, ids, ef, eb)])


def _e125_case(k, seed):
    """Two e125 tenants of the ℓp-512 bucket, 5 chunks each: random real
    classes with PAD sprinkled in, all PAD, one real step first, one real
    step last, and all real; entries random over all 512 states (padded
    bits set)."""
    N, cts = _stack([E125, E125])
    pad = cts[0].pad_class
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(2):
        mixed = rng.integers(0, pad + 1, k)
        first = np.full(k, pad)
        first[0] = rng.integers(0, pad)
        last = np.full(k, pad)
        last[-1] = rng.integers(0, pad)
        rows += [mixed, np.full(k, pad), first, last, rng.integers(0, pad, k)]
    ids = torch.from_numpy(np.stack(rows).astype(np.int32))
    ef = torch.from_numpy((rng.random((10, 512)) < 0.5).astype(np.float32))
    eb = torch.from_numpy((rng.random((10, 512)) < 0.5).astype(np.float32))
    return N, ids, ef, eb


@pytest.mark.parametrize("k", [1, 6])
def test_windowed_reach_equals_the_jax_reference(k):
    N, ids, _, _ = _e125_case(k, seed=k)
    win = window.live_window(N)
    assert win.width == 288
    got = windowed_reach(N, ids, win)
    want = _jax_reach(N, ids)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, reach_chunk_product_ref(N, ids))
    # the all-PAD chunks are the identity, the others 0 on the padded diagonal
    diag = got[:, 511, 511].tolist()
    assert diag == [float(all(x == 3 for x in row)) for row in ids.tolist()]


@pytest.mark.parametrize("k", [1, 6])
def test_windowed_build_merge_equals_the_jax_reference(k):
    N, ids, ef, eb = _e125_case(k, seed=10 + k)
    win = window.live_window(N)
    got = windowed_build_merge(N, ids, ef, eb, win)
    want = pack_bits_torch(torch.from_numpy(_jax_build_merge(N, ids, ef, eb)))
    assert torch.equal(got, want)
    assert torch.equal(got, build_merge_packed_ref(N, ids, ef, eb))
    # the padded words are set in the all-PAD chunks and nowhere else
    padded = got[..., 9:].ne(0).any(-1).any(-1).tolist()
    assert padded == [all(x == 3 for x in row) for row in ids.tolist()]
    assert any(padded)


def test_windowed_algebra_on_a_shared_table_and_zero_steps():
    """One table (no tenant axis) and chunks of no steps: the product is the
    identity, the padded flag 1."""
    N = _stack([E125])[0][0]
    win = window.live_window(N)
    ids = torch.zeros((2, 0), dtype=torch.int32)
    assert torch.equal(windowed_reach(N, ids, win), reach_chunk_product_ref(N, ids))
    ids = torch.tensor([[0, 3, 1], [3, 3, 3]], dtype=torch.int32)
    ef = torch.ones((2, 512))
    assert torch.equal(windowed_reach(N, ids, win), reach_chunk_product_ref(N, ids))
    assert torch.equal(windowed_build_merge(N, ids, ef, ef, win),
                       build_merge_packed_ref(N, ids, ef, ef))
