"""repro_torch's host front-end against repro's: segment tables, parser
matrices, bit packing and SLPF packing are identical on the conformance
corpus (tolerance zero — these are integer and Boolean arrays)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_corpus import CORPUS, artifacts  # noqa: E402

from repro.core.matrices import pack_bits as ref_pack_bits  # noqa: E402
from repro.core.matrices import boolean_matmul, boolean_matvec  # noqa: E402
from repro.core.matrices import pack_bits_jnp, pack_transition_table  # noqa: E402
from repro.core.slpf import SLPF as RefSLPF  # noqa: E402
from repro_torch.core import matrices as port_matrices  # noqa: E402
from repro_torch.core.engine import unpack_columns  # noqa: E402
from repro_torch.core.slpf import SLPF as PortSLPF  # noqa: E402
from repro_torch.kernels.ref import unpack_columns_ref  # noqa: E402


@pytest.mark.parametrize("key", CORPUS)
def test_segment_table_equals_reference(key):
    art, port, _ = artifacts(key)
    ref_t, port_t = art.matrices.table, port.table
    assert port_t.n == ref_t.n
    assert port_t.segs == ref_t.segs
    assert port_t.folseg == ref_t.folseg
    assert port_t.end_letter == ref_t.end_letter
    assert port_t.index == ref_t.index
    assert port_t.all_displays() == ref_t.all_displays()
    assert [sorted(c) for c in port_t.seg_classes] == [sorted(c) for c in ref_t.seg_classes]
    assert np.array_equal(port_t.initial, ref_t.initial)
    assert np.array_equal(port_t.final, ref_t.final)


@pytest.mark.parametrize("key", CORPUS)
def test_parser_matrices_equal_reference(key):
    art, port, _ = artifacts(key)
    ref = art.matrices
    for name in ("N", "I", "F", "byte_to_class"):
        assert np.array_equal(getattr(port, name), getattr(ref, name)), name
    assert port.pad_class == ref.pad_class and port.n_classes == ref.n_classes
    text = b"abxyz~\n" * 3
    assert np.array_equal(port.classes_of_text(text), ref.classes_of_text(text))
    assert np.array_equal(
        port_matrices.pack_transition_table(port.N), pack_transition_table(ref.N)
    )


@pytest.mark.parametrize("key", CORPUS)
def test_boolean_products_equal_reference(key):
    _, port, _ = artifacts(key)
    N = port.N
    rng = np.random.default_rng(len(key))
    v = rng.random(N.shape[-1]) < 0.5
    assert np.array_equal(port_matrices.boolean_matmul(N[1:], N[:-1]), boolean_matmul(N[1:], N[:-1]))
    assert np.array_equal(port_matrices.boolean_matvec(N, v), boolean_matvec(N, v))


@pytest.mark.parametrize("shape", [(5, 32), (3, 4, 96), (2, 288), (1, 0, 64)])
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_pack_bits_torch_equals_reference_packers(shape, density):
    rng = np.random.default_rng(sum(shape))
    bits = rng.random(shape) < density
    got = port_matrices.pack_bits_torch(torch.tensor(bits, dtype=torch.float32))
    assert got.dtype == torch.int32
    got = got.numpy().view(np.uint32)
    assert np.array_equal(got, ref_pack_bits(bits))
    assert np.array_equal(got, np.asarray(pack_bits_jnp(bits.astype(np.float32))))


def test_pack_bits_torch_refuses_ragged_width():
    with pytest.raises(ValueError):
        port_matrices.pack_bits_torch(torch.zeros(3, 40))


@pytest.mark.parametrize("n", [1, 31, 37, 64, 257])
def test_unpack_columns_equals_unpack_bits(n):
    rng = np.random.default_rng(n)
    bits = rng.random((9, n)) < 0.4
    packed = ref_pack_bits(bits)
    assert np.array_equal(unpack_columns(packed, n), bits)
    assert np.array_equal(unpack_columns(packed, n), port_matrices.unpack_bits(packed, n))


@pytest.mark.parametrize("ell", [1, 31, 32, 33, 37, 257, 288])
def test_unpack_columns_ref_equals_unpack_columns(ell):
    """The plain version of the card's unpack over a bucket group (B = 4 batch
    rows, three of them texts of ragged lengths, one padding) against the
    host's ``unpack_columns`` of each text's C₀ and packed rows; W is ℓ's
    words, or one more where ℓ is odd (a padded ℓp)."""
    rng = np.random.default_rng(ell)
    W = -(-ell // 32) + ell % 2
    B, c, k = 4, 3, 4
    col0 = rng.integers(0, 2**32, size=(B, W), dtype=np.uint32)
    cols = rng.integers(0, 2**32, size=(B, c, k, W), dtype=np.uint32)
    lengths = (c * k, 7, 0)
    got = unpack_columns_ref(torch.from_numpy(col0.view(np.int32)),
                             torch.from_numpy(cols.view(np.int32)), lengths=lengths, ell=ell)
    assert len(got) == len(lengths)
    for b, n in enumerate(lengths):
        packed = np.concatenate([col0[b, None], cols[b].reshape(-1, W)[:n]])
        assert got[b].dtype == torch.bool and tuple(got[b].shape) == (n + 1, ell)
        assert np.array_equal(got[b].numpy(), unpack_columns(packed, ell)), (b, n)


@pytest.mark.parametrize("key", CORPUS)
def test_slpf_pack_and_queries_equal_reference(key):
    art, port, _ = artifacts(key)
    rng = np.random.default_rng(len(key))
    ell = port.n_segments
    n = 6
    columns = rng.random((n + 1, ell)) < 0.5
    classes = rng.integers(0, port.n_classes, size=n).astype(np.int32)
    ref = RefSLPF(table=art.matrices.table, columns=columns, classes=classes)
    got = PortSLPF(table=port.table, columns=columns, classes=classes)
    assert np.array_equal(got.pack(), ref.pack())
    assert got.accepted == ref.accepted
