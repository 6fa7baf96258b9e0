"""The frozen counts pinned to the bounds the program's ``cost()`` gave at the
repository's kernel table's shapes: 8 MiB of TRAFFIC and 1 MiB of e125 on
1024 chunks (ℓ = 37 of ℓp = 64, 18 classes; ℓ = 257 of ℓp = 288, 3 classes).
A drift of the benchmark's copy fails here."""

import _paths  # noqa: F401
import pytest

from bench import counts

TRAFFIC = dict(C=1024, k=8192, lp=64, n_tables=19, steps=8 << 20, ell=37)
E125 = dict(C=1024, k=1024, lp=288, n_tables=4, steps=1 << 20, ell=257)


def ms(c):
    return counts.seconds(*c) * 1e3


def test_peaks():
    assert counts.INT8_OPS == 1979e12 and counts.HBM_BW == 3.35e12


def test_k1_bounds():
    assert ms(counts.k1(**TRAFFIC)) == pytest.approx(0.4294, abs=5e-5)
    assert ms(counts.k1(**E125)) == pytest.approx(17.99, abs=5e-3)
    ops, nbytes = counts.k1(**TRAFFIC)
    assert ops / counts.INT8_OPS > nbytes / counts.HBM_BW        # bound by operations


def test_k2_bound():
    ops, nbytes = counts.k2(**TRAFFIC)
    assert ms((ops, nbytes)) == pytest.approx(0.0303, abs=5e-5)
    assert nbytes / counts.HBM_BW > ops / counts.INT8_OPS        # bound by bytes


def test_k3_bound():
    assert ms(counts.k3(1024, 64, 64, 64, 37)) == pytest.approx(0.0150, abs=5e-5)


def test_join_and_whole_step_counts():
    # the least join: two ℓ-vectors through each product, the stack read once
    ops, nbytes = counts.join(1024, 64, 37)
    assert ops == 2 * 2 * 1024 * 37 * 37 and nbytes == 4 * 1024 * (64 * 64 + 128)
    ops, nbytes = counts.parse(n=8 << 20, C=1024, k=8192, lp=64, n_tables=19, ell=37)
    assert ops == counts.k1(**TRAFFIC)[0] + counts.join(1024, 64, 37)[0] + counts.k2(**TRAFFIC)[0]
    assert nbytes == (8 << 20) + 4 * ((8 << 20) + 1) * 2
    # a parse's least time is at least each kernel's
    for k in (counts.k1(**TRAFFIC), counts.k2(**TRAFFIC)):
        assert counts.seconds(*counts.parse(8 << 20, 1024, 8192, 64, 19, 37)) >= k[0] / counts.INT8_OPS
    ops, nbytes = counts.append(65536, 65536, 64, 37)
    assert ops == 2 * 65536 * 37 ** 3 + 2 * 37 ** 3
