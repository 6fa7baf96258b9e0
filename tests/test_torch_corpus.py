"""Shared corpus of the repro ↔ repro_torch parity tests (tests/test_torch_*.py).

The conformance corpus of ``tests/test_conformance.py``: three fixed patterns
and REgen-random patterns from seeds 11, 23 and 47.  Each key yields the
reference's artifacts and the port's matrices built from the same AST, plus
a deterministic text set (empty, valid, corrupted, non-matching).  Helpers
carry a reference engine's tables into the port and compare packed words.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import regex as ref_rx  # noqa: E402
from repro.core.numbering import number_regex as ref_number_regex  # noqa: E402
from repro.core.reference import ParallelArtifacts  # noqa: E402
from repro.core.segments import compute_segments as ref_compute_segments  # noqa: E402
from repro.data.regen import random_regex, sample_string  # noqa: E402
from repro_torch.core import regex as port_rx  # noqa: E402
from repro_torch.core.engine import EngineTables  # noqa: E402
from repro_torch.core.matrices import build_matrices as port_build_matrices  # noqa: E402
from repro_torch.core.numbering import number_regex as port_number_regex  # noqa: E402
from repro_torch.core.segments import compute_segments as port_compute_segments  # noqa: E402

FIXED_PATTERNS = ["(ab|a)*", "(a|b|ab)+", "x(yz|y)*z?"]
RANDOM_SEEDS = [11, 23, 47]
CORPUS = FIXED_PATTERNS + [f"seed:{s}" for s in RANDOM_SEEDS]
N_CHUNKS = 4

_cache: dict = {}


def to_port_ast(node):
    """The same regex AST, rebuilt from repro_torch's node classes."""
    if isinstance(node, tuple):
        return tuple(to_port_ast(x) for x in node)
    if not isinstance(node, ref_rx.Node):
        return node
    cls = getattr(port_rx, type(node).__name__)
    return cls(**{f.name: to_port_ast(getattr(node, f.name)) for f in dataclasses.fields(node)})


def artifacts(key):
    """(reference ParallelArtifacts, port ParserMatrices, reference AST or None)."""
    if key not in _cache:
        if key.startswith("seed:"):
            rng = np.random.Generator(np.random.Philox(int(key[5:])))
            ast = random_regex(7, rng)
            art = ParallelArtifacts.generate(ref_compute_segments(ref_number_regex(ast)))
            port = port_build_matrices(port_compute_segments(port_number_regex(to_port_ast(ast))))
        else:
            ast = None
            art = ParallelArtifacts.generate(key)
            port = port_build_matrices(port_compute_segments(key))
        _cache[key] = (art, port, ast)
    return _cache[key]


def texts(key, max_len=24):
    """Deterministic texts for one key: empty, short valid prefixes, a long
    valid text, a corrupted one, and one outside every alphabet."""
    _, _, ast = artifacts(key)
    rng = np.random.Generator(np.random.Philox(zlib.crc32(key.encode())))
    node = ast if ast is not None else ref_rx.parse_regex(key)
    long = b""
    while len(long) < max_len:
        long += sample_string(node, rng, max_rep=3)
    out = [b"", long[:1], b"~", long[:4], long[:6], long,
           long[: len(long) // 2] + b"~" + long[len(long) // 2:]]
    return list(dict.fromkeys(out))


def carried_tables(ref_engine):
    """The reference engine's padded tables as the port's, on the CPU."""
    t = ref_engine.tables
    return EngineTables.from_arrays(
        np.asarray(t.N), np.asarray(t.I), np.asarray(t.F), np.asarray(t.byte_to_class),
        t.ell, t.pad_class, device="cpu",
    )


def u32(x):
    """Packed words of either package as a uint32 numpy array."""
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x).view(np.uint32)


def i32(x):
    """uint32 words (a numpy or JAX array) as the port's int32 tensor."""
    return torch.from_numpy(np.array(x, dtype=np.uint32).view(np.int32))


@pytest.mark.parametrize("key", CORPUS)
def test_corpus_texts_are_deterministic_and_cover_edges(key):
    got = texts(key)
    assert got == texts(key)
    assert got[0] == b"" and any(b"~" in t for t in got)
    assert len(got) == len(set(got))


# ------------------------------------------- K1's group table, walked in torch


def _walk_group_table(T, ids, g, lp):
    """Chunk products from a column walk over K1's group table, as the group
    kernel walks it: column j starts as e_j, and a step ORs, over the g-bit
    groups of the column, the table entry that the group's value selects."""
    from repro_torch.core.matrices import packed_identity, unpack_bits_torch

    C, k = ids.shape
    W, V = lp // 32, 1 << g
    starts = torch.arange(0, lp, g)
    word, bit = starts // 32, (starts % 32).to(torch.int32)
    cols = packed_identity(lp).expand(C, lp, W).clone()            # (C, column j, W)
    chunk = torch.arange(C)[:, None, None]
    group = torch.arange(lp // g)[None, None, :]
    for t in range(k):
        v = (cols[:, :, word] >> bit) & (V - 1)                   # (C, ℓp, ℓp/g)
        entries = T[ids[:, t]][chunk, group, v.long()][..., :W]    # (C, ℓp, ℓp/g, W)
        new = torch.zeros_like(cols)
        for gi in range(entries.shape[2]):
            new |= entries[:, :, gi]
        cols = new
    return unpack_bits_torch(cols, lp).transpose(1, 2).to(torch.float32)


_reach_cache: dict = {}


@pytest.mark.parametrize("key", CORPUS)
@pytest.mark.parametrize("g", [4, 2])                  # the group kernel's widths
def test_group_table_walk_equals_reach_plain_and_pallas(key, g):
    """K1's group table (``kernels/reach.py::group_table``, built in torch),
    walked column by column, gives the chunk products of the plain version
    and of the reference's Pallas reach kernel (interpret mode) on the
    corpus's tables, PAD steps and all."""
    import jax.numpy as jnp

    from repro.core.engine import EngineTables as RefTables
    from repro.kernels import ops as ref_ops
    from repro_torch.kernels import reach as reach_launcher
    from repro_torch.kernels.ref import reach_chunk_product_ref

    if key not in _reach_cache:
        art, _, _ = artifacts(key)
        N = np.asarray(RefTables.from_matrices(art.matrices, lane_pad=128).N)
        rng = np.random.Generator(np.random.Philox(zlib.crc32(key.encode())))
        ids = rng.integers(0, N.shape[0], size=(2, 9)).astype(np.int32)
        ids[1, 6:] = N.shape[0] - 1                                # a PAD-ended chunk
        pallas = np.stack([np.asarray(ref_ops.reach_chunk_product(jnp.asarray(N),
                                                                  jnp.asarray(row)))
                           for row in ids])
        _reach_cache[key] = (N, ids, pallas)
    N, ids, pallas = _reach_cache[key]
    lp = N.shape[-1]
    T = reach_launcher.group_table(torch.tensor(N), g)
    assert T.shape == (N.shape[0], lp // g, 1 << g, (lp // 32) | 1)
    got = _walk_group_table(T, torch.tensor(ids).long(), g, lp)
    assert torch.equal(got, reach_chunk_product_ref(torch.tensor(N), torch.tensor(ids)))
    assert np.array_equal(got.numpy(), pallas)
