"""repro_torch's mesh distribution against repro's, on the CPU.

Two tiers, as ``tests/test_distributed.py``:

  * 1-rank cases: each 1-device case of the reference runs on the port's
    1-rank mesh (no process group) against ``repro``'s
    ``ParserEngine(mesh=make_parse_mesh())`` on its 1-device CPU mesh, on
    ``torch`` / ``packed`` / ``sparse`` ↔ ``jnp`` / ``packed`` / ``sparse``:
    ``SLPF.pack()``, ``count_trees()``, ``accepted``, the geometry tuples and
    ``allgather_payload_bytes_total`` bit for bit.  Also ``MeshRules``,
    ``spec_axes``, ``divisible`` and the mesh functions against the
    reference's.
  * 4 gloo ranks on a (2, 2) ('pod', 'data') mesh, one process a rank
    (``@pytest.mark.slow``): the reference's 8-device cases (chunk-sharded
    ``parse``, batch × chunk ``parse_batch``, sharded streaming appends,
    ``ParseService(mesh=...)``) and a deadline that every rank must reject
    alike.  Every rank's ``pack()`` must equal the JAX single-device
    engine's and ``parse_serial_matrix``'s columns, and
    ``allgather_payload_bytes_total`` the reference's on a (2, 2) mesh of
    forced host devices.  A counting wrapper around the collectives shows
    one product-stack gather and one column gather a dispatch, and no
    ``all_reduce``, ``all_to_all`` or ``reduce_scatter``.

Tolerance is zero: OR-AND on {0,1} is exact.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_corpus import artifacts  # noqa: E402

import repro.core.engine as ref_engine_mod  # noqa: E402
from repro.core.distributed import DistributedEngine as RefDist  # noqa: E402
from repro.core.serial import parse_serial_matrix  # noqa: E402
from repro.core.stream import StreamingParser as RefStream  # noqa: E402
from repro.launch import mesh as ref_mesh  # noqa: E402
from repro.parallel import sharding as ref_sharding  # noqa: E402
from repro.serve.parse_service import ParseService as RefService  # noqa: E402
from repro_torch.core.distributed import DistributedEngine  # noqa: E402
from repro_torch.core.engine import ParserEngine  # noqa: E402
from repro_torch.core.scan import linear_index  # noqa: E402
from repro_torch.core.stream import StreamingParser  # noqa: E402
from repro_torch.launch import mesh as port_mesh  # noqa: E402
from repro_torch.parallel import sharding as port_sharding  # noqa: E402
from repro_torch.serve.parse_service import ParseService  # noqa: E402

AMBIG = "(a|b|ab)+"
# mixed-length, empty, ambiguous and non-matching inputs (the reference's set)
TEXTS = ["abab", "", "b", "ab" * 13, "a" * 17, "ba" * 3, "aabb" * 5, "x"]
BACKENDS = [("torch", "jnp"), ("packed", "packed"), ("sparse", "sparse")]
PAYLOAD = "allgather_payload_bytes_total"
SRC = Path(__file__).resolve().parents[1] / "src"

_cache: dict = {}


def _payload(engine) -> float:
    return engine.obs.metrics.counter(PAYLOAD).value


def mesh_pair(backend: str):
    """(port mesh engine, reference mesh engine), each fresh."""
    art, port_m, _ = artifacts(AMBIG)
    return (
        ParserEngine(port_m, backend=backend, device="cpu", mesh=port_mesh.make_parse_mesh()),
        ref_engine_mod.ParserEngine(
            art.matrices, backend=dict(BACKENDS)[backend], mesh=ref_mesh.make_parse_mesh()
        ),
    )


def plain_ref():
    if "ref" not in _cache:
        _cache["ref"] = ref_engine_mod.ParserEngine(artifacts(AMBIG)[0].matrices)
    return _cache["ref"]


# --------------------------------------------------------- rules and meshes


LOGICAL = [("chunk",), ("batch", "chunk"), ("batch", "seq", "heads"), ("chunk", "batch"),
           ("fsdp", "mlp"), ("seq",), (None, "chunk"), (("data", "pod"), "batch"), ()]


@pytest.mark.parametrize("logical", LOGICAL)
def test_mesh_rules_resolve_like_the_reference(logical):
    ref_m = ref_mesh.make_parse_mesh()
    port_m = port_mesh.make_parse_mesh()
    for overrides in ({}, {"batch": "data"}, {"chunk": ("data", "pod")}, {"chunk": None}):
        ref_r = ref_sharding.MeshRules().with_overrides(**overrides)
        port_r = port_sharding.MeshRules().with_overrides(**overrides)
        assert port_r.rules == ref_r.rules
        for rm, pm in ((ref_m, port_m), (None, None)):
            want, got = ref_r.resolve(logical, rm), port_r.resolve(logical, pm)
            assert tuple(got) == tuple(want), (logical, overrides)
            assert isinstance(got, port_sharding.PartitionSpec)
            for dim in range(len(logical) + 1):
                assert port_sharding.spec_axes(got, dim) == ref_sharding.spec_axes(want, dim)
            for name in logical:
                if isinstance(name, str):
                    assert port_r.resolve_axes(name, pm) == ref_r.resolve_axes(name, rm)


def test_partition_spec_is_an_immutable_value():
    spec = port_sharding.PartitionSpec("pod", None, ("pod", "data"))
    assert spec == port_sharding.PartitionSpec("pod", None, ("pod", "data"))
    assert hash(spec) == hash(tuple(spec)) and len(spec) == 3
    assert repr(spec) == "PartitionSpec('pod', None, ('pod', 'data'))"
    with pytest.raises(TypeError):
        spec[0] = "data"


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_divisible_like_the_reference(n):
    ref_m, port_m = ref_mesh.make_parse_mesh(), port_mesh.make_parse_mesh()
    for axis in (None, "pod", "data", ("pod", "data"), "model"):
        assert port_sharding.divisible(n, port_m, axis) == ref_sharding.divisible(n, ref_m, axis)


def test_one_rank_meshes_match_the_reference():
    """With no process group every mesh function gives the reference's 1-device
    mesh: the same axes, sizes and chip count, coordinate 0, no group."""
    assert not torch.distributed.is_initialized()
    for ref_m, port_m in (
        (ref_mesh.make_parse_mesh(), port_mesh.make_parse_mesh()),
        (ref_mesh.make_parse_mesh(max_pods=4), port_mesh.make_parse_mesh(max_pods=4)),
        (ref_mesh.make_host_mesh(), port_mesh.make_host_mesh()),
        (ref_mesh.make_host_mesh((2, 2), ("pod", "data")),
         port_mesh.make_host_mesh((2, 2), ("pod", "data"))),
    ):
        assert port_m.axis_names == tuple(ref_m.axis_names)
        assert port_m.shape == dict(ref_m.shape)
        assert port_mesh.mesh_chips(port_m) == ref_mesh.mesh_chips(ref_m)
        for axes in ((), ("pod",), tuple(port_m.axis_names)):
            axes = tuple(a for a in axes if a in port_m.shape)
            assert port_mesh.mesh_axes_size(port_m, axes) == ref_mesh.mesh_axes_size(ref_m, axes)
            assert linear_index(port_m, axes) == 0
            assert port_m.group(axes) is None and port_m.members(axes) == [0]
        assert port_m.coordinate == {a: 0 for a in port_m.axis_names}
        assert port_m.backend is None and port_m.device_mesh is None


def test_mesh_shape_needs_a_process_group():
    with pytest.raises(ValueError, match="process group"):
        port_mesh.ParseMesh((2, 1), ("pod", "data"))
    with pytest.raises(ValueError, match="does not match"):
        port_mesh.ParseMesh((1,), ("pod", "data"))
    with pytest.raises(ValueError, match="not distinct axes"):
        port_mesh.make_parse_mesh().group(("pod", "pod"))


# ------------------------------------------------------ 1-rank mesh routes


@pytest.mark.parametrize("backend", [b for b, _ in BACKENDS])
def test_mesh_geometry_equals_reference(backend):
    port, ref = mesh_pair(backend)
    for attr in ("chunk_axes", "batch_axes", "batch_chunk_axes", "chunk_devices",
                 "batch_devices", "batch_chunk_devices"):
        assert getattr(port.dist, attr) == getattr(ref.dist, attr), attr
    assert port.dist._product_nbytes() == ref.dist._product_nbytes()
    assert port.dist.transport == "local"


@pytest.mark.parametrize("backend", [b for b, _ in BACKENDS])
def test_mesh_route_parse_batch_matches_reference(backend):
    art = artifacts(AMBIG)[0]
    port, ref = mesh_pair(backend)
    got, want = port.parse_batch(TEXTS), ref.parse_batch(TEXTS)
    for t, g, w in zip(TEXTS, got, want):
        assert np.array_equal(g.pack(), w.pack()), t
        assert np.array_equal(g.columns, parse_serial_matrix(art.matrices, t).columns), t
        assert g.count_trees() == w.count_trees() and g.accepted == w.accepted, t
    assert _payload(port) == _payload(ref) > 0


@pytest.mark.parametrize("backend", [b for b, _ in BACKENDS])
def test_mesh_route_single_parse_matches_reference(backend):
    port, ref = mesh_pair(backend)
    for t in TEXTS:
        got, want = port.parse(t), ref.parse(t)
        assert np.array_equal(got.pack(), want.pack()), t
        assert got.count_trees() == want.count_trees() and got.accepted == want.accepted, t
    got, want = port.parse("ab" * 40, n_chunks=3), ref.parse("ab" * 40, n_chunks=3)
    assert np.array_equal(got.pack(), want.pack())
    assert _payload(port) == _payload(ref) > 0


@pytest.mark.parametrize("backend", [b for b, _ in BACKENDS])
def test_streaming_on_mesh_engine(backend):
    """Sharded streaming: every state equal to the reference's mesh stream
    and to a cold parse; the same payload counted."""
    port, ref = mesh_pair(backend)
    sp, rp = StreamingParser(port, first_seal_len=4), RefStream(ref, first_seal_len=4)
    prefix = ""
    for piece in ["ab", "ab", "", "abab", "ba", "ab" * 8, "x"]:
        sp.append(piece)
        rp.append(piece)
        prefix += piece
        got = sp.current_slpf()
        assert np.array_equal(got.pack(), rp.current_slpf().pack()), piece
        assert np.array_equal(got.pack(), plain_ref().parse(prefix).pack()), piece
        assert sp.accepted == rp.accepted, piece
    assert _payload(port) == _payload(ref) > 0


@pytest.mark.parametrize("backend", [b for b, _ in BACKENDS])
def test_stream_edit_on_mesh_engine(backend):
    """Mid-text splices on a mesh engine: the leaf frontier stays the
    all-gather payload; every state equal to the reference's and to cold."""
    port, ref = mesh_pair(backend)
    sp = StreamingParser(port, first_seal_len=4, max_seal_len=8)
    rp = RefStream(ref, first_seal_len=4, max_seal_len=8)
    text = "ab" * 14
    sp.append(text)
    rp.append(text)
    for lo, hi, repl in [(5, 9, "ba"), (0, 2, ""), (10, 10, "abab")]:
        text = text[:lo] + repl + text[hi:]
        assert sp.edit(lo, hi, repl) == rp.edit(lo, hi, repl) == len(text)
        got = sp.current_slpf()
        assert np.array_equal(got.pack(), rp.current_slpf().pack()), (lo, hi)
        assert np.array_equal(got.pack(), plain_ref().parse(text).pack()), (lo, hi)
        assert sp.accepted == rp.accepted, (lo, hi)
    assert _payload(port) == _payload(ref) > 0


@pytest.mark.parametrize("backend", [b for b, _ in BACKENDS])
def test_standalone_distributed_engine(backend):
    art, port_m, _ = artifacts(AMBIG)
    dist = DistributedEngine(port_m, port_mesh.make_parse_mesh(), backend=backend, device="cpu")
    ref = RefDist(art.matrices, ref_mesh.make_parse_mesh(), backend=dict(BACKENDS)[backend])
    assert dist.engine.mesh is None
    for t, g, w in zip(TEXTS[:4], dist.parse_batch(TEXTS[:4]), ref.parse_batch(TEXTS[:4])):
        assert np.array_equal(g.pack(), w.pack()), t
    assert np.array_equal(dist.parse(TEXTS[3]).pack(), ref.parse(TEXTS[3]).pack())
    assert _payload(dist.engine) == _payload(ref.engine) > 0


def test_prebuilt_engine_rejects_mesh_kwarg():
    art, port_m, _ = artifacts(AMBIG)
    port = ParserEngine(port_m, backend="torch", device="cpu")
    with pytest.raises(ValueError):
        RefService(plain_ref(), mesh=ref_mesh.make_parse_mesh())
    with pytest.warns(DeprecationWarning), pytest.raises(ValueError, match="mesh"):
        ParseService(port, mesh=port_mesh.make_parse_mesh())


def test_traced_mesh_parse_reports_one_device_span():
    from repro_torch import Parser, ParserConfig

    p = Parser(ParserConfig(regex=AMBIG, backend="torch", mesh="host",
                            obs={"enabled": True}), device="cpu")
    r = p.parse("abab")
    names = [s.name for s in p.obs.tracer.spans]
    assert "phase.device_parse" in names and "phase.reach" not in names
    assert np.array_equal(r.forest.pack(), plain_ref().parse("abab").pack())
    assert p.stats()["hlo"] is None


# ----------------------------------------------------- 4 gloo ranks, (2, 2)

RANK_CODE = r"""
import json, sys, warnings
warnings.simplefilter("ignore")
import numpy as np, torch, torch.distributed as dist
rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world)
from repro_torch import Parser, ParserConfig
from repro_torch.core.matrices import build_matrices
from repro_torch.core.segments import compute_segments
from repro_torch.core.stream import StreamingParser
from repro_torch.errors import AdmissionError
from repro_torch.launch.mesh import ParseMesh, make_host_mesh, make_parse_mesh
from repro_torch.serve.parse_service import ParseService

calls = {}
for name in ("all_gather", "all_gather_into_tensor", "all_reduce", "all_to_all",
             "all_to_all_single", "reduce_scatter", "reduce_scatter_tensor", "broadcast"):
    def counted(*a, _fn=getattr(dist, name), _name=name, **k):
        calls[_name] = calls.get(_name, 0) + 1
        return _fn(*a, **k)
    setattr(dist, name, counted)

def delta(fn):
    before = dict(calls)
    out = fn()
    return out, {k: v - before.get(k, 0) for k, v in calls.items() if v != before.get(k, 0)}

TEXTS = json.loads(sys.argv[5])
PIECES = json.loads(sys.argv[6])
packs, report = {}, {}
for be in ("torch", "packed", "sparse"):
    p = Parser(ParserConfig(regex="(a|b|ab)+", backend=be, mesh="host", n_chunks=4), device="cpu")
    d = p.engine.dist
    rep = {"geometry": [list(d.chunk_axes), list(d.batch_axes), list(d.batch_chunk_axes)],
           "shape": p.engine.mesh.shape, "transport": d.transport, "calls": {}}
    for i, t in enumerate(TEXTS):
        r, c = delta(lambda: p.parse(t))
        packs[f"{be}/parse/{i}"] = r.forest.pack()
        packs[f"{be}/columns/{i}"] = r.forest.columns
        rep["calls"][f"parse/{i}"] = c
    rs, c = delta(lambda: p.parse_batch(TEXTS))
    rep["calls"]["batch"] = c
    for i, r in enumerate(rs):
        packs[f"{be}/batch/{i}"] = r.forest.pack()
    sp = StreamingParser(p.engine, first_seal_len=4)
    for j, piece in enumerate(PIECES):
        sp.append(piece)
        s, c = delta(sp.current_slpf)
        packs[f"{be}/stream/{j}"] = s.pack()
        rep["calls"][f"stream/{j}"] = c
        rep.setdefault("accepted", []).append(bool(sp.accepted))
    svc = ParseService(build_matrices(compute_segments("(a|b|ab)+")), backend=be,
                       device="cpu", mesh=make_parse_mesh(), max_batch=8, n_chunks=4)
    rids = [svc.submit(t) for t in TEXTS]
    done, c = delta(svc.run)
    rep["calls"]["service"] = c
    done = {q.rid: q for q in done}
    for i, rid in enumerate(rids):
        packs[f"{be}/service/{i}"] = done[rid].slpf.pack()
    rep["payload"] = p.obs.metrics.counter("allgather_payload_bytes_total").value
    rep["service_payload"] = svc.engine.obs.metrics.counter("allgather_payload_bytes_total").value
    # a warm bucket, then a deadline no rank can meet: rank 0's p99 decides on
    # every rank, so the ranks whose own window is empty reject as well
    p.parse(TEXTS[3])
    if rank != 0:
        p.parse_service._buckets.clear()
    try:
        p.parse(TEXTS[3], deadline_s=1e-9)
        rep["deadline"] = "admitted"
    except AdmissionError:
        rep["deadline"] = "AdmissionError"
    packs[f"{be}/after_deadline"] = p.parse(TEXTS[3]).forest.pack()
    report[be] = rep
# chunks over ('data', 'pod'): a linear order that is not the group's rank order
q = Parser(ParserConfig(regex="(a|b|ab)+", backend="torch", mesh="host", n_chunks=4,
                        mesh_rules={"chunk": ["data", "pod"]}), device="cpu")
report["swapped_axes"] = list(q.engine.dist.chunk_axes)
for i, t in enumerate(TEXTS):
    packs[f"swapped/parse/{i}"] = q.parse(t).forest.pack()
# a 3-axis mesh: one axis's group, the whole group, and a group that would leave ranks out
m3 = make_host_mesh((2, 2, 1), ("a", "b", "c"))
report["m3"] = {"coordinate": m3.coordinate, "b": m3.members(("b",)),
                "ab": m3.members(("b", "a")), "c": m3.members(("c",))}
try:
    m3.group(("a", "c"))
    report["m3"]["ac"] = "group"
except ValueError:
    report["m3"]["ac"] = "ValueError"
np.savez(f"{out}/rank{rank}.npz", **packs)
with open(f"{out}/rank{rank}.json", "w") as fh:
    json.dump(report, fh)
dist.destroy_process_group()
"""

REF_CODE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
from repro.core.engine import ParserEngine
from repro.core.reference import ParallelArtifacts
from repro.core.stream import StreamingParser
from repro.launch.mesh import make_mesh_compat
from repro.serve.parse_service import ParseService
TEXTS = json.loads(sys.argv[1]); PIECES = json.loads(sys.argv[2])
art = ParallelArtifacts.generate("(a|b|ab)+")
out = {}
for be in ("jnp", "packed", "sparse"):
    mesh = make_mesh_compat((2, 2), ("pod", "data"))
    eng = ParserEngine(art.matrices, backend=be, mesh=mesh)
    for t in TEXTS:
        eng.parse(t, n_chunks=4)
    eng.parse_batch(TEXTS, n_chunks=4)
    sp = StreamingParser(eng, first_seal_len=4)
    for piece in PIECES:
        sp.append(piece); sp.current_slpf()
    svc = ParseService(art.matrices, backend=be, mesh=mesh, max_batch=8, n_chunks=4)
    for t in TEXTS:
        svc.submit(t)
    svc.run()
    c = "allgather_payload_bytes_total"
    out[be] = [eng.obs.metrics.counter(c).value, svc.engine.obs.metrics.counter(c).value]
print(json.dumps(out))
"""

PIECES = ["ab", "ab", "abab", "ba", "ab" * 10, ""]


@pytest.mark.slow
def test_four_gloo_ranks_on_a_2x2_mesh(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    texts, pieces = json.dumps(TEXTS), json.dumps(PIECES)
    store = tmp_path / "store"
    ranks = [
        subprocess.Popen(
            [sys.executable, "-c", RANK_CODE, str(r), "4", str(store), str(tmp_path), texts,
             pieces],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for r in range(4)
    ]
    ref = subprocess.Popen([sys.executable, "-c", REF_CODE, texts, pieces], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    outs = []
    try:
        for proc in ranks + [ref]:
            outs.append(proc.communicate(timeout=300))
    finally:
        for proc in ranks + [ref]:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for proc, (_, err) in zip(ranks + [ref], outs):
        assert proc.returncode == 0, err[-3000:]
    ref_payload = json.loads(outs[-1][0].strip().splitlines()[-1])

    art = artifacts(AMBIG)[0]
    jax_eng = plain_ref()
    want = {f"parse/{i}": jax_eng.parse(t).pack() for i, t in enumerate(TEXTS)}
    want.update({f"batch/{i}": w.pack() for i, w in enumerate(jax_eng.parse_batch(TEXTS))})
    want.update({f"service/{i}": want[f"parse/{i}"] for i in range(len(TEXTS))})
    prefix, accepted = "", []
    for j, piece in enumerate(PIECES):
        prefix += piece
        cold = jax_eng.parse(prefix)
        want[f"stream/{j}"] = cold.pack()
        accepted.append(bool(cold.accepted))
    want["after_deadline"] = want["parse/3"]
    serial = [parse_serial_matrix(art.matrices, t).columns for t in TEXTS]

    for r in range(4):
        packs = np.load(tmp_path / f"rank{r}.npz")
        report = json.loads((tmp_path / f"rank{r}.json").read_text())
        for be, ref_be in BACKENDS:
            for key, w in want.items():
                assert np.array_equal(packs[f"{be}/{key}"], w), (r, be, key)
            rep = report[be]
            assert rep["geometry"] == [["pod", "data"], ["data"], ["pod"]]
            assert rep["shape"] == {"pod": 2, "data": 2} and rep["transport"] == "gloo:cpu"
            assert rep["accepted"] == accepted
            assert rep["deadline"] == "AdmissionError", (r, be)
            assert [rep["payload"], rep["service_payload"]] == ref_payload[ref_be], (r, be)
            for key, c in rep["calls"].items():
                # one product-stack gather + one column gather a dispatch (the
                # streaming join: the product gather alone); no reductions
                n = 1 if key.startswith("stream") else 2
                assert set(c) <= {"all_gather"}, (r, be, key, c)
                assert c.get("all_gather", 0) in ((0, n) if key.startswith("stream") else (n,)), (
                    r, be, key, c)
            assert rep["calls"]["batch"]["all_gather"] == rep["calls"]["service"]["all_gather"]
            for i, t in enumerate(TEXTS):
                assert np.array_equal(packs[f"{be}/columns/{i}"], serial[i]), (r, be, t)
        assert report["swapped_axes"] == ["data", "pod"]
        a, b = divmod(r, 2)
        assert report["m3"] == {"coordinate": {"a": a, "b": b, "c": 0}, "b": [2 * a, 2 * a + 1],
                                "ab": [0, 1, 2, 3], "c": [r], "ac": "ValueError"}, report["m3"]
        for i, t in enumerate(TEXTS):
            assert np.array_equal(packs[f"swapped/parse/{i}"], want[f"parse/{i}"]), (r, t)
