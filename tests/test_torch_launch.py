"""repro_torch's launch tools on one process, without a process group.

* ``launch/op_stats.py`` on programs of known cost, as
  ``tests/test_hlo_stats.py`` holds the reference's HLO analyzer: a matmul's
  dot flops exact; a 7-step loop 7× one step; a copy's bytes twice its size;
  a zamba2 smoke train step of 4 microbatches equal, field by field, to its
  1- and 2-microbatch traces extrapolated (exact: float sums of integers).
* Every kernel wrapper (K1–K7, K7 in each ``outputs`` mode) on fake tensors
  of the card (``FakeTensorMode``, device "cuda") and on meta tensors: no
  build and no launch (``ops.build`` raises if called; ``launches``
  unchanged), outputs of the shapes and dtypes the plain version gives on
  CPU tensors of the same shapes, and under a recorder one modeled launch
  whose cost is the kernel's bound formula, computed here again.
* ``ParserEngine.phase_static_cost`` on the ``torch`` backend against the
  reference's on ``jnp``, over the corpus of ``test_torch_corpus.py`` at
  buckets (4, 16) and (8, 64): the same keys, collective bytes 0 on both,
  reach flops within 2 % (the dot flops are the same products; the rest is
  one flop an output element in both models); the join's and build&merge's
  dot flops equal the count of the port's own products and mat-vecs
  (log-depth scan: 2·Σ_d 2(c − d)·ℓp³ + 4c·ℓp² + 2ℓp²; build&merge 4ck·ℓp²);
  bytes are each package's own model and are not compared.  On the kernel
  paths (engines on the meta device) the traces hold K1 / K4, K2 and, on
  ``cuda``, 2·⌈log₂ c⌉ + 3 K3 launches.
* ``Parser.stats()["hlo"]``: present where the reference's is (tracing on,
  ``hlo`` on; ``tests/test_obs.py``'s keys), the gauges in the registry;
  None with ``ObsConfig(hlo=False)``.
* A one-rank zamba2 smoke train step traced on meta tensors modeling the
  CPU has the dot flops ``FlopCounterMode`` counts when the same step runs
  on CPU tensors (exact); modeling the card, its K6 / K7 launches are the
  counts the real step makes on the CPU (its plain versions, counted).
* The lint over a traced step (``lint_trace``, the counterpart of
  ``lint_hlo_text``) finds a planted f64 and a planted ``.item()``.
"""

from __future__ import annotations

import math

import pytest

torch = pytest.importorskip("torch")

from test_torch_corpus import CORPUS, artifacts  # noqa: E402

from repro.core.engine import ParserEngine as RefEngine  # noqa: E402
from repro_torch import ObsConfig, Parser, ParserConfig  # noqa: E402
from repro_torch.analyze import analyze_compiled, collective_bytes, lint_trace  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core.backend import PackedBackend  # noqa: E402
from repro_torch.core.engine import ParserEngine  # noqa: E402
from repro_torch.kernels import cost as kcost  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import op_stats  # noqa: E402
from repro_torch.launch.mesh import ParseMesh  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.optim.adamw import init_opt_state  # noqa: E402
from repro_torch.parallel.sharding import MeshRules  # noqa: E402
from repro_torch.train import step  # noqa: E402

BUCKETS = [(4, 16), (8, 64)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# -------------------------------------------------------------- op_stats


def test_matmul_flops_and_bytes_exact():
    rec, _ = op_stats.trace(lambda a, b: a @ b, meta(256, 512), meta(512, 128))
    assert rec.stats.dot_flops == rec.stats.flops == 2 * 256 * 512 * 128
    assert rec.stats.bytes == 4 * (256 * 512 + 512 * 128 + 256 * 128)
    assert rec.stats.peak_bytes == 4 * (256 * 512 + 512 * 128 + 256 * 128)


def _loop(x, w, n):
    for _ in range(n):
        x = torch.tanh(x @ w)
    return x


def test_loop_counts_every_iteration():
    x, w = meta(128, 256), meta(256, 256)
    one = op_stats.trace(_loop, x, w, 1)[0].stats
    seven = op_stats.trace(_loop, x, w, 7)[0].stats
    assert seven.dot_flops == 7 * 2 * 128 * 256 * 256
    assert seven.flops == 7 * one.flops and seven.bytes == 7 * one.bytes
    # the live set does not grow with the loop: one x and one tanh at a time
    assert seven.peak_bytes == one.peak_bytes + 4 * 128 * 256


def test_copy_bytes_are_twice_its_size():
    rec, _ = op_stats.trace(lambda x: x.clone(), meta(1000))
    assert rec.stats.bytes == 2 * 4000 and rec.stats.flops == 0
    rec, _ = op_stats.trace(lambda x: x.view(10, 100).t(), meta(1000))
    assert rec.stats.bytes == 0                     # views move nothing


def _train_trace(cfg, accum: int, device: str):
    plan = step.TrainPlan(cfg=cfg, opt=step.AdamWConfig(), accum_steps=accum, microbatch=1,
                          seq_len=32, tp=1)
    mesh = ParseMesh((1,), ("data",))
    args = step.abstract_train_inputs(cfg, plan, mesh, MeshRules())
    rec = op_stats.OpRecorder(device)
    rec.track(args)
    with rec:
        step.make_train_step(plan, mesh, MeshRules())(*args)
    return rec


def test_scaled_body_equals_the_whole_trace():
    cfg = get_smoke("zamba2-2.7b")
    whole = _train_trace(cfg, 4, "cuda").stats
    scaled = op_stats.extrapolate(_train_trace(cfg, 1, "cuda").stats,
                                  _train_trace(cfg, 2, "cuda").stats, 4)
    assert whole.kernel_launches["ssd_chunk"] > 0
    for f in ("flops", "dot_flops", "bytes", "kernel_flops", "kernel_bytes", "n_ops",
              "coll_counts", "kernel_launches", "peak_bytes"):
        assert getattr(scaled, f) == getattr(whole, f), f


# ------------------------------------------------------------ the kernels


def _kernel_cases():
    """(wrapper, tensors (shape, dtype), static, the bound formula's
    (operations, bytes), case key)."""
    i32, f32, bf16 = torch.int32, torch.float32, torch.bfloat16
    A1, lp, C, k, W, S = 5, 64, 6, 16, 2, 8
    b, L, h, hd = 2, 48, 3, 32
    P, q, hp, n = 4, 16, 32, 16
    e = 2
    ops_y = q * (q + 1) * (n + hp) + 2 * q * n * hp
    ops_s = 2 * q * n * hp
    common = q * hp * e + 4 * q + q * n * e
    bytes_y = q * n * e + 4 * hp * n + 4 * q * hp
    bytes_s = 4 * n * hp
    ssd_in = [((P, q, hp), bf16), ((P, q, 1), f32), ((P, q, n), bf16), ((P, q, n), bf16),
              ((P, hp, n), f32)]
    cases = [
        (ops.reach_chunk_product, [((A1, lp, lp), f32), ((C, k), i32)], {},
         (2 * C * k * lp ** 3, 4 * (C * k + A1 * lp * lp + C * lp * lp)), None),
        (ops.build_merge_packed, [((A1, lp, lp), f32), ((C, k), i32), ((C, lp), f32),
                                  ((C, lp), f32)], {},
         (4 * C * k * lp * lp, 4 * (C * k + A1 * lp * lp + 2 * C * lp + C * k * W)), None),
        (ops.semiring_matmul, [((C, lp, lp), f32), ((C, lp, 1), f32)], {},
         (2 * C * lp * lp, 4 * C * (lp * lp + 2 * lp)), None),
        (ops.packed_reach_chunk_product, [((A1, lp, W), i32), ((C, k), i32)], {},
         (2 * C * k * lp ** 3, 4 * (C * k + A1 * lp * W + C * lp * W)), None),
        (ops.sparse_reach_rows, [((A1, lp, W), i32), ((C, k), i32), ((C, S, W), i32)], {},
         (2 * C * k * S * lp * lp, 4 * (C * k + A1 * lp * W + 2 * C * S * W)), None),
        (ops.flash_attention, [((b, L, h, hd), bf16)] * 3, {"causal": True, "window": None},
         (2 * L * (L + 1) * hd * b * h, 4 * b * L * h * hd * e), None),
        (ops.flash_attention, [((b, L, h, hd), bf16)] * 3, {"causal": True, "window": 8},
         (4 * hd * b * h * sum(min(i + 1, 8) for i in range(L)), 4 * b * L * h * hd * e), None),
    ]
    cases += [
        (ops.ssd_chunk, ssd_in, {"outputs": "both"},
         (P * (ops_y + ops_s), P * (common + bytes_y + bytes_s)), "both"),
        (ops.ssd_chunk, ssd_in, {"outputs": "y"}, (P * ops_y, P * (common + bytes_y)), "y"),
        (ops.ssd_chunk, ssd_in[:4] + [None], {"outputs": "state"},
         (P * ops_s, P * (common + bytes_s)), "state"),
    ]
    return cases


KERNEL_CASES = _kernel_cases()


def _outputs(out):
    outs = out if isinstance(out, tuple) else (out,)
    return [None if o is None else (tuple(o.shape), o.dtype) for o in outs]


@pytest.mark.parametrize("i", range(len(KERNEL_CASES)))
def test_kernel_on_fake_and_meta_tensors_models_one_launch(i, monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode

    kern, specs, static, (want_ops, want_bytes), case = KERNEL_CASES[i]

    def no_build():
        raise AssertionError("a tensor with no storage must not build a kernel")

    monkeypatch.setattr(ops, "build", no_build)
    gen = torch.Generator().manual_seed(i)
    real = [None if s is None else (
        torch.randint(0, 2, s[0], generator=gen).to(s[1]) if s[1] != torch.int32
        else torch.zeros(s[0], dtype=torch.int32)) for s in specs]
    want = _outputs(kern.plain(*real, **static))
    before = dict(ops.launch_counts())
    with FakeTensorMode():
        fake = [None if s is None else torch.empty(s[0], dtype=s[1], device="cuda")
                for s in specs]
        got = kern(*fake, **static)
        assert all(o is None or o.device.type == "cuda" for o in
                   (got if isinstance(got, tuple) else (got,)))
        assert _outputs(got) == want
    metas = [None if s is None else meta(*s[0], dtype=s[1]) for s in specs]
    rec, got = op_stats.trace(lambda *t: kern(*t, **static), *metas)
    assert _outputs(got) == want
    assert ops.launch_counts() == before
    assert rec.stats.kernel_launches[kern.name] == 1
    if case is not None:
        assert rec.stats.kernel_launches[f"{kern.name}/{case}"] == 1
    assert rec.stats.kernel_flops == want_ops and rec.stats.kernel_bytes == want_bytes
    c = kern._launcher.cost(*metas, **static)
    assert rec.stats.kernel_s == c.seconds == max(want_ops / c.rate, want_bytes / kcost.HBM_BW)
    # a recorder of the CPU runs the plain version on them instead
    rec_cpu, got = op_stats.trace(lambda *t: kern(*t, **static), *metas, device="cpu")
    assert _outputs(got) == want and not rec_cpu.stats.kernel_launches


def test_kernel_bounds_take_the_real_steps_and_states():
    from repro_torch.kernels import reach, sparse_reach

    N, ids = meta(5, 64, 64), meta(4, 32, dtype=torch.int32)
    assert reach.cost(N, ids, steps=100, ell=37).ops == 2 * 100 * 37 ** 3
    assert reach.cost(N, ids, steps=100, ell=37).bytes == reach.cost(N, ids).bytes
    R0 = meta(4, 8, 2, dtype=torch.int32)
    assert sparse_reach.cost(meta(5, 64, 2, dtype=torch.int32), ids, R0, steps=10, ell=37,
                             rows=2.5).ops == 2 * 10 * 2.5 * 37 * 37


# ------------------------------------------------------ phase static cost


def _scan_dot_flops(c: int, lp: int) -> int:
    levels = []
    d = 1
    while d < c:
        levels.append(c - d)
        d *= 2
    return 2 * sum(2 * m * lp ** 3 for m in levels) + 2 * 2 * c * lp * lp + 2 * lp * lp


_ref_engines: dict = {}


@pytest.mark.parametrize("bucket", BUCKETS)
@pytest.mark.parametrize("key", CORPUS)
def test_phase_static_cost_follows_the_reference(key, bucket):
    c, k = bucket
    if key not in _ref_engines:
        _ref_engines[key] = RefEngine(artifacts(key)[0].matrices, backend="jnp")
    ref = _ref_engines[key]
    port = ParserEngine(artifacts(key)[1], backend="torch", device="cpu")
    lp = port.tables.ell_pad
    assert lp == ref.tables.ell_pad
    got, want = port.phase_static_cost(c, k), ref.phase_static_cost(c, k)
    assert set(got) == set(want) == {"reach", "join", "build_merge", "total"}
    for phase in got:
        assert set(got[phase]) == set(want[phase])
        assert got[phase]["collective_bytes"] == want[phase]["collective_bytes"] == 0
    assert abs(got["reach"]["flops"] - want["reach"]["flops"]) <= 0.02 * want["reach"]["flops"]
    traces = port.phase_traces(c, k)
    assert traces["reach"].dot_flops == 2 * c * k * lp ** 3
    assert traces["join"].dot_flops == _scan_dot_flops(c, lp)
    assert traces["build_merge"].dot_flops == 4 * c * k * lp * lp
    assert got["total"]["flops"] == sum(got[p]["flops"] for p in ("reach", "join", "build_merge"))


@pytest.mark.parametrize("backend", ["cuda", "packed"])
def test_phase_traces_model_the_kernel_path(backend):
    be = PackedBackend(kernel=True) if backend == "packed" else backend
    eng = ParserEngine(artifacts("(a|b|ab)+")[1], backend=be, device="meta")
    c, k = 16, 64
    traces = eng.phase_traces(c, k)
    reach = "reach_chunk_product" if backend == "cuda" else "packed_reach_chunk_product"
    assert traces["reach"].kernel_launches == {reach: 1}
    assert traces["build_merge"].kernel_launches == {"build_merge_packed": 1}
    join = {"semiring_matmul": 2 * math.ceil(math.log2(c)) + 3} if backend == "cuda" else {}
    assert traces["join"].kernel_launches == join
    assert traces["reach"].dot_flops == 0 and traces["reach"].kernel_flops > 0


# ------------------------------------------------------------ stats["hlo"]


def _traced_parser(**obs):
    return Parser.from_matrices(artifacts("(ab|a)*")[1], ParserConfig(
        regex="<hlo>", backend="torch", n_chunks=4, obs={"enabled": True, **obs}),
        device="cpu")


def test_stats_attaches_hlo_static_cost():
    p = _traced_parser()
    p.parse("abab" * 8)
    hlo = p.stats()["hlo"]
    assert hlo, "traced parser with hlo=True must report static cost"
    for phases in hlo.values():
        assert set(phases) == {"reach", "join", "build_merge", "total"}
        assert phases["total"]["flops"] > 0 and phases["total"]["bytes"] > 0
    gauges = p.stats()["metrics"]
    for name in ("hlo_flops", "hlo_bytes", "hlo_collective_bytes"):
        assert {(g["labels"]["bucket"], g["labels"]["phase"]) for g in gauges[name]} == {
            (b, ph) for b in hlo for ph in ("reach", "join", "build_merge")}


def test_hlo_off_by_config_or_untraced():
    p = _traced_parser(hlo=False)
    p.parse("abab")
    assert p.stats()["hlo"] is None
    q = Parser.from_matrices(artifacts("(ab|a)*")[1], ParserConfig(
        regex="<hlo>", backend="torch", n_chunks=4, obs=ObsConfig(enabled=False)), device="cpu")
    q.parse("abab")
    assert q.stats()["hlo"] is None


# ------------------------------------------------- traced steps and the lint


def test_one_rank_step_dot_flops_and_launches_equal_the_real_step(monkeypatch):
    from torch.utils.flop_counter import FlopCounterMode

    cfg = get_smoke("zamba2-2.7b")
    plan = step.TrainPlan(cfg=cfg, opt=step.AdamWConfig(), accum_steps=2, microbatch=1,
                          seq_len=32, tp=1)
    mesh = ParseMesh((1,), ("data",))
    params = init_params(cfg, 0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 1, 32), generator=torch.Generator()
                           .manual_seed(0)).to(torch.int32)
    counts: dict = {}
    real_run = ops.KernelWrapper.run

    def counting(self, *t, **static):
        if all(x is None or x.device.type == "cpu" for x in t):
            key = self.name if self._case is None else f"{self.name}/{static.get(*self._case)}"
            for name in {self.name, key}:
                counts[name] = counts.get(name, 0) + 1
        return real_run(self, *t, **static)

    monkeypatch.setattr(ops.KernelWrapper, "run", counting)
    with FlopCounterMode(display=False) as fc:
        step.make_train_step(plan, mesh, MeshRules())(params, init_opt_state(params),
                                                       {"tokens": tokens})
    assert _train_trace(cfg, 2, "cpu").stats.dot_flops == fc.get_total_flops()
    assert _train_trace(cfg, 2, "cuda").stats.kernel_launches == counts


def test_lint_catches_planted_f64_and_item(monkeypatch):
    from repro_torch.models import model

    cfg = get_smoke("tinyllama-1.1b")
    clean = _train_trace(cfg, 1, "cuda")
    assert lint_trace(clean.ops, "clean") == []
    real = model.forward_train

    def planted(params, micro, *a, **kw):
        total, metrics = real(params, micro, *a, **kw)
        if float(total.detach().sum()) > 1e30:                 # a host read
            total = total * 2
        return total + total.double().float() * 0, metrics      # an f64 round trip

    monkeypatch.setattr(step, "forward_train", planted)
    rules = {f.rule for f in lint_trace(_train_trace(cfg, 1, "cuda").ops, "planted")}
    assert rules == {"f64", "host-sync"}


def test_roofline_of_a_trace_has_the_reference_keys():
    s = op_stats.OpStats(flops=4e12, dot_flops=3e12, bytes=2e12, peak_bytes=5e9)
    s.coll["all-gather"], s.coll_counts["all-gather"] = 1e9, 3
    r = analyze_compiled(s, arch="a", shape="s", mesh_name="pod", chips=256, model_flops=1e14)
    assert r.hlo_flops == 4e12 * 256 and r.coll_bytes == 1e9 * 256
    assert r.memory_per_device == 5e9 and r.coll_detail["coll_ops_per_device"] == 3
    assert set(r.to_dict()) == {
        "arch", "shape", "mesh", "chips", "hlo_flops", "hlo_bytes", "coll_bytes",
        "coll_detail", "model_flops", "memory_per_device", "t_compute", "t_memory",
        "t_collective", "bottleneck", "useful_ratio", "roofline_fraction"}
    cb = collective_bytes(s)
    assert cb["all-gather"] == 1e9 and cb["_counts"]["all-gather"] == 3
    assert set(cb) == set(op_stats.COLLECTIVE_KINDS) | {"_counts"}


def test_meta_like_keeps_shapes_dtypes_and_strides():
    t = torch.zeros(3, 4).t()
    m = op_stats.meta_like({"a": (t, 5)})
    assert m["a"][0].device.type == "meta" and m["a"][0].stride() == t.stride()
    assert m["a"][1] == 5
