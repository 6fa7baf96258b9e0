#!/usr/bin/env python3
"""Time K1–K7 of one tree of the PyTorch/CUDA port on one NVIDIA GPU, as
``chip_smoke.py`` times them, and read K6's and K7's errors against their
plain versions.

    python3 scripts/torch_kernel_times.py [--tree DIR] [--parts k1,k2,k3,k4,k5,k6,k7,k7f,join,walk]

``--tree`` is the root of a checkout of this repository (default: the one
holding this script).  Its ``src/repro_torch`` is imported and its kernels
are built there, while the timing code is this script's and
``chip_smoke.py``'s, so an earlier commit unpacked with ``git archive`` into
a directory that ``.gitignore`` lists is measured exactly as the current
one.  To compare two trees, run parent, change, change, parent
on one card, one after another.  Prints one JSON line per record:

  k3  ``semiring_matmul`` at the first join level of chip_smoke.py's TRAFFIC
      (8 MiB) and e125 (1 MiB) texts, 1024 chunks: the compose
      (1023, ℓp, ℓp)², the mat-vec (n = 1) and the vec-mat (m = 1), each
      beside ``torch.clamp(torch.bmm(a, b), max=1)``.  ``ms``: CUDA events
      around eager calls; ``device_ms``: the calls back to back behind a
      device spin; ``cold_device_ms``: the same, each call taking the next of
      several operand copies that together exceed four times the L2, so its
      operands come from HBM, as the HBM bound assumes.  Kernel and library
      in turns (library, kernel, kernel, library) under each measure.
  k6  ``flash_attention`` at zamba2-2.7b's prefill shape, q, k, v of
      (2, 2048, 32, 80), causal, bf16 and f32: ``ms`` and ``device_ms`` beside
      SDPA's in turns, max |err| and the largest per-row relative error
      (``chip_smoke.row_rel_err``), and that error's largest value over the
      card tests' ring-edge shapes.
  k2  ``build_merge_packed`` on chip_smoke.py's TRAFFIC (8 MiB) and e125
      (1 MiB) texts, 1024 chunks, its entries the ``torch`` backend's join
      of the texts' chunk products: ``ms`` and ``device_ms``, equality with
      the plain version, and the tree's plan where it has one
      (``build.plan``).
  k1  ``reach_chunk_product`` on chip_smoke.py's TRAFFIC (8 MiB) and e125
      (1 MiB) texts, 1024 chunks: ``ms`` and ``device_ms``, equality with
      the plain version, and the tree's plan where it has one.
  k4  ``packed_reach_chunk_product`` on the same texts: ``ms`` and
      ``device_ms``, equality with the plain version, and the tree's plan
      where it has one (``packed_reach.plan``).
  k5  ``sparse_reach_rows`` on the same texts, its start rows the sparse
      backend's own feasible rows (S of them a chunk): the same fields.
  k7  ``ssd_chunk`` at zamba2-2.7b's prefill shape (P = 1280, q = 256,
      hp = n = 64), bf16 and f32: for a tree whose K7 takes ``outputs``,
      each mode and the layer's pair (``"state"`` then ``"y"``); for an
      earlier tree, one launch (both outputs) and the layer's pair of such
      launches.  ``ms``, ``device_ms`` and max |err| against the plain
      version with ``within_tolerance`` (rtol = atol = 2e-4): a build with a
      planted fault reports its error rather than stopping.
  k7f  the same for f32 alone (the f32 consistency prefill's type).
  fleet  K1 and K2 over e125's fleet bucket as ``chip_smoke.py``'s fleet
      gathers it: 16 tenants of 64 KiB (FLEET_E125, FLEET_E125_BYTES), 1024
      chunks × 1024 at ℓp 512, the stack's live window attached where the
      tree's fleet keeps one: ``ms`` and ``device_ms`` (one call each where
      a call takes over SLOW_CALL_MS), equality with the plain version, the
      window and the plans.
  join  the ``cuda`` backend's join phase (K3's 23 launches and the scan's
      host code) on both texts' chunk products: host-clock seconds of
      JOIN_RUNS joins in a row, the first right after the allocator's cache
      is emptied (as chip_smoke.py's ``phases`` runs it), with the
      ``cudaMalloc`` segments each one made, and the device time of one
      more join's kernels by ``torch.profiler``.
  walk  ``ParseResult.matches`` of every group of the TRAFFIC (8 MiB) text's
      ``cuda`` parse, host-clock seconds on each route of the forest's
      ``iter_trees``: the array route for a forest of one segment a column,
      then the depth-first walk alone (that route turned off on the
      forest), and whether the two give the same spans.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402  (stdlib only at import; the timing code)

# the card tests' K6 ring-edge cases (tests/test_torch_cuda.py): L, Lk, causal, window
RING_EDGES = [(1, 1, True, None), (1, 100, False, None), (100, 150, False, None),
              (150, 100, True, None), (1000, 1000, True, None), (700, 700, True, 40),
              (300, 300, False, 100), (129, 129, True, 65)]
JOIN_RUNS = 5


def emit(part: str, **fields) -> None:
    print(json.dumps({"part": part, **fields}), flush=True)


def in_turns_all(kernel_fn, library_fn, measures) -> dict:
    out = {}
    for key, measure in measures:
        out[key], out["library_" + key] = cs.in_turns(measure, kernel_fn, library_fn)
    return out


def k3_records(label: str, regex: str, text: bytes, dev) -> None:
    import torch

    from repro_torch import Parser, ParserConfig
    from repro_torch.core.backend import TorchBackend
    from repro_torch.kernels import ops
    from repro_torch.kernels.cost import HBM_BW

    parser = Parser(ParserConfig(regex=regex, backend="torch", n_chunks=cs.N_CHUNKS), device=dev)
    eng = parser.engine
    t = eng.tables
    classes = eng.classes_of_text(text)
    c, k = eng.bucket_shape(len(classes), parser.config.n_chunks)
    P = ops.reach_chunk_product(t.N, eng.chunks_tensor(eng._pad_to(classes, c, k)))
    Jf, _ = TorchBackend().join(P, t.I, t.F)
    a, b = P[1:].contiguous(), P[:-1].contiguous()
    v = Jf[:-1].contiguous()
    del P, Jf
    props = torch.cuda.get_device_properties(0)
    l2 = getattr(props, "L2_cache_size", 50 << 20) or (50 << 20)
    for case, args in (("compose", (a, b)), ("matvec", (a, v.unsqueeze(-1))),
                       ("vecmat", (v.unsqueeze(-2), b))):
        if not torch.equal(ops.semiring_matmul(*args), ops.semiring_matmul.plain(*args)):
            raise AssertionError(f"{label} {case}: kernel != plain version")
        nbytes = sum(x.numel() * x.element_size() for x in args)
        copies = [args] + [tuple(x.clone() for x in args)
                           for _ in range(max(0, -(-4 * l2 // nbytes) - 1))]
        turn = itertools.cycle(copies)
        kern = lambda: ops.semiring_matmul(*args)  # noqa: E731
        lib = lambda: torch.clamp(torch.bmm(*args), max=1.0)  # noqa: E731
        kern_cold = lambda: ops.semiring_matmul(*next(turn))  # noqa: E731
        lib_cold = lambda: torch.clamp(torch.bmm(*next(turn)), max=1.0)  # noqa: E731
        rec = in_turns_all(kern, lib, (("ms", cs.time_ms), ("device_ms", cs.device_ms)))
        rec.update(in_turns_all(kern_cold, lib_cold, (("cold_device_ms", cs.device_ms),)))
        out_bytes = args[0].shape[0] * args[0].shape[1] * args[1].shape[2] * 4
        emit("k3", text=label, case=case, operands=[list(x.shape) for x in args],
             copies=len(copies), l2_bytes=l2,
             hbm_bound_ms=(nbytes + out_bytes) / HBM_BW * 1e3, **rec)
        del copies, turn
        torch.cuda.empty_cache()


def k6_records(dev, seed: int) -> None:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    b, L, h, hd = cs.LM_BATCH, cs.LM_LEN, 32, 80
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).split(".")[-1]
        q, k, v = (torch.randn((b, L, h, hd), generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        got = ops.flash_attention(q, k, v, causal=True, window=None)
        want = ops.flash_attention.plain(q, k, v, causal=True, window=None)
        err = (got.float() - want.float()).abs().max().item()
        rel = cs.row_rel_err(got, want)
        late = cs.row_rel_err(got[:, L // 2:], want[:, L // 2:])
        del got, want
        edge_rel = 0.0
        for Lq, Lk, causal, window in RING_EDGES:
            for ehd in (40, 80, 128):
                eq = torch.randn((1, Lq, 3, ehd), generator=gen, device=dev).to(dtype)
                ek, ev = (torch.randn((1, Lk, 3, ehd), generator=gen, device=dev).to(dtype)
                          for _ in range(2))
                edge_rel = max(edge_rel, cs.row_rel_err(
                    ops.flash_attention(eq, ek, ev, causal=causal, window=window),
                    ops.flash_attention.plain(eq, ek, ev, causal=causal, window=window)))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        rec = in_turns_all(lambda: ops.flash_attention(q, k, v, causal=True, window=None),
                           lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
                           (("ms", cs.time_ms), ("device_ms", cs.device_ms)))
        emit("k6", dtype=tag, shape=[b, L, h, hd], max_abs_err=err, max_row_rel_err=rel,
             late_rows_max_row_rel_err=late, ring_edges_max_row_rel_err=edge_rel, **rec)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()


def k2_records(label: str, regex: str, text: bytes, dev) -> None:
    import torch

    from repro_torch import Parser, ParserConfig
    from repro_torch.core.backend import TorchBackend
    from repro_torch.kernels import build as build_launcher
    from repro_torch.kernels import ops

    parser = Parser(ParserConfig(regex=regex, backend="torch", n_chunks=cs.N_CHUNKS), device=dev)
    eng = parser.engine
    t = eng.tables
    classes = eng.classes_of_text(text)
    c, k = eng.bucket_shape(len(classes), parser.config.n_chunks)
    ids = eng.chunks_tensor(eng._pad_to(classes, c, k))
    Jf, Jb = TorchBackend().join(ops.reach_chunk_product(t.N, ids), t.I, t.F)
    args = (t.N, ids, Jf, Jb)
    equal = torch.equal(ops.build_merge_packed(*args), ops.build_merge_packed.plain(*args))
    kern = lambda: ops.build_merge_packed(*args)  # noqa: E731
    plan = getattr(build_launcher, "plan", None)
    emit("k2", text=label, chunks=c, k=k, ell_pad=t.ell_pad, classes=t.N.shape[0],
         plan=list(plan(t.N.shape[0], t.ell_pad, c)) if plan else None, equal_plain=equal,
         ms=cs.time_ms(kern), device_ms=cs.device_ms(kern))
    del args, ids, Jf, Jb
    torch.cuda.empty_cache()


def k1_records(label: str, regex: str, text: bytes, dev) -> None:
    import torch

    from repro_torch import Parser, ParserConfig
    from repro_torch.kernels import ops
    from repro_torch.kernels import reach as reach_launcher

    parser = Parser(ParserConfig(regex=regex, backend="torch", n_chunks=cs.N_CHUNKS), device=dev)
    eng = parser.engine
    t = eng.tables
    classes = eng.classes_of_text(text)
    c, k = eng.bucket_shape(len(classes), parser.config.n_chunks)
    ids = eng.chunks_tensor(eng._pad_to(classes, c, k))
    equal = torch.equal(ops.reach_chunk_product(t.N, ids), ops.reach_chunk_product.plain(t.N, ids))
    plan = getattr(reach_launcher, "plan", None)
    kern = lambda: ops.reach_chunk_product(t.N, ids)  # noqa: E731
    emit("k1", text=label, chunks=c, k=k, ell_pad=t.ell_pad, classes=t.N.shape[0],
         plan=list(plan(t.N.shape[0], t.ell_pad)) if plan else None, equal_plain=equal,
         ms=cs.time_ms(kern), device_ms=cs.device_ms(kern))
    del ids
    torch.cuda.empty_cache()


def fleet_records(dev) -> None:
    import torch

    from repro_torch.core.backend import TorchBackend
    from repro_torch.core.fleet import FleetEngine, TenantSpec
    from repro_torch.kernels import build as build_launcher
    from repro_torch.kernels import ops
    from repro_torch.kernels import reach as reach_launcher

    eng = FleetEngine(device=dev)
    per = {}
    for j in range(cs.FLEET_E125):
        eng.add_tenant(f"e{j}", TenantSpec(regex=cs.E125_RE, backend="cuda",
                                           n_chunks=cs.FLEET_E125_BYTES // 1024))
        text = cs.e125_text(cs.FLEET_E125_BYTES, 1000 + j)
        per[f"e{j}"] = [eng.tenant(f"e{j}").classes_of_text(text)]
    ts = eng.tenant("e0")
    runner = eng.runner(ts.bucket_key)
    c, k = ts.text_bucket(len(per["e0"][0]))
    rows, grid = runner.host_batch(c, k, per)
    N, I, F = runner.operands(rows)
    ids = torch.from_numpy(grid.reshape(-1, k)).to(dev)
    T, A1, lp = N.shape[0], N.shape[1], N.shape[-1]
    C = ids.shape[0]
    try:
        from repro_torch.kernels import window
    except ImportError:                       # a tree from before the live window
        window = None
    lw = lp if window is None else window.width(N)
    plans = {"reach": list(reach_launcher.plan(A1, lp) if window is None
                           else reach_launcher.plan(A1, lp, lw)),
             "build_merge": list(build_launcher.plan(A1, lp, C) if window is None
                                 else build_launcher.plan(A1, lp, C, lw))}

    def timed(fn):
        first = cs.time_ms(fn)
        if first >= cs.SLOW_CALL_MS:
            return {"ms": first, "device_ms": first}
        return {"ms": first, "device_ms": cs.device_ms(fn)}

    got = ops.reach_chunk_product(N, ids)
    want = ops.reach_chunk_product.plain(N, ids)
    equal = torch.equal(got, want)
    emit("fleet", kernel="reach_chunk_product", tenants=T, chunks=C, k=k, ell_pad=lp, window=lw,
         plan=plans["reach"], equal_plain=equal,
         **timed(lambda: ops.reach_chunk_product(N, ids)))
    Jf, Jb = TorchBackend().join(want.reshape(T, -1, c, lp, lp), I[:, None], F[:, None])
    Jf, Jb = Jf.reshape(C, lp).contiguous(), Jb.reshape(C, lp).contiguous()
    del got, want
    args = (N, ids, Jf, Jb)
    equal = torch.equal(ops.build_merge_packed(*args), ops.build_merge_packed.plain(*args))
    emit("fleet", kernel="build_merge_packed", tenants=T, chunks=C, k=k, ell_pad=lp, window=lw,
         plan=plans["build_merge"], equal_plain=equal,
         **timed(lambda: ops.build_merge_packed(*args)))
    del args, Jf, Jb, N
    torch.cuda.empty_cache()


def word_records(part: str, label: str, regex: str, text: bytes, dev) -> None:
    """K4 (``part`` "k4") or K5 ("k5") at chip_smoke.py's shapes for one text."""
    import torch

    from repro_torch import Parser, ParserConfig
    from repro_torch.core.backend import SparseBackend
    from repro_torch.core.matrices import pack_transition_table_torch, sparse_init_rows
    from repro_torch.kernels import ops
    from repro_torch.kernels import packed_reach as packed_launcher

    parser = Parser(ParserConfig(regex=regex, backend="torch", n_chunks=cs.N_CHUNKS), device=dev)
    eng = parser.engine
    t = eng.tables
    classes = eng.classes_of_text(text)
    c, k = eng.bucket_shape(len(classes), parser.config.n_chunks)
    ids = eng.chunks_tensor(eng._pad_to(classes, c, k))
    args = (pack_transition_table_torch(t.N), ids)
    kern = ops.packed_reach_chunk_product
    if part == "k5":
        sparse = SparseBackend()
        sparse.bind_tables(t)
        args += (sparse_init_rows(sparse.feasible_rows(t.N, ids), t.ell_pad).contiguous(),)
        kern = ops.sparse_reach_rows
    rows = args[-1].shape[1] if part == "k5" else t.ell_pad
    equal = torch.equal(kern(*args), kern.plain(*args))
    plan = getattr(packed_launcher, "plan", None)
    run = lambda: kern(*args)  # noqa: E731
    emit(part, text=label, chunks=c, k=k, ell_pad=t.ell_pad, classes=t.N.shape[0], rows=rows,
         plan=list(plan(t.N.shape[0], t.ell_pad, rows)) if plan else None, equal_plain=equal,
         ms=cs.time_ms(run), device_ms=cs.device_ms(run))
    del args, ids
    torch.cuda.empty_cache()


def k7_records(dev, seed: int, dtypes) -> None:
    import inspect

    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_chunk as ssd_launcher

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    P, q, hp, n = 1280, 256, 64, 64
    takes_outputs = "outputs" in inspect.signature(ssd_launcher.launch).parameters
    for dtype in dtypes:
        tag = str(dtype).split(".")[-1]
        xdt = (torch.randn((P, q, hp), generator=gen, device=dev) * 0.3).to(dtype)
        csum = torch.cumsum(-(torch.rand((P, q, 1), generator=gen, device=dev) * 0.39 + 0.01), 1)
        B, C = ((torch.randn((P, q, n), generator=gen, device=dev) * 0.3).to(dtype)
                for _ in range(2))
        S_prev = torch.randn((P, hp, n), generator=gen, device=dev) * 0.3
        args = (xdt, csum, B, C, S_prev)
        modes = ("both", "state", "y") if takes_outputs else ("both",)
        for outputs in modes:
            static = {"outputs": outputs} if takes_outputs else {}
            got = ops.ssd_chunk(*args, **static)
            torch.cuda.synchronize()
            want = ops.ssd_chunk.plain(*args, **static)
            pairs = [(g, w) for g, w in zip(got, want) if w is not None]
            err = max((g - w).abs().max().item() for g, w in pairs)
            close = all(torch.allclose(g, w, rtol=2e-4, atol=2e-4) for g, w in pairs)
            del got, want, pairs
            kern = lambda s=static: ops.ssd_chunk(*args, **s)  # noqa: E731
            emit("k7", dtype=tag, case=outputs, max_abs_err=err, within_tolerance=close,
                 ms=cs.time_ms(kern), device_ms=cs.device_ms(kern))
        if takes_outputs:
            pair = lambda: (ops.ssd_chunk(*args, outputs="state"),  # noqa: E731
                            ops.ssd_chunk(*args, outputs="y"))
        else:
            pair = lambda: (ops.ssd_chunk(*args), ops.ssd_chunk(*args))  # noqa: E731
        emit("k7", dtype=tag, case="layer pair", ms=cs.time_ms(pair), device_ms=cs.device_ms(pair))
        del args, xdt, csum, B, C, S_prev
        torch.cuda.empty_cache()


def join_records(label: str, regex: str, text: bytes, dev) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import Parser, ParserConfig
    from repro_torch.kernels import ops

    parser = Parser(ParserConfig(regex=regex, backend="cuda", n_chunks=cs.N_CHUNKS), device=dev)
    eng = parser.engine
    t = eng.tables
    classes = eng.classes_of_text(text)
    c, k = eng.bucket_shape(len(classes), parser.config.n_chunks)
    chunks = eng.chunks_tensor(eng._pad_to(classes, c, k))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    P = eng.phases.reach(t.N, chunks)
    secs, segments = [], []
    for _ in range(JOIN_RUNS):
        before = torch.cuda.memory_stats().get("segment.all.allocated", 0)
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.phases.join(P, t.I, t.F)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        segments.append(torch.cuda.memory_stats().get("segment.all.allocated", 0) - before)
    launches = ops.semiring_matmul.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.phases.join(P, t.I, t.F)
        torch.cuda.synchronize()
    kernel_ms = sum(cs._device_us(ev) for ev in prof.key_averages()
                    if ev.device_type.name == "CUDA") / 1e3
    emit("join", text=label, bucket=[c, k], seconds=secs, malloc_segments=segments,
         k3_launches=launches, device_kernel_ms=kernel_ms)
    del P
    torch.cuda.empty_cache()


def walk_records(label: str, regex: str, text: bytes, dev) -> None:
    from repro_torch import Parser, ParserConfig

    parser = Parser(ParserConfig(regex=regex, backend="cuda", n_chunks=cs.N_CHUNKS), device=dev)
    result = parser.parse(text)
    seconds, spans = {}, {}
    for route in ("array", "walk"):
        if route == "walk":
            result.forest._one_segment_columns = lambda: None
        t0 = time.perf_counter()
        spans[route] = [result.matches(g) for g in parser.groups]
        seconds[route] = time.perf_counter() - t0
    emit("walk", text=label, bytes=len(text), groups=list(parser.groups),
         spans=sum(map(len, spans["array"])), seconds=seconds,
         equal=spans["array"] == spans["walk"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=REPO)
    ap.add_argument("--parts", default="k1,k2,k3,k4,k5,k6,k7,join")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.tree.resolve() / "src"))
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    ops.build()
    emit("env", tree=str(args.tree), nvidia_smi=cs.nvidia_smi_line(),
         torch=torch.__version__, repro_torch=str(Path(ops.__file__).resolve()))
    parts = args.parts.split(",")
    if "k1" in parts:
        k1_records("traffic", cs.TRAFFIC_RE, cs.traffic_log(cs.TRAFFIC_BYTES, 0), dev)
        k1_records("e125", cs.E125_RE, cs.e125_text(cs.E125_BYTES, 1), dev)
    for part in ("k4", "k5"):
        if part in parts:
            word_records(part, "traffic", cs.TRAFFIC_RE, cs.traffic_log(cs.TRAFFIC_BYTES, 0), dev)
            word_records(part, "e125", cs.E125_RE, cs.e125_text(cs.E125_BYTES, 1), dev)
    if "k2" in parts:
        k2_records("traffic", cs.TRAFFIC_RE, cs.traffic_log(cs.TRAFFIC_BYTES, 0), dev)
        k2_records("e125", cs.E125_RE, cs.e125_text(cs.E125_BYTES, 1), dev)
    if "k7" in parts or "k7f" in parts:
        k7_records(dev, 0, (torch.bfloat16, torch.float32) if "k7" in parts else (torch.float32,))
    if "k3" in parts:
        k3_records("traffic", cs.TRAFFIC_RE, cs.traffic_log(cs.TRAFFIC_BYTES, 0), dev)
        k3_records("e125", cs.E125_RE, cs.e125_text(cs.E125_BYTES, 1), dev)
    if "k6" in parts:
        k6_records(dev, 0)
    if "fleet" in parts:
        fleet_records(dev)
    if "join" in parts:
        join_records("traffic", cs.TRAFFIC_RE, cs.traffic_log(cs.TRAFFIC_BYTES, 0), dev)
        join_records("e125", cs.E125_RE, cs.e125_text(cs.E125_BYTES, 1), dev)
    if "walk" in parts:
        walk_records("traffic", cs.TRAFFIC_RE, cs.traffic_log(cs.TRAFFIC_BYTES, 0), dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
