#!/usr/bin/env python3
"""Drive repro_torch, the PyTorch/CUDA port of the parser, on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Run from the root of a checkout (it imports ``src/repro_torch``, never JAX
or ``repro``).  Phases, each printing one JSON line:

  env        PyTorch version, card name, ``nvidia-smi`` name and power limit
  build      nvcc build time of the kernels' four sources (one process each)
  kernel     each of the five kernels against its plain PyTorch version at
             the main path's shapes (``torch.equal``), with kernel, plain and
             library times; K5's start rows are the sparse backend's own
             feasible rows for the text
  main_path  the user path, each run counted on its own (every launch count
             set to 0 just before it, read just after): on the ``cuda``
             backend, ``Parser.parse`` of an 8 MiB TRAFFIC log
             (n_chunks=1024), the same log with one corrupted byte,
             ``parse_batch`` of 8 mixed texts, and 1 MiB of e125 text, valid
             and corrupted (K1, K2 and K3 must launch in the TRAFFIC parse, in
             ``parse_batch`` and in the e125 parse); then ``packed`` and
             ``sparse`` with ``kernel=True`` on the same four texts (K4 must
             launch in every packed run and K5 in every sparse run, K1 in
             none of them, and their columns must equal the ``cuda`` run's)
  speculation  the sparse runs' ``ParseResult.speculation``: product rows S
             against ℓp, mean and max feasible width
  check      the main path's packed columns equal the ``torch`` backend's on
             the same card, bit for bit; small texts have exactly one tree
  phases     reach / join / build&merge / host assembly times and MB/s of the
             ``cuda``, ``packed`` and ``sparse`` kernel paths on both texts,
             each one's packed columns held against the ``torch`` backend's

then the kernel table, the ``nvidia-smi`` line, and as the last line
``{"ok": true, "device": {...}}``.  Any failure raises and the script exits
non-zero; there is no CPU fallback.  Without a CUDA device it exits 2.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the TRAFFIC pattern of the repository's benchmark corpus (ℓ = 37, ℓp = 64)
TRAFFIC_RE = r"((GET|POST|PUT) /([a-z0-9]|/)* ([0-9]{3}) (ok|err|-)\n)+"
# the densest automaton in the repository (ℓ = 257, ℓp = 288)
E125_RE = "(a|b)*a(a|b){125}"

TRAFFIC_BYTES = 8 << 20
E125_BYTES = 1 << 20
N_CHUNKS = 1024
# a timing is the median of TIMING_BATCHES event-timed batches, each of as many
# calls as fill about BATCH_MS (at least one)
TIMING_BATCHES = 5
BATCH_MS = 20.0
SLOW_CALL_MS = 1000.0

# H100 SXM peaks (NVIDIA data sheet, dense): {0,1} products are exact on the
# int8 tensor cores, the cheapest exact type, so bounds use their rate
INT8_OPS_PER_S = 1979e12
HBM_BYTES_PER_S = 3.35e12


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def traffic_log(n_bytes: int, seed: int) -> bytes:
    """A valid TRAFFIC log of exactly ``n_bytes``: ``METHOD /path NNN ok|err|-``
    lines drawn from ``seed``."""
    import numpy as np

    rng = np.random.Generator(np.random.Philox(seed))
    methods = [b"GET", b"POST", b"PUT"]
    tails = [b"ok", b"err", b"-"]
    alphabet = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz0123456789/", dtype=np.uint8)
    lines = []
    total = 0
    while n_bytes - total > 64:
        path = alphabet[rng.integers(0, len(alphabet), size=int(rng.integers(0, 24)))]
        line = b"%s /%s %03d %s\n" % (
            methods[rng.integers(0, 3)], path.tobytes(), rng.integers(0, 1000),
            tails[rng.integers(0, 3)],
        )
        lines.append(line)
        total += len(line)
    fill = n_bytes - total - len(b"GET / 200 ok\n")
    lines.append(b"GET /" + b"a" * fill + b" 200 ok\n")
    out = b"".join(lines)
    assert len(out) == n_bytes
    return out


def e125_text(n_bytes: int, seed: int) -> bytes:
    """Random a/b text of ``n_bytes`` that matches e125 (an 'a' 126 from the end)."""
    import numpy as np

    rng = np.random.Generator(np.random.Philox(seed))
    text = np.frombuffer(b"ab", dtype=np.uint8)[rng.integers(0, 2, size=n_bytes)].copy()
    text[-126] = ord("a")
    return text.tobytes()


def corrupt(text: bytes) -> bytes:
    mid = len(text) // 2
    return text[:mid] + b"~" + text[mid + 1:]


def time_ms(fn) -> float:
    """Device time of one call of ``fn``: the median over TIMING_BATCHES
    CUDA-event-timed batches, after a warm-up call that also sizes the batch.
    A call slower than SLOW_CALL_MS (a plain version at full size) is timed
    once more after the warm-up, and that one call is its time."""
    import statistics

    import torch

    def batch(n: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    torch.cuda.synchronize()
    first = batch(1)
    if first >= SLOW_CALL_MS:
        return batch(1)
    n = max(1, int(BATCH_MS / max(first, 1e-3)))
    return statistics.median(batch(n) for _ in range(TIMING_BATCHES))


def bound_ms(ops: float, n_bytes: float):
    t_ops = ops / INT8_OPS_PER_S * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_cases(parser, text: bytes):
    """Each kernel against its plain version at the shapes ``parser``'s main
    path (and the packed and sparse paths on the same text) gives it;
    returns one record per kernel (launch counts filled later).

    Operations in ``bound_ms`` count what this text needs: its real (non-PAD)
    steps and its ℓ states; the padded states are unreachable and PAD steps
    are identities.  K5 folds only the feasible rows, w̄ of them per chunk on
    average (the text's mean observed feasible width, which the sparse
    run's ``speculation["width_mean"]`` reports).  Bytes count the tensors as
    given, each read or written once."""
    import torch

    from repro_torch.core.backend import SparseBackend, TorchBackend
    from repro_torch.core.matrices import (
        feasible_start_widths,
        pack_transition_table_torch,
        sparse_init_rows,
    )
    from repro_torch.kernels import ops

    eng = parser.engine
    t = eng.tables
    classes = eng.classes_of_text(text)
    c, k = eng.bucket_shape(len(classes), parser.config.n_chunks)
    grid = eng._pad_to(classes, c, k)
    ids = eng.chunks_tensor(grid)
    lp, ell, steps = t.ell_pad, t.ell, len(classes)
    A1 = t.N.shape[0]
    W = lp // 32
    P = ops.reach_chunk_product.plain(t.N, ids)
    Jf, Jb = TorchBackend().join(P, t.I, t.F)
    a, b = P[1:].contiguous(), P[:-1].contiguous()   # the join's first level
    del P
    Np = pack_transition_table_torch(t.N)
    sparse = SparseBackend()
    sparse.bind_tables(t)
    S = sparse._width
    R0 = sparse_init_rows(sparse.feasible_rows(t.N, ids), lp).contiguous()
    widths = feasible_start_widths(t.N.cpu().numpy(), grid)
    w_mean = float(widths[widths >= 0].mean())

    cases = [
        ("reach_chunk_product", "src/repro_torch/csrc/reach.cu",
         "src/repro/kernels/reach.py:49", ops.reach_chunk_product, (t.N, ids), None,
         2.0 * steps * ell ** 3, 4.0 * (c * k + A1 * lp * lp + c * lp * lp)),
        ("build_merge_packed", "src/repro_torch/csrc/build_merge.cu",
         "src/repro/kernels/build.py:60", ops.build_merge_packed, (t.N, ids, Jf, Jb), None,
         4.0 * steps * ell * ell, 4.0 * (c * k + A1 * lp * lp + 2 * c * lp + c * k * lp // 32)),
        ("semiring_matmul", "src/repro_torch/csrc/semiring.cu",
         "src/repro/kernels/semiring.py:40", ops.semiring_matmul, (a, b),
         lambda: torch.clamp(torch.bmm(a, b), max=1.0),
         2.0 * (c - 1) * ell ** 3, 4.0 * 3 * (c - 1) * lp * lp),
        ("packed_reach_chunk_product", "src/repro_torch/csrc/packed_reach.cu",
         "src/repro/kernels/packed_reach.py:74", ops.packed_reach_chunk_product, (Np, ids), None,
         2.0 * steps * ell ** 3, 4.0 * (c * k + A1 * lp * W + c * lp * W)),
        ("sparse_reach_rows", "src/repro_torch/csrc/packed_reach.cu",
         "src/repro/kernels/sparse_reach.py:71", ops.sparse_reach_rows, (Np, ids, R0), None,
         2.0 * steps * w_mean * ell ** 2, 4.0 * (c * k + A1 * lp * W + 2 * c * S * W)),
    ]
    records = []
    for name, source, replaces, kern, args, library, n_ops, n_bytes in cases:
        got = kern(*args)
        torch.cuda.synchronize()
        want = kern.plain(*args)
        equal = torch.equal(got, want)
        err = (got.double() - want.double()).abs().max().item() if got.numel() else 0.0
        if not equal:
            raise AssertionError(f"{name}: kernel != plain version, max |err| {err}")
        del got, want
        b_ms, b_by = bound_ms(n_ops, n_bytes)
        rec = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": err,
            "ms": time_ms(lambda: kern(*args)),
            "plain_ms": time_ms(lambda: kern.plain(*args)),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(library) if library is not None else None,
            "shapes": {"chunks": c, "k": k, "steps": steps, "ell": ell, "ell_pad": lp,
                       "classes": A1, "rows": S if name == "sparse_reach_rows" else lp,
                       "width_mean": w_mean},
        }
        records.append(rec)
        emit("kernel", pattern=parser.config.regex[:24], tolerance=0, **rec)
        torch.cuda.empty_cache()
    return records


def torch_backend_columns(p_torch, text: bytes):
    """The ``torch`` backend's packed C₀ and columns for ``text`` (on the
    card) and its assembled forest columns: what every kernel path is held
    against."""
    eng = p_torch.engine
    classes = eng.classes_of_text(text)
    c, k = eng.bucket_shape(len(classes), p_torch.config.n_chunks)
    col0, cols = eng.run(eng.chunks_tensor(eng._pad_to(classes, c, k)))
    return col0, cols, eng._assemble(col0.cpu().numpy(), cols.cpu().numpy(), classes).columns


def phase_times(parser, want, text: bytes, label: str) -> None:
    """Phase-split run of ``parser``'s backend, timed per phase, and its
    packed columns held against ``want`` (``torch_backend_columns``)."""
    import numpy as np
    import torch

    eng = parser.engine
    t = eng.tables
    classes = eng.classes_of_text(text)
    c, k = eng.bucket_shape(len(classes), parser.config.n_chunks)
    chunks = eng.chunks_tensor(eng._pad_to(classes, c, k))
    torch.cuda.synchronize()
    marks = [time.perf_counter()]
    P = eng.phases.reach(t.N, chunks)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    Jf, Jb, col0 = eng.phases.join(P, t.I, t.F)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    cols = eng.phases.build_merge(t.N, chunks, Jf, Jb)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    slpf = eng._assemble(col0.cpu().numpy(), cols.cpu().numpy(), classes)
    marks.append(time.perf_counter())
    product_bytes = P.numel() * P.element_size()
    del P, Jf, Jb

    want_col0, want_cols, want_columns = want
    if not (torch.equal(col0, want_col0) and torch.equal(cols, want_cols)):
        raise AssertionError(f"{label}: packed columns != torch backend's")
    if not np.array_equal(slpf.columns, want_columns):
        raise AssertionError(f"{label}: assembled columns differ")
    names = ["reach", "join", "build_merge", "host_assembly"]
    secs = {f"{n}_s": marks[i + 1] - marks[i] for i, n in enumerate(names)}
    total = marks[-1] - marks[0]
    emit("phases", text=label, backend=parser.backend_name, kernel=parser.config.kernel,
         bytes=len(text), bucket=[c, k], product_bytes=product_bytes, **secs, total_s=total,
         mb_per_s=len(text) / total / 1e6, packed_cols_equal_torch_backend=True)
    torch.cuda.empty_cache()


def counted(fn):
    """Run ``fn`` with every launch count set to 0 just before it; returns its
    result, its wall seconds and the counts read just after it."""
    import torch

    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return out, seconds, {k.name: k.launches for k in ops.KERNELS}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "__init__.py").exists():
        print("chip_smoke: src/repro_torch not found beside the script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch import Parser, ParserConfig
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi)

    t0 = time.perf_counter()
    libs = ops.build()
    emit("build", seconds=time.perf_counter() - t0, sources=sorted(libs))

    traffic = traffic_log(TRAFFIC_BYTES, args.seed)
    e125 = e125_text(E125_BYTES, args.seed + 1)
    cfg_t = ParserConfig(regex=TRAFFIC_RE, backend="cuda", n_chunks=N_CHUNKS)
    cfg_e = ParserConfig(regex=E125_RE, backend="cuda", n_chunks=N_CHUNKS)
    p_traffic = Parser(cfg_t, device=dev)
    p_e125 = Parser(cfg_e, device=dev)
    emit("tables", traffic_ell=p_traffic.engine.tables.ell,
         traffic_ell_pad=p_traffic.engine.tables.ell_pad,
         e125_ell=p_e125.engine.tables.ell, e125_ell_pad=p_e125.engine.tables.ell_pad)

    records = kernel_cases(p_traffic, traffic)
    e125_records = kernel_cases(p_e125, e125)

    # ------------------------------------------------ the main path, counted
    lines = traffic.split(b"\n")[:-1]
    batch = [b"\n".join(lines[:n]) + b"\n" for n in (1, 3, 40, 500, 4000, 20000)]
    batch += [b"", corrupt(batch[3])]
    traffic_bad, e125_bad = corrupt(traffic), corrupt(e125)
    r_traffic, t_traffic, n_traffic = counted(lambda: p_traffic.parse(traffic))
    r_bad, _, n_bad = counted(lambda: p_traffic.parse(traffic_bad))
    r_batch, t_batch, n_batch = counted(lambda: p_traffic.parse_batch(batch))
    r_e125, t_e125, n_e125 = counted(lambda: p_e125.parse(e125))
    r_e125_bad, _, n_e125_bad = counted(lambda: p_e125.parse(e125_bad))
    emit("main_path", backend="cuda",
         traffic={"bytes": len(traffic), "bucket": list(r_traffic.bucket), "ok": r_traffic.ok,
                  "seconds": t_traffic, "mb_per_s": len(traffic) / t_traffic / 1e6,
                  "launches": n_traffic},
         traffic_corrupted={"ok": r_bad.ok, "launches": n_bad},
         batch={"lengths": [len(x) for x in batch], "ok": [r.ok for r in r_batch],
                "seconds": t_batch, "launches": n_batch},
         e125={"bytes": len(e125), "bucket": list(r_e125.bucket), "ok": r_e125.ok,
               "seconds": t_e125, "mb_per_s": len(e125) / t_e125 / 1e6,
               "launches": n_e125},
         e125_corrupted={"ok": r_e125_bad.ok, "launches": n_e125_bad})
    dense = ("reach_chunk_product", "build_merge_packed", "semiring_matmul")
    for path, launches in [("TRAFFIC parse", n_traffic), ("parse_batch", n_batch),
                           ("e125 parse", n_e125)]:
        if min(launches[name] for name in dense) <= 0:
            raise AssertionError(f"a kernel never launched in the {path}: {launches}")
    if not (r_traffic.ok and r_e125.ok) or r_bad.ok or r_e125_bad.ok:
        raise AssertionError("accept / reject verdicts are wrong")
    if [r.ok for r in r_batch] != [True] * 6 + [False, False]:
        raise AssertionError(f"parse_batch verdicts are wrong: {[r.ok for r in r_batch]}")

    # the packed and sparse kernel paths on the same texts, each run counted
    word_parsers = {
        (backend, cfg.regex): Parser(cfg.replace(backend=backend, kernel=True), device=dev)
        for backend in ("packed", "sparse") for cfg in (cfg_t, cfg_e)
    }
    word_launches = {}
    speculation = {}
    for backend, kernel in (("packed", "packed_reach_chunk_product"),
                            ("sparse", "sparse_reach_rows")):
        runs = {}
        for label, cfg, text, want in (("traffic", cfg_t, traffic, r_traffic),
                                       ("traffic_corrupted", cfg_t, traffic_bad, r_bad),
                                       ("e125", cfg_e, e125, r_e125),
                                       ("e125_corrupted", cfg_e, e125_bad, r_e125_bad)):
            parser = word_parsers[(backend, cfg.regex)]
            r, secs, n = counted(lambda: parser.parse(text))
            if n[kernel] < 1 or n["reach_chunk_product"] != 0:
                raise AssertionError(f"{backend} {label}: launches {n}")
            if r.ok != want.ok:
                raise AssertionError(f"{backend} {label}: verdict {r.ok}, cuda says {want.ok}")
            if not np.array_equal(r.forest.columns, want.forest.columns):
                raise AssertionError(f"{backend} {label}: columns != the cuda backend's")
            runs[label] = {"bytes": len(text), "bucket": list(r.bucket), "ok": r.ok,
                           "seconds": secs, "mb_per_s": len(text) / secs / 1e6,
                           "launches": n}
            word_launches[(backend, label)] = n
            if backend == "sparse" and "corrupted" not in label:
                speculation[label] = r.speculation
            del r
        emit("main_path", backend=backend, kernel=True, columns_equal_cuda_backend=True, **runs)
    emit("speculation", **speculation)
    t_spec = speculation["traffic"]
    if not t_spec["product_rows"] < t_spec["ell_pad"]:
        raise AssertionError(f"TRAFFIC carries no speculation reduction: {t_spec}")
    for label, recs in (("traffic", records), ("e125", e125_records)):
        sparse_rec = next(r for r in recs if r["name"] == "sparse_reach_rows")
        if abs(sparse_rec["shapes"]["width_mean"] - speculation[label]["width_mean"]) > 1e-9:
            raise AssertionError(f"{label}: K5 bound width != the sparse run's width_mean")

    kernel_path = {"packed_reach_chunk_product": "packed", "sparse_reach_rows": "sparse"}
    for label, recs, n_dense in (("traffic", records, n_traffic), ("e125", e125_records, n_e125)):
        for rec in recs:
            path = kernel_path.get(rec["name"])
            counts = n_dense if path is None else word_launches[(path, label)]
            rec["launches"] = counts[rec["name"]]

    # -------------------------------- checks against the torch backend
    p_traffic_t = Parser(cfg_t.replace(backend="torch"), device=dev)
    p_e125_t = Parser(cfg_e.replace(backend="torch"), device=dev)
    want_traffic = torch_backend_columns(p_traffic_t, traffic)
    want_e125 = torch_backend_columns(p_e125_t, e125)
    for got, want in [(r_traffic, want_traffic), (r_e125, want_e125)]:
        if not np.array_equal(got.forest.columns, want[2]):
            raise AssertionError("main path columns != torch backend's")
    for got, want in zip(r_batch, p_traffic_t.parse_batch(batch)):
        if not np.array_equal(got.forest.columns, want.forest.columns):
            raise AssertionError("parse_batch columns != torch backend's")
    small = [(p_traffic, batch[2]), (p_e125, e125[-300:])]
    trees = [p.parse(text).count_trees() for p, text in small]
    if trees != [1, 1]:
        raise AssertionError(f"unambiguous patterns must give one tree, got {trees}")
    cpu = Parser(cfg_t.replace(backend="torch"), device="cpu").parse(batch[3])
    if not np.array_equal(cpu.forest.columns, r_batch[3].forest.columns):
        raise AssertionError("card result != CPU result")
    emit("check", columns_equal_torch_backend=True, trees_small=trees, cpu_equal=True)

    del r_traffic, r_bad, r_e125, r_e125_bad
    for label, text, want, cfg, p_cuda in (("TRAFFIC", traffic, want_traffic, cfg_t, p_traffic),
                                          ("e125", e125, want_e125, cfg_e, p_e125)):
        for parser in (p_cuda, word_parsers[("packed", cfg.regex)],
                       word_parsers[("sparse", cfg.regex)]):
            phase_times(parser, want, text, label)

    emit("kernels_e125", kernels=e125_records)
    print(json.dumps({"kernels": records}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
