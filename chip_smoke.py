#!/usr/bin/env python3
"""Drive repro_torch, the PyTorch/CUDA port of the parser, on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Run from the root of a checkout (it imports ``src/repro_torch``, never JAX
or ``repro``).  Phases, each printing one JSON line:

  env        PyTorch version, card name, ``nvidia-smi`` name and power limit
  build      nvcc build time of the kernels' six sources (one process each)
  kernel_build  the kernels of K1–K7 (K2's walk and row kernels, K7's bf16
             and f32 tensor-core and SIMT kernels among them): registers,
             shared memory and spills (``-Xptxas -v``) and HGMMA / HMMA counts
             in their SASS (``cuobjdump -sass``); fails if a tensor-core
             kernel has none
  kernel     each of the five kernels against its plain PyTorch version at
             the main path's shapes (``torch.equal``), with kernel, plain and
             library times; K1, K2, K4 and K5 with the kernel their plan
             chose and, for a group-table kernel (K1's group kernel, K2's, K4's
             and K5's walk), its shared-memory floor; K5's start rows are the sparse
             backend's own feasible rows for the text; K3 also at the join's
             mat-vec shapes (n = 1, m = 1)
  main_path  the user path, each run counted on its own (every launch count
             set to 0 just before it, read just after): on the ``cuda``
             backend, ``Parser.parse`` of an 8 MiB TRAFFIC log
             (n_chunks=1024), the same log with one corrupted byte,
             ``parse_batch`` of 8 mixed texts, and 1 MiB of e125 text, valid
             and corrupted (K1, K2 and K3 must launch in the TRAFFIC parse, in
             ``parse_batch`` and in the e125 parse); then ``packed`` and
             ``sparse`` with ``kernel=True`` on the same four texts (K4 must
             launch in every packed run and K5 in every sparse run, K2 once in
             each, K1 in none of them, and their columns must equal the
             ``cuda`` run's)
  speculation  the sparse runs' ``ParseResult.speculation``: product rows S
             against ℓp, mean and max feasible width
  check      the main path's packed columns equal the ``torch`` backend's on
             the same card, bit for bit; small texts have exactly one tree
  phases     reach / join / build&merge / host assembly times and MB/s of the
             ``cuda``, ``packed`` and ``sparse`` kernel paths on both texts,
             each one's packed columns held against the ``torch`` backend's
  stream     ``Parser.open_stream()`` with ``max_seal_len`` 65536: the TRAFFIC
             log in 128 appends of 64 KiB on ``cuda`` and on ``sparse``
             (``kernel=True``), and the e125 text in 16 on ``cuda``; each
             append is followed by ``accepted``.  Then an ``edit`` of 1 KiB,
             a ``delete`` of 4 KiB and an ``insert`` of 1 KiB at offsets
             drawn from ``--seed``, and a corrupting edit and its undo.
             ``result()`` after the appends and after each splice, and
             ``accepted`` after each, equal a cold ``Parser.parse`` of the
             text; the corrupting edit turns ``accepted`` False and its undo
             True.  The run must launch its reach kernel and K2 (on ``cuda``
             K3 too), and K2 at most once per distinct leaf length a
             ``result()``.  Prints append MB/s and p50 / p99 seconds, each
             splice's ``edit`` + ``accepted`` and ``result()`` seconds, the
             run's launches, ``cache_nbytes``, ``n_sealed_chunks`` and
             ``tree_height``
  stream_service  4 TRAFFIC sessions on ``cuda``, 16 appends of 64 KiB each
             in turn, drained step by step: every step makes ONE K1 launch
             for all the sessions it serves (counted), and each session's
             ``result()`` equals a cold parse; prints ``stats()["stream"]``
  services   ``submit`` of the ``parse_batch`` texts with ``deadline_s=30``
             equals ``parse_batch``; a 1e-9 s deadline on a bucket with
             observed latency raises ``AdmissionError``; prints the
             ``stats()`` keys, per-bucket p50 / p99 and the counters
  obs_trace  one TRAFFIC parse on ``cuda`` with tracing on into a JSONL span
             log: ``validate_span_tree`` passes, the columns equal the
             untraced parse's, and each phase span's seconds print beside
             the ``phases`` line's host-clock seconds
  fleet      ``ParserFleet`` on the card: 256 tenants in 5 automaton buckets
             (192 on the 8 patterns (a|b)*a(a|b){k}, 4 texts of 4 KiB each;
             48 on TRAFFIC, 16 each on ``cuda``, ``packed`` and ``sparse``
             with ``kernel=True``, 4 logs of 64 KiB each; 16 on e125, one
             text of 64 KiB each: 16 MiB).  ``parse_batch`` (cold, counted)
             and a ``FleetParseService`` drain of the same requests through
             ``submit`` (warm); every tenant's result equals a solo
             ``Parser`` on its backend; each bucket dispatch makes one reach
             launch (K1, K4 or K5) and one K2 launch, and the a/b dispatch's
             K3 launches are the same for 1 tenant as for 192.  Prints sweep
             seconds, texts/s and MB/s of the fleet and of the per-tenant
             solo loop (and per bucket), the table cache's hits and misses,
             buckets, ``compile_count``, and each dispatch's grids; then K1,
             K2, K4 and K5 over the tenant stacks against their plain
             versions (``kernel`` lines, ``case`` "fleet", K1's strip and K2's
             row fallbacks on e125's ℓp-512 bucket)
  analysis   for TRAFFIC and e125: the static ``AnalysisReport``, the
             ``backend="auto"`` choice on the card (a parser built with it
             runs that path), whether the cost model's ranking agrees with
             the measured ``Parser.parse`` MB/s of the three kernel paths,
             and the phase-program lint's findings on those paths at the
             main path's buckets (printed, never exempted)
  mesh       ``ParserConfig(mesh="host")`` across ranks, one process a rank
             (``torch.multiprocessing``, spawn; rendezvous through a file):
             one rank a card over NCCL where there are two cards or more (up
             to 4), else two ranks sharing the one card in a gloo group.  On
             ``cuda`` and on ``packed`` / ``sparse`` with ``kernel=True``,
             every rank runs ``Parser.parse`` of the 8 MiB TRAFFIC log and of
             1 MiB of e125, ``parse_batch`` of the 8 mixed texts and a
             ``StreamingParser`` on the mesh engine (1 MiB of TRAFFIC in 16
             appends), each after the same run without a mesh on the same
             card: the packed columns must be equal, the reach kernel and K2
             (and K3 on ``cuda``) must launch in the mesh run, and
             ``allgather_payload_bytes_total`` must grow by the gathered
             chunks times one product's bytes.  Prints the world, mesh shape,
             group backend and transport, and for every rank and run the
             seconds and MB/s beside the single-process run's, the launches,
             the payload and the gathers.  A failing rank fails the phase (the
             others are killed); a rank still running after MESH_TIMEOUT_S is
             killed and fails it

and the LM serving path, on zamba2-2.7b at full width (54 layers, d_model
2560, vocab 32000) with random weights from ``--seed``:

  kernel          K6 (flash attention) and K7 (SSD chunk) against their plain
                  versions at the prefill's shapes, bf16 and f32 (K6 atol 3e-5
                  f32 / 3e-2 bf16 and a per-row relative limit,
                  ``K6_ROW_REL_TOL``; K7 rtol = atol = 2e-4 in each ``outputs``
                  mode, one line each with its own bound and plan), with
                  kernel, plain and (K6)
                  ``scaled_dot_product_attention`` times and the name of the
                  kernel SDPA ran
  lm_prefill      ``prefill`` of 2 x 2048 tokens in bf16, counted: seconds,
                  tokens/s, peak memory, K6 and K7 launches (9 and 108 for
                  the two-pass SSD: 54 ``"state"``, 54 ``"y"``), finite logits
  lm_profile      one more prefill under ``torch.profiler``: device time by
                  kernel family (K6, K7, cuBLAS GEMMs, the rest) and the
                  largest kernels
  lm_consistency  the same model in f32 on a 1 x 512 prompt: ``prefill``
                  logits (K6, K7) against teacher-forced ``decode_step``
                  logits (no kernel) at the last position, for the weights
                  as initialized (reported with their sensitivity to a 1e-6
                  nudge: the reference's initializer gives attention logits
                  of scale ~80 at full width, an ill-conditioned function)
                  and with unit-scale attention logits (max |Δ| within
                  CONSISTENCY_BOUND)
  lm_serve        ``ServeEngine.generate`` (greedy and sampled) and the
                  ``ContinuousBatcher`` under a ``TokenDFA`` for (ab|a)*c over
                  ``byte_vocab(32000)``: every output a live path of the DFA,
                  every finished one a full match; decode tokens/s

then the f32 LM kernel records (``kernels_f32``, launches of the f32
prefill), the kernel table (one record a launch kind: K7's ``"state"`` and
``"y"`` launches each with their own count, time and bound), the
``nvidia-smi`` line, and as the last line ``{"ok": true, "device": {...}}``.

Times: ``ms``, ``library_ms`` and ``plain_ms`` are CUDA-event times around
eager calls (``time_ms``), which for a call of a few microseconds measure the
host's launch rate; ``device_ms`` and ``library_device_ms`` are the same
calls enqueued behind a device spin, so they run back to back
(``device_ms``).  The kernel and its library yardstick are taken in turns
(library, kernel, kernel, library) under each measure.  Any failure raises
and the script exits non-zero; there is no CPU fallback.  Without a CUDA device it exits 2.
TF32 is off for matmuls and cuDNN, so the f32 plain versions and the f32
model run in full f32.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
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
# the streams' appends and seal cap
STREAM_PIECE = 64 << 10
STREAM_SEAL = 65536
# a timing is the median of TIMING_BATCHES event-timed batches, each of as many
# calls as fill about BATCH_MS (at least one)
TIMING_BATCHES = 5
BATCH_MS = 20.0
SLOW_CALL_MS = 1000.0

# H100 SXM peaks (NVIDIA data sheet, dense): {0,1} products are exact on the
# int8 tensor cores, the cheapest exact type, so the parser's bounds use their
# rate; the LM kernels' bounds use the rate of their operands' type (bf16
# tensor cores, or f32 outside the tensor cores: TF32 would not be exact)
INT8_OPS_PER_S = 1979e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

LM_ARCH = "zamba2-2.7b"
LM_BATCH, LM_LEN = 2, 2048          # a multiple of the SSD chunk (256)
CONSISTENCY_LEN = 512               # two SSD chunks: the join carries a state
# prefill (K6, K7) against teacher-forced decode (no kernel) in f32, max |Δ|
# of the last position's logits (scale ~1: rms-normed features through a
# 1/sqrt(d_model) head), with unit-scale attention logits: the reference's
# own bound (tests/test_models.py); f32 rounding through the 54 layers moves
# these logits by ~1e-4, a wrong state, join or mask by O(1)
CONSISTENCY_BOUND = 2e-3
LM_PATTERN = "(ab|a)*c"
# K6 against its plain version: max |err| within 3e-5 (f32) / 3e-2 (bf16), and
# the largest error of one output row (one batch, position and head) relative
# to that row, ‖got − want‖ / ‖want‖ over head_dim, within K6_ROW_REL_TOL.
# With q, k, v ~ N(0, 1) a row averaging n keys has outputs of RMS ~sqrt(e/n)
# (0.036 at n = 2048): the absolute limit is that size, the relative one sees
# a fault confined to late rows (a dropped key tile moves them by ~sqrt(64/n)).
K6_ROW_REL_TOL = {"bfloat16": 2e-2, "float32": 1e-4}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_query(fields: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def nvidia_smi_line() -> str:
    return nvidia_smi_query("name,power.limit")


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


def mixed_batch(traffic: bytes):
    """The main path's ``parse_batch`` texts: 1 to 20000 lines of the log,
    an empty text and a corrupted one."""
    lines = traffic.split(b"\n")[:-1]
    batch = [b"\n".join(lines[:n]) + b"\n" for n in (1, 3, 40, 500, 4000, 20000)]
    return batch + [b"", corrupt(batch[3])]


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


def bound_ms(ops: float, n_bytes: float, ops_per_s: float = INT8_OPS_PER_S):
    t_ops = ops / ops_per_s * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _device_us(ev) -> float:
    return getattr(ev, "device_time_total", 0.0) or getattr(ev, "cuda_time_total", 0.0)


def device_ms(fn) -> float:
    """Device time of one call of ``fn`` without the host's launch gaps: the
    median over TIMING_BATCHES CUDA-event-timed batches, each enqueued behind
    a device spin (``torch.cuda._sleep``) that outlasts the host's time to
    enqueue the batch, so that the calls run back to back.  A call of a few
    microseconds has an event time (``time_ms``) set by the host's launch
    rate; this is its time on the card.  A call that synchronizes the host
    inside gets nothing from the spin and measures as ``time_ms`` would."""
    import statistics

    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    n = max(1, min(200, int(BATCH_MS / max(first_ms, 1e-3))))
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin_cycles = int(min(enqueue_s, 1.0) * 4e9)     # twice the enqueue time at <= 2 GHz
    times = []
    for _ in range(TIMING_BATCHES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def in_turns(measure, kernel_fn, library_fn):
    """``measure`` of a kernel and of its library yardstick, taken in turns
    (library, kernel, kernel, library) within this run; returns the kernel's
    mean and the library's mean."""
    lib0, k0, k1, lib1 = (measure(f) for f in (library_fn, kernel_fn, kernel_fn, library_fn))
    return (k0 + k1) / 2, (lib0 + lib1) / 2


def kernels_run(fn):
    """Names of the kernels one call of ``fn`` launches, longest first, from
    ``torch.profiler`` (["not recorded"] if it saw no kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [(_device_us(ev), ev.key) for ev in prof.key_averages()
           if ev.device_type.name == "CUDA" and _device_us(ev) > 0]
    return [name for _, name in sorted(evs, reverse=True)] or ["not recorded"]


def timing_fields(kern_fn, plain_fn, library_fn) -> dict:
    """A kernel record's times: ``ms`` and ``library_ms`` by ``time_ms``,
    ``device_ms`` and ``library_device_ms`` by ``device_ms``, each pair in
    turns where there is a library call, and ``plain_ms`` by ``time_ms``."""
    fields = {"plain_ms": time_ms(plain_fn)}
    for key, measure in (("ms", time_ms), ("device_ms", device_ms)):
        lib_key = "library_" + key
        if library_fn is None:
            fields.update({key: measure(kern_fn), lib_key: None})
        else:
            fields[key], fields[lib_key] = in_turns(measure, kern_fn, library_fn)
    return fields


# the redesigned kernels (K1–K7): their ptxas resources and
# tensor-core instructions are reported, and the latter checked
KERNEL_FUNCS = ("semiring_mm_tc_kernel", "semiring_matvec_kernel", "semiring_vecmat_kernel",
                "flash_bf16_kernel", "flash_f32_kernel", "reach_group_kernel",
                "reach_strip_kernel", "packed_walk_kernel", "packed_fold_kernel",
                "build_merge_walk_kernel", "build_merge_rows_kernel",
                "ssd_tc_kernel", "ssd_tf32_kernel", "ssd_simt_kernel")
TENSOR_CORE_SASS = {"semiring_mm_tc_kernel": ("HMMA", "HGMMA"), "flash_bf16_kernel": ("HGMMA",),
                    "flash_f32_kernel": ("HMMA", "HGMMA"), "ssd_tc_kernel": ("HMMA", "HGMMA"),
                    "ssd_tf32_kernel": ("HMMA",)}
REDESIGNED_SOURCES = ("reach", "build_merge", "semiring", "packed_reach", "flash_attention",
                      "ssd_chunk")


def _kernel_name(mangled: str) -> str:
    """A kernel's name with its template arguments: integers (``<9,4>``) or
    the element type (``<float>``, ``<bf16>``)."""
    for f in KERNEL_FUNCS:
        if f in mangled:
            m = re.search(re.escape(f) + r"I((?:L[a-z]\d+E)+)E", mangled)
            if m:
                return f"{f}<{','.join(re.findall(r'L[a-z](\d+)E', m.group(1)))}>"
            m = re.search(re.escape(f) + r"I(f|13__nv_bfloat16)E", mangled)
            if m:
                return f"{f}<{'float' if m.group(1) == 'f' else 'bf16'}>"
            return f
    return mangled[:80]


def ptxas_resources(source: str) -> dict:
    """Per kernel of ``source``: registers, static shared memory and spill
    bytes, from the ``-Xptxas -v`` lines of its build log."""
    from repro_torch.kernels import ops

    out, cur = {}, None
    for line in ops.build_log(source).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = _kernel_name(m.group(1))
            out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[cur].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            sm = re.search(r"(\d+) bytes smem", line)
            out[cur].update(registers=int(m.group(1)), static_smem=int(sm.group(1)) if sm else 0)
    return out


def sass_tensor_ops(source: str):
    """Per kernel of ``source``'s built library: its HGMMA (wgmma) and HMMA
    (mma.sync) instruction counts from ``cuobjdump -sass``; None where the
    toolkit has no ``cuobjdump``."""
    from repro_torch.kernels import ops

    cuobjdump = Path(ops._nvcc()).parent / "cuobjdump"
    if not cuobjdump.exists():
        return None
    sass = subprocess.run([str(cuobjdump), "-sass", str(ops._target(source))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = _kernel_name(m.group(1))
            counts[cur] = {"HGMMA": 0, "HMMA": 0}
        elif cur is not None:
            op = "HGMMA" if "HGMMA" in line else "HMMA" if "HMMA" in line else None
            if op:
                counts[cur][op] += 1
    return counts


def kernel_build_report() -> None:
    """ptxas resources and SASS tensor-core counts of the redesigned kernels
    (K1–K7); fails if a kernel that the design puts on the tensor cores has
    none."""
    for source in REDESIGNED_SOURCES:
        sass = sass_tensor_ops(source)
        if sass is not None:
            for name, counts in sass.items():
                want = TENSOR_CORE_SASS.get(name.split("<")[0])
                if want and not any(counts[op] > 0 for op in want):
                    raise AssertionError(f"{name}: no {' or '.join(want)} in its SASS: {counts}")
        emit("kernel_build", source=f"src/repro_torch/csrc/{source}.cu",
             ptxas=ptxas_resources(source), sass_tensor_ops=sass)


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
    # K3 at the join's mat-vec shapes too: the forward act (n = 1) and the
    # backward act (m = 1), on the join's own entries; reported, not listed
    v = Jf[:-1].contiguous()
    mv, vm = (a, v.unsqueeze(-1)), (v.unsqueeze(-2), b)
    mv_ops, mv_bytes = 2.0 * (c - 1) * ell ** 2, 4.0 * (c - 1) * (lp * lp + 2 * lp)
    cases += [
        ("semiring_matmul", "src/repro_torch/csrc/semiring.cu", "src/repro/kernels/semiring.py:40",
         ops.semiring_matmul, args, lambda args=args: torch.clamp(torch.bmm(*args), max=1.0),
         mv_ops, mv_bytes, case)
        for case, args in (("matvec", mv), ("vecmat", vm))
    ]
    records = []
    for name, source, replaces, kern, args, library, n_ops, n_bytes, *case in cases:
        got = kern(*args)
        torch.cuda.synchronize()
        want = kern.plain(*args)
        equal = torch.equal(got, want)
        err = (got.double() - want.double()).abs().max().item() if got.numel() else 0.0
        if not equal:
            raise AssertionError(f"{name} {case}: kernel != plain version, max |err| {err}")
        del got, want
        b_ms, b_by = bound_ms(n_ops, n_bytes)
        rec = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": err,
            **timing_fields(lambda: kern(*args), lambda: kern.plain(*args), library),
            "bound_ms": b_ms, "bound_by": b_by,
            "shapes": {"chunks": c, "k": k, "steps": steps, "ell": ell, "ell_pad": lp,
                       "classes": A1, "rows": S if name == "sparse_reach_rows" else lp,
                       "width_mean": w_mean,
                       "operands": [list(x.shape) for x in args if x.dim() == 3]},
        }
        if case:
            rec["case"] = case[0]
        else:
            records.append(rec)
        plan = plan_fields(name, A1, lp, rec["shapes"]["rows"], c, k)
        emit("kernel", pattern=parser.config.regex[:24], tolerance=0, **rec, **plan)
        torch.cuda.empty_cache()
    return records


def plan_fields(name: str, n_classes: int, lp: int, rows: int, chunks: int, k: int) -> dict:
    """K1's, K2's, K4's or K5's plan for the table, and for a group-table
    kernel (K1's group kernel, K2's, K4's and K5's walk) its own floor: at
    each of the chunks · k steps it walks (PAD ones too; K2 twice, forward
    and backward), each of ``rows`` columns (K1) or rows (K4, K5), or K2's
    one frontier, reads W words from each of ℓp/g table entries, which shared
    memory serves at 128 bytes a clock on each SM (the card's SM count and
    maximum SM clock).  Other kernels: no fields."""
    import torch

    from repro_torch.kernels import build, packed_reach, reach

    steps = chunks * k
    if name == "reach_chunk_product":
        kind, g = reach.plan(n_classes, lp)
        fields = {"plan": [kind, g]}
    elif name in ("packed_reach_chunk_product", "sparse_reach_rows"):
        kind, g = packed_reach.plan(n_classes, lp, rows)
        fields = {"plan": [kind, g]}
    elif name == "build_merge_packed":
        p = build.plan(n_classes, lp, chunks)
        kind, g, rows, steps = p.kernel, p.g, 1, 2 * steps
        fields = {"plan": [p.kernel, p.g, p.lanes, p.round, p.both]}
    else:
        return {}
    if kind in ("group", "walk"):
        clock_hz = float(nvidia_smi_query("clocks.max.sm").split()[0]) * 1e6
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        n_bytes = steps * rows * (lp // g) * (lp // 32) * 4
        fields["smem_floor_ms"] = n_bytes / (128 * sms * clock_hz) * 1e3
    return fields


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
    return secs


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
    return out, seconds, ops.launch_counts()


# ------------------------------------------------------------------ LM path


def lm_kernel_cases(cfg, dev, seed: int):
    """K6 and K7 against their plain versions at the shapes zamba2's prefill
    gives them (LM_BATCH x LM_LEN tokens), in bf16 and f32; returns
    {dtype name: [K6 record, K7 record]} (launch counts filled later).

    K6 operations: QK^T and PV over the causal triangle, 2·L(L+1)·hd per
    (batch, head); K7's by ``outputs`` (``ssd_bound``).  Bytes: each input
    read once, each output written once."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.models.mamba import ssm_dims

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    b, L = LM_BATCH, LM_LEN
    h, hd = cfg.shared_attn_heads or cfg.n_heads, cfg.resolved_head_dim
    nh = ssm_dims(cfg.d_model, cfg.ssm)["n_heads"]
    q, hp, n = cfg.ssm.chunk, cfg.ssm.head_dim, cfg.ssm.d_state
    P = b * (L // q) * nh

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).split(".")[-1]
        e = torch.finfo(dtype).bits // 8
        rate = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
        recs = []

        qkv = [randn(b, L, h, hd).to(dtype) for _ in range(3)]
        got = ops.flash_attention(*qkv, causal=True, window=None)
        torch.cuda.synchronize()
        want = ops.flash_attention.plain(*qkv, causal=True, window=None)
        err = (got.float() - want.float()).abs().max().item()
        rel = row_rel_err(got, want)
        tol, rel_tol = (3e-5 if dtype == torch.float32 else 3e-2), K6_ROW_REL_TOL[tag]
        if not (err <= tol and rel <= rel_tol and torch.isfinite(got).all()):
            raise AssertionError(f"flash_attention {tag}: max |err| {err} (limit {tol}), "
                                 f"row-relative {rel} (limit {rel_tol})")
        del got, want
        qt, kt, vt = (t.transpose(1, 2) for t in qkv)            # SDPA's (b, h, L, hd)
        b_ms, b_by = bound_ms(2.0 * L * (L + 1) * hd * b * h, 4.0 * b * L * h * hd * e, rate)
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)  # noqa: E731
        recs.append({
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:96",
            "launches": None, "max_abs_err": err,
            **timing_fields(lambda: ops.flash_attention(*qkv, causal=True, window=None),
                            lambda: ops.flash_attention.plain(*qkv, causal=True, window=None),
                            sdpa),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_kernel": kernels_run(sdpa)[0][:160],
            "max_row_rel_err": rel,
            "shapes": {"dtype": tag, "b": b, "L": L, "h": h, "hd": hd, "tolerance_atol": tol,
                       "tolerance_row_rel": rel_tol},
        })
        del qkv, qt, kt, vt
        torch.cuda.empty_cache()

        xdt = randn(P, q, hp, scale=0.3).to(dtype)
        cs = torch.cumsum(-(torch.rand((P, q, 1), generator=gen, device=dev) * 0.39 + 0.01), dim=1)
        B, C = randn(P, q, n, scale=0.3).to(dtype), randn(P, q, n, scale=0.3).to(dtype)
        S_prev = randn(P, hp, n, scale=0.3)
        args = (xdt, cs, B, C, S_prev)
        emit("kernel", **recs[0])
        recs += ssd_records(args, e, rate, tag)
        del args, xdt, cs, B, C, S_prev
        torch.cuda.empty_cache()
        out[tag] = recs
    return out


def ssd_bound(P, q, hp, n, e, rate, outputs):
    """K7's bound for ``outputs``: y reads xdt, cs, B, C, S_prev and writes y
    with q(q+1)(n + hp) + 2qn·hp operations per program (C·Bᵀ and (L∘CB)·xdt
    over the triangle, C·S_prevᵀ); S_c reads xdt, cs, B and writes S_c with
    2qn·hp; both, the union."""
    ops_y = q * (q + 1) * (n + hp) + 2.0 * q * n * hp
    ops_s = 2.0 * q * n * hp
    common = q * hp * e + 4 * q + q * n * e                     # xdt, cs, B
    bytes_y = q * n * e + 4 * hp * n + 4 * q * hp                # C, S_prev, y
    bytes_s = 4 * n * hp                                         # S_c
    n_ops = P * ({"y": ops_y, "state": ops_s}.get(outputs, ops_y + ops_s))
    n_bytes = P * (common + {"y": bytes_y, "state": bytes_s}.get(outputs, bytes_y + bytes_s))
    return bound_ms(n_ops, n_bytes, rate)


def ssd_records(args, e, rate, tag):
    """K7 against its plain version in each ``outputs`` mode (rtol = atol =
    2e-4), each timed with its own bound and emitted as a ``kernel`` line
    with the kernel its plan chose; returns the records of the modes the
    two-pass SSD launches, ``"state"`` and ``"y"``, for the kernel table."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_chunk as ssd_launcher

    P, q, hp = args[0].shape
    n = args[2].shape[2]
    lib = ops.build()[ssd_launcher.SOURCE]
    # the "state" yardstick: S_c as one einsum, on w o B prepared beforehand
    xdt, cs = args[0], args[1][..., 0]
    wB = torch.exp(cs[:, -1:] - cs)[..., None] * args[2].float()
    xf = xdt.float()
    state_library = lambda: torch.einsum("pqn,pqh->pnh", wB, xf)  # noqa: E731
    records = []
    for outputs in ("both", "state", "y"):
        got = ops.ssd_chunk(*args, outputs=outputs)
        torch.cuda.synchronize()
        want = ops.ssd_chunk.plain(*args, outputs=outputs)
        pairs = [(g, w) for g, w in zip(got, want) if w is not None]
        err = max((g - w).abs().max().item() for g, w in pairs)
        if not all(g is not None and torch.allclose(g, w, rtol=2e-4, atol=2e-4) for g, w in pairs):
            raise AssertionError(f"ssd_chunk {tag} {outputs}: not within rtol = atol = 2e-4 "
                                 f"(max |err| {err})")
        del got, want, pairs
        b_ms, b_by = ssd_bound(P, q, hp, n, e, rate, outputs)
        rec = {
            "name": "ssd_chunk", "case": outputs, "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_chunk.cu",
            "replaces": "src/repro/kernels/ssd_chunk.py:64",
            "launches": None, "max_abs_err": err,
            **timing_fields(lambda o=outputs: ops.ssd_chunk(*args, outputs=o),
                            lambda o=outputs: ops.ssd_chunk.plain(*args, outputs=o),
                            state_library if outputs == "state" else None),
            "bound_ms": b_ms, "bound_by": b_by,
            "shapes": {"dtype": tag, "P": P, "q": q, "hp": hp, "n": n,
                       "tolerance_rtol_atol": 2e-4},
        }
        emit("kernel", **rec,
             plan=ssd_launcher.plan(lib, args[0], args[2], args[3], args[4], outputs))
        if outputs != "both":
            records.append(rec)
        torch.cuda.empty_cache()
    del wB, xf
    return records


def row_rel_err(got, want) -> float:
    """Largest relative error of one attention output row (one batch, position
    and head): ‖got − want‖ / ‖want‖ over head_dim."""
    g, w = got.float(), want.float()
    return ((g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)).max().item()


def lm_prefill_phase(cfg, params, dev, seed: int):
    """``prefill`` of LM_BATCH x LM_LEN tokens, counted; returns the counts."""
    import torch

    from repro_torch.models.model import prefill

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_LEN), generator=gen, device=dev)
    with torch.no_grad():
        prefill(params, tokens, cfg)                       # warm-up (cuBLAS, allocator)
        torch.cuda.reset_peak_memory_stats()
        (logits, _), secs, counts = counted(lambda: prefill(params, tokens, cfg))
        prefill_ms = time_ms(lambda: prefill(params, tokens, cfg))
    n_shared = len(cfg.layer_kinds) // cfg.shared_attn_every
    n_ssm = cfg.layer_kinds.count("ssm")
    want = {"flash_attention": n_shared, "ssd_chunk": 2 * n_ssm,
            "ssd_chunk/state": n_ssm, "ssd_chunk/y": n_ssm}
    if any(counts.get(k) != v for k, v in want.items()):
        raise AssertionError(f"lm_prefill launches {counts}, expected {want}")
    if tuple(logits.shape) != (LM_BATCH, 1, cfg.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError(f"lm_prefill logits: shape {tuple(logits.shape)} or not finite")
    emit("lm_prefill", model=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
         vocab=cfg.vocab_size, n_params=cfg.n_params, dtype=cfg.dtype, batch=LM_BATCH,
         seq=LM_LEN, seconds=secs, tokens_per_s=LM_BATCH * LM_LEN / secs,
         device_ms=prefill_ms,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=counts, logits_finite=True)
    lm_profile(cfg, params, tokens)
    return counts


def lm_profile(cfg, params, tokens) -> None:
    """Device time of one prefill by kernel family, from ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.model import prefill

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prefill(params, tokens, cfg)
        torch.cuda.synchronize()
    families = {"flash_attention": 0.0, "ssd_chunk": 0.0, "gemm": 0.0, "other": 0.0}
    top = []
    for ev in prof.key_averages():
        us = _device_us(ev)
        if not us or ev.device_type.name != "CUDA":
            continue
        name = ev.key.lower()
        fam = ("flash_attention" if "flash_" in name and "kernel" in name
               else "ssd_chunk" if "ssd_" in name and "kernel" in name
               else "gemm" if any(w in name for w in ("gemm", "nvjet", "xmma", "cutlass", "sm90"))
               else "other")
        families[fam] += us / 1e3
        top.append((us / 1e3, ev.key[:80], ev.count))
    top.sort(reverse=True)
    emit("lm_profile", device_ms_by_family=families, top=top[:12])


def _unit_scale_attention(params, cfg):
    """The same weights with the shared block's wq and wk scaled by
    sqrt(heads / d_model): 1/sqrt(d_model), the fan-in of their contraction,
    where the reference's ``scaled`` initializer divides by sqrt(heads)
    (the penultimate axis of a (d_model, heads, head_dim) array).  Attention
    logits then have unit scale instead of ~80."""
    f = ((cfg.shared_attn_heads or cfg.n_heads) / cfg.d_model) ** 0.5
    shared = dict(params["shared_attn"], wq=params["shared_attn"]["wq"] * f,
                  wk=params["shared_attn"]["wk"] * f)
    return dict(params, shared_attn=shared)


def lm_consistency_phase(cfg, params32, dev, seed: int) -> dict:
    """f32 prefill logits (K6, K7) against teacher-forced decode (no kernel)
    at the last position, for the weights as initialized and for the same
    weights with unit-scale attention logits; the second is gated.  Returns
    the kernel launches of the gated run's prefill.

    With the reference's initializer, zamba2's attention logits at full width
    have a scale of ~80, which makes the 54-layer function ill-conditioned:
    ``sensitivity`` (the logits' change when the embeddings move by a
    relative 1e-6, about f32 rounding) shows how far any two f32 evaluation
    orders may drift apart, kernels or none."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models.model import decode_step, make_cache, prefill

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (1, CONSISTENCY_LEN), generator=gen, device=dev)
    noise = 1.0 + 1e-6 * torch.randn(params32["embed"].shape, generator=gen, device=dev)
    runs = {}
    for label, params in (("reference_init", params32),
                          ("unit_scale_attention", _unit_scale_attention(params32, cfg))):
        with torch.no_grad():
            ops.reset_launches()
            full, _ = prefill(params, tokens, cfg)
            launches = {k: n for k, n in ops.launch_counts().items() if n}
            nudged, _ = prefill(dict(params, embed=params["embed"] * noise), tokens, cfg)
            caches = make_cache(cfg, 1, CONSISTENCY_LEN, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for t in range(CONSISTENCY_LEN):
                step, caches = decode_step(params, caches, tokens[:, t : t + 1], cfg)
            torch.cuda.synchronize()
            decode_s = time.perf_counter() - t0
        runs[label] = {"max_abs_delta": (full - step).abs().max().item(),
                       "sensitivity": (full - nudged).abs().max().item(),
                       "logits_max_abs": full.abs().max().item(),
                       "prefill_launches": launches, "decode_s": decode_s,
                       "decode_tokens_per_s": CONSISTENCY_LEN / decode_s}
        del full, nudged, step, caches
    gated = runs["unit_scale_attention"]["max_abs_delta"]
    if not gated <= CONSISTENCY_BOUND:
        raise AssertionError(f"lm_consistency: max |Δ| {gated} > {CONSISTENCY_BOUND}")
    emit("lm_consistency", model=cfg.name, dtype="float32", prompt=CONSISTENCY_LEN,
         bound=CONSISTENCY_BOUND, gated="unit_scale_attention", **runs)
    return runs["unit_scale_attention"]["prefill_launches"]


def _dfa_path(tdfa, tokens) -> bool:
    state = tdfa.initial
    for tok in tokens:
        state = int(tdfa.delta[state, int(tok)])
        if state < 0:
            return False
    return True


def lm_serve_phase(cfg, params, dev, seed: int) -> None:
    """``ServeEngine.generate`` and the ``ContinuousBatcher`` under a token
    DFA: live DFA paths always, full matches when finished."""
    import re

    import numpy as np
    import torch

    from repro_torch.core.matrices import build_matrices
    from repro_torch.core.segments import compute_segments
    from repro_torch.serve.engine import ServeEngine, TokenDFA, byte_vocab
    from repro_torch.serve.scheduler import ContinuousBatcher, Request

    t0 = time.perf_counter()
    tdfa = TokenDFA.from_matrices(build_matrices(compute_segments(LM_PATTERN)),
                                  byte_vocab(cfg.vocab_size))
    dfa_s = time.perf_counter() - t0
    eos, max_new = 0, 24

    def check(out_tokens, cut: bool, label: str) -> bool:
        toks = [int(t) for t in out_tokens]
        if not _dfa_path(tdfa, toks):
            raise AssertionError(f"lm_serve {label}: {toks} leaves the DFA")
        text = "".join(chr(t) for t in toks)
        if not cut and not re.fullmatch(LM_PATTERN, text):
            raise AssertionError(f"lm_serve {label}: finished output {text!r} does not match")
        return not cut

    runs = {}
    engine = ServeEngine(cfg, params, max_seq=64, batch=4, eos_id=eos, device=dev)
    calls = [0]
    one_step = engine._step

    def counted_step(caches, tokens):
        calls[0] += 1
        return one_step(caches, tokens)

    engine._step = counted_step
    prompts = np.array([[ord(c) for c in p] for p in ("abac", "xyz1", "a  a", "c\n\n\n")],
                       np.int32)
    for label, temperature in (("greedy", 0.0), ("sampled", 1.0)):
        calls[0] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = engine.generate(prompts, max_new, temperature=temperature, seed=seed,
                              constraint=tdfa)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        finished = 0
        for row, acc in zip(res.tokens.tolist(), res.accepted):
            cut = eos not in row
            finished += check(row if cut else row[: row.index(eos)], cut, label)
            if not cut and not acc:
                raise AssertionError(f"lm_serve {label}: finished row not accepted")
        runs[label] = {"rows": len(prompts), "decode_steps": calls[0],
                       "new_tokens": int(res.tokens.size), "finished": finished,
                       "seconds": secs, "decode_tokens_per_s": len(prompts) * calls[0] / secs,
                       "outputs": ["".join(chr(t) for t in r if t != eos) for r in res.tokens.tolist()]}
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, prompt=rng.integers(97, 100, size=L).astype(np.int32), max_new=16,
                    temperature=0.0 if i % 2 else 1.0, constraint=tdfa)
            for i, L in enumerate([2, 5, 3, 9, 4, 7])]
    batcher = ContinuousBatcher(cfg, params, batch=4, max_seq=256, eos_id=eos, seed=seed,
                                device=dev)
    for r in reqs:
        batcher.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = batcher.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if sorted(r.rid for r in done) != list(range(len(reqs))):
        raise AssertionError(f"lm_serve batcher: finished {[r.rid for r in done]}")
    finished = sum(check(r.output, r.output.size >= r.max_new, "batcher") for r in done)
    steps = batcher._caches["pos"]
    runs["batcher"] = {"requests": len(reqs), "slots": 4, "decode_steps": steps,
                       "finished": finished, "seconds": secs,
                       "decode_tokens_per_s": 4 * steps / secs,
                       "outputs": ["".join(chr(t) for t in r.output) for r in done]}
    if runs["sampled"]["finished"] + finished < 1:
        raise AssertionError("lm_serve: no constrained output finished")
    emit("lm_serve", model=cfg.name, pattern=LM_PATTERN, dfa_states=int(tdfa.delta.shape[0]),
         token_dfa_s=dfa_s, all_outputs_in_language=True, **runs)


def count_key(rec) -> str:
    """The launch count that belongs to a kernel record: K7's by its
    ``outputs`` mode (``ops.launch_counts``), the others' by name."""
    return f"{rec['name']}/{rec['case']}" if rec["name"] == "ssd_chunk" else rec["name"]


def lm_phases(dev, seed: int):
    """The LM serving path; returns the bf16 kernel records with the
    launches of the counted prefill."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params

    cfg = get_config(LM_ARCH)
    kernel_records = lm_kernel_cases(cfg, dev, seed)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    emit("lm_init", model=cfg.name, dtype=cfg.param_dtype, seconds=time.perf_counter() - t0,
         bytes=sum(t.numel() * t.element_size() for t in _leaves(params)))
    bf16 = kernel_records["bfloat16"]
    counts = lm_prefill_phase(cfg, params, dev, seed)
    for rec in bf16:
        rec["launches"] = counts[count_key(rec)]
    lm_serve_phase(cfg, params, dev, seed)
    params32 = _map_leaves(params, lambda t: t.float())
    del params
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32",
                                attn_p_dtype="float32")
    counts32 = lm_consistency_phase(cfg32, params32, dev, seed)
    for rec in kernel_records["float32"]:
        rec["launches"] = counts32.get(count_key(rec), 0)
    emit("kernels_f32", prompt=CONSISTENCY_LEN, kernels=kernel_records["float32"])
    del params32
    torch.cuda.empty_cache()
    return bf16


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def _map_leaves(tree, fn):
    return {k: _map_leaves(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


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
    from repro_torch.kernels import ops

    # plain versions and the f32 model in full f32: TF32 off for matmuls and cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi, matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    t0 = time.perf_counter()
    libs = ops.build()
    emit("build", seconds=time.perf_counter() - t0, sources=sorted(libs))
    kernel_build_report()

    records = parser_phases(args, dev)
    mesh_phase(args)
    records += lm_phases(dev, args.seed)
    print(json.dumps({"kernels": records}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def parser_phases(args, dev):
    """Every parser path and K1–K5; returns their kernel records (TRAFFIC)."""
    import numpy as np
    import torch

    from repro_torch import Parser, ParserConfig

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
    batch = mixed_batch(traffic)
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
    parse_mb_per_s = {("TRAFFIC", "cuda"): len(traffic) / t_traffic / 1e6,
                      ("e125", "cuda"): len(e125) / t_e125 / 1e6}
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
            if n[kernel] < 1 or n["build_merge_packed"] != 1 or n["reach_chunk_product"] != 0:
                raise AssertionError(f"{backend} {label}: launches {n}")
            if r.ok != want.ok:
                raise AssertionError(f"{backend} {label}: verdict {r.ok}, cuda says {want.ok}")
            if not np.array_equal(r.forest.columns, want.forest.columns):
                raise AssertionError(f"{backend} {label}: columns != the cuda backend's")
            runs[label] = {"bytes": len(text), "bucket": list(r.bucket), "ok": r.ok,
                           "seconds": secs, "mb_per_s": len(text) / secs / 1e6,
                           "launches": n}
            word_launches[(backend, label)] = n
            if "corrupted" not in label:
                parse_mb_per_s[(label.replace("traffic", "TRAFFIC"), backend)] = len(text) / secs / 1e6
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

    del r_bad, r_e125_bad
    cuda_secs = {}
    for label, text, want, cfg, p_cuda in (("TRAFFIC", traffic, want_traffic, cfg_t, p_traffic),
                                          ("e125", e125, want_e125, cfg_e, p_e125)):
        for parser in (p_cuda, word_parsers[("packed", cfg.regex)],
                       word_parsers[("sparse", cfg.regex)]):
            secs = phase_times(parser, want, text, label)
            if parser is p_cuda:
                cuda_secs[label] = secs

    emit("kernels_e125", kernels=e125_records)
    del word_parsers, p_traffic_t, p_e125_t, want_traffic, want_e125
    torch.cuda.empty_cache()

    # ---------------- streaming, the services and tracing on the same texts
    t0 = time.perf_counter()
    colds = ColdParses({TRAFFIC_RE: p_traffic, E125_RE: p_e125})
    colds.seed(TRAFFIC_RE, traffic, r_traffic)
    colds.seed(E125_RE, e125, r_e125)
    del r_e125
    stream_phase(args, dev, colds, traffic, e125, cfg_t, cfg_e)
    stream_service_phase(args, dev, colds, cfg_t)
    services_phase(p_traffic, batch, r_batch)
    obs_trace_phase(dev, cfg_t, traffic, r_traffic, cuda_secs["TRAFFIC"])
    emit("stream_phases_total", seconds=time.perf_counter() - t0)
    del colds, r_traffic, r_batch, p_traffic, p_e125
    torch.cuda.empty_cache()

    # ------------------------------------- the fleet and the static analysis
    t0 = time.perf_counter()
    records += fleet_phase(args, dev)
    analysis_phase(dev, parse_mb_per_s)
    emit("fleet_analysis_total", seconds=time.perf_counter() - t0)
    return records


# ------------------------------------------------ streaming, services, tracing


class ColdParses:
    """Cold ``Parser.parse`` forest columns of a text on the ``cuda``
    backend, each text parsed once: what every stream result is held
    against."""

    def __init__(self, parsers):
        self.parsers = parsers
        self._cols = {}

    def seed(self, regex, text, result):
        self._cols[(regex, text)] = (result.ok, result.forest.columns)

    def __call__(self, regex, text):
        if (regex, text) not in self._cols:
            self.seed(regex, text, self.parsers[regex].parse(text))
        return self._cols[(regex, text)]


def next_line(text: bytes, pos: int) -> int:
    """The first line start at or after ``pos``."""
    return pos if pos == 0 or text[pos - 1:pos] == b"\n" else text.index(b"\n", pos) + 1


SPLICES = ("edit", "delete", "insert", "corrupt")


def splice(kind: str, text: bytes, which: str, rng, seed: int):
    """One of the stream phase's splices of the current ``text`` at an
    offset drawn from ``rng``: (lo, hi, replacement).  ``edit`` swaps 1 KiB
    for 1 KiB, ``delete`` cuts 4 KiB, ``insert`` adds 1 KiB, and
    ``corrupt`` writes one byte outside the language.  TRAFFIC's splices cut
    and paste whole log lines, so the text stays valid; e125's stay clear of
    the last 126 characters."""
    lo = int(rng.integers(8192, len(text) - 16384))
    if kind == "corrupt":
        return lo, lo + 1, b"~"
    if which == "traffic":
        lo = next_line(text, lo)
        size = {"edit": 1024, "delete": 4096, "insert": 0}[kind]
        hi = next_line(text, lo + size) if size else lo
        repl = b"" if kind == "delete" else traffic_log(1024, seed + 100 + SPLICES.index(kind))
    else:
        hi = lo + {"edit": 1024, "delete": 4096, "insert": 0}[kind]
        repl = b"" if kind == "delete" else e125_text(
            1024 + 126, seed + 100 + SPLICES.index(kind))[:1024]
    return lo, hi, repl


def _add_counts(total, counts):
    for key, n in counts.items():
        total[key] = total.get(key, 0) + n


def stream_run(label, parser, colds, text: bytes, which: str, seed: int, n_pieces: int):
    """``text`` appended to ``parser.open_stream()`` in ``n_pieces`` pieces
    (each append followed by ``accepted``, which absorbs it), then spliced;
    after the appends and after each splice ``accepted`` and ``result()``
    equal a cold parse of the text.  Every stream call is counted; the cold
    parses are not."""
    import statistics

    import numpy as np

    regex = parser.config.regex
    reach_kernel = {"cuda": "reach_chunk_product", "packed": "packed_reach_chunk_product",
                    "sparse": "sparse_reach_rows"}[parser.backend_name]
    launches = {}
    piece = len(text) // n_pieces
    append_s = []
    k2_per_result = []

    def leaf_lengths(stream_parser):
        lens = [len(c) for c in stream_parser._chunk_classes()]
        return len(set(lens)), len({stream_parser._bucket_len(n) for n in lens})

    def check_result(st, sp, current):
        r, secs, n = counted(st.result)
        _add_counts(launches, n)
        distinct, padded = leaf_lengths(sp)
        if n["build_merge_packed"] > distinct:
            raise AssertionError(f"{label}: {n['build_merge_packed']} K2 launches for "
                                 f"{distinct} distinct leaf lengths")
        k2_per_result.append([n["build_merge_packed"], distinct, padded])
        ok, cols = colds(regex, current)
        if r.ok != ok or not np.array_equal(r.forest.columns, cols):
            raise AssertionError(f"{label}: result() != a cold Parser.parse")
        return secs

    with parser.open_stream() as st:
        sp = parser.stream_service._session(st.sid).parser
        for i in range(n_pieces):
            chunk = text[i * piece:(i + 1) * piece if i + 1 < n_pieces else len(text)]
            ok, secs, n = counted(lambda: (st.append(chunk), st.accepted)[1])
            _add_counts(launches, n)
            append_s.append(secs)
        if not ok:
            raise AssertionError(f"{label}: the appended text is not accepted")
        # one cap-length piece's reach and one compose of two products,
        # CUDA events around eager calls (as ``time_ms``): an append's parts
        eng = parser.engine
        grid = eng.chunks_tensor(eng._pad_to(eng.classes_of_text(text[:STREAM_SEAL]), 1,
                                             STREAM_SEAL))
        product = eng.phases.reach(eng.tables.N, grid)[0]
        part_ms = {"reach_piece_ms": time_ms(lambda: eng.phases.reach(eng.tables.N, grid)),
                   "compose_ms": time_ms(lambda: eng.phases.compose(product, product))}
        del grid, product
        result_s = [check_result(st, sp, text)]
        current = text
        splice_s = {}
        rng = np.random.default_rng(seed)
        for kind in SPLICES:
            lo, hi, repl = splice(kind, current, which, rng, seed)
            old = current[lo:hi]
            (_, ok), secs, n = counted(lambda: (st.edit(lo, hi, repl), st.accepted))
            _add_counts(launches, n)
            current = current[:lo] + repl + current[hi:]
            splice_s[kind] = {"lo": lo, "removed": hi - lo, "inserted": len(repl),
                              "edit_accepted_s": secs}
            if kind == "corrupt":
                if ok:
                    raise AssertionError(f"{label}: a corrupting edit left it accepted")
                (_, ok), secs, n = counted(lambda: (st.edit(lo, lo + 1, old), st.accepted))
                _add_counts(launches, n)
                current = current[:lo] + old + current[lo + 1:]
                splice_s["undo"] = {"edit_accepted_s": secs}
                if not ok:
                    raise AssertionError(f"{label}: undoing the corrupting edit left it rejected")
                continue
            if ok != colds(regex, current)[0]:
                raise AssertionError(f"{label}: accepted after {kind} != a cold parse's")
            splice_s[kind]["result_s"] = check_result(st, sp, current)
        state = {"cache_nbytes": sp.cache_nbytes, "n_sealed_chunks": sp.n_sealed_chunks,
                 "tree_height": sp.tree_height, "rebuilds": sp.rebuilds}
    need = [reach_kernel, "build_merge_packed"] + (
        ["semiring_matmul"] if parser.backend_name == "cuda" else [])
    if min(launches[k] for k in need) <= 0:
        raise AssertionError(f"{label}: a kernel of the stream path never launched: {launches}")
    emit("stream", run=label, backend=parser.backend_name, kernel=parser.config.kernel,
         bytes=len(text), pieces=n_pieces, piece_bytes=piece,
         max_seal_len=parser.config.max_seal_len,
         append_mb_per_s=len(text) / sum(append_s) / 1e6,
         append_p50_s=statistics.median(append_s),
         append_p99_s=float(np.percentile(append_s, 99, method="higher")),
         append_max_s=max(append_s), **part_ms, result_s=result_s[0], splices=splice_s,
         k2_launches_distinct_padded=k2_per_result, launches=launches, **state,
         results_equal_cold_parse=True)


def stream_phase(args, dev, colds, traffic: bytes, e125: bytes, cfg_t, cfg_e) -> None:
    """TRAFFIC on ``cuda`` and on ``sparse`` (``kernel=True``) in 128 pieces,
    and 1 MiB of e125 on ``cuda`` in 16, each with ``max_seal_len`` 65536."""
    from repro_torch import Parser

    for label, cfg, text, which, n_pieces in (
            ("traffic_cuda", cfg_t, traffic, "traffic", 128),
            ("traffic_sparse", cfg_t.replace(backend="sparse", kernel=True), traffic,
             "traffic", 128),
            ("e125_cuda", cfg_e, e125, "e125", 16)):
        parser = Parser(cfg.replace(max_seal_len=STREAM_SEAL), device=dev)
        stream_run(label, parser, colds, text, which, args.seed, n_pieces)
        del parser


def stream_service_phase(args, dev, colds, cfg_t) -> None:
    """4 TRAFFIC sessions on ``cuda``, each given 16 pieces of 64 KiB in
    turn, then drained step by step: every step that serves several
    sessions makes ONE K1 launch; each session's result equals a cold parse."""
    import numpy as np
    import torch

    from repro_torch import Parser
    from repro_torch.kernels import ops

    parser = Parser(cfg_t.replace(max_seal_len=STREAM_SEAL), device=dev)
    texts = [traffic_log(16 * STREAM_PIECE, args.seed + 10 + i) for i in range(4)]
    streams = [parser.open_stream() for _ in texts]
    svc = parser.stream_service
    sessions = [svc._session(st.sid).parser for st in streams]
    for i in range(16):
        for st, text in zip(streams, texts):
            st.append(text[i * STREAM_PIECE:(i + 1) * STREAM_PIECE])
    steps = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while True:
        before = [sp.n for sp in sessions]
        _, secs, n = counted(svc.step)
        served = sum(sp.n != b for sp, b in zip(sessions, before))
        if served == 0:
            break
        if n["reach_chunk_product"] != 1:
            raise AssertionError(f"a step serving {served} sessions made "
                                 f"{n['reach_chunk_product']} K1 launches")
        steps.append([served, secs])
    drain_s = time.perf_counter() - t0
    if max(s for s, _ in steps) < 2:
        raise AssertionError("no step served several sessions")
    for st, text in zip(streams, texts):
        r = st.result()
        ok, cols = colds(TRAFFIC_RE, text)
        if r.ok != ok or not np.array_equal(r.forest.columns, cols):
            raise AssertionError("a session's result() != a cold Parser.parse")
    stats = parser.stats()["stream"]
    stats["buckets"] = {str(k): v for k, v in stats["buckets"].items()}
    emit("stream_service", sessions=len(streams), bytes_each=len(texts[0]),
         steps=len(steps), sessions_per_step=[s for s, _ in steps],
         step_p50_s=float(np.median([t for _, t in steps])),
         drain_s=drain_s, drain_mb_per_s=sum(map(len, texts)) / drain_s / 1e6,
         k1_launches_per_step=1, results_equal_cold_parse=True, stats=stats)
    for st in streams:
        st.close()


def services_phase(p_traffic, batch, r_batch) -> None:
    """``submit`` of the ``parse_batch`` texts with a 30 s deadline equals
    ``parse_batch``; a 1e-9 s deadline on a bucket with observed latency is
    refused with ``AdmissionError``; ``stats()`` printed."""
    import numpy as np

    from repro_torch import AdmissionError

    tickets = [p_traffic.submit(text, deadline_s=30.0) for text in batch]
    results = [t.result() for t in tickets]
    for got, want in zip(results, r_batch):
        if got.ok != want.ok or not np.array_equal(got.forest.columns, want.forest.columns):
            raise AssertionError("submit(...).result() != parse_batch")
    try:
        p_traffic.submit(batch[3], deadline_s=1e-9)
    except AdmissionError as e:
        refused = {"bucket": list(e.bucket), "predicted_s": e.predicted_s}
    else:
        raise AssertionError("a 1e-9 s deadline on an observed bucket was admitted")
    stats = p_traffic.stats()
    buckets = {f"{c}x{k}": {"p50_s": b["p50_latency_s"], "p99_s": b["p99_latency_s"],
                            "served": b["served"]}
               for (c, k), b in stats["parse"]["buckets"].items()}
    counters = {name: {",".join(f"{k}={v}" for k, v in sorted(s["labels"].items())): s["value"]
                       for s in series}
                for name, series in stats["metrics"].items() if series[0]["kind"] == "counter"}
    emit("services", submitted=len(tickets), results_equal_parse_batch=True,
         admission_refused=refused, stats_keys=sorted(stats), parse_buckets=buckets,
         counters=counters)


def obs_trace_phase(dev, cfg_t, traffic: bytes, r_traffic, host_secs) -> None:
    """One traced TRAFFIC parse on ``cuda`` into a JSONL span log: the span
    tree validates, the columns equal the untraced parse's, and each phase
    span's time is printed beside the ``phases`` line's host-clock times."""
    import tempfile

    import numpy as np

    from repro_torch import ObsConfig, Parser
    from repro_torch.obs import read_spans_jsonl, validate_span_tree

    with tempfile.TemporaryDirectory() as tmp:
        log = Path(tmp) / "spans.jsonl"
        parser = Parser(cfg_t.replace(obs=ObsConfig(enabled=True, span_log=str(log))),
                        device=dev)
        r = parser.parse(traffic)
        parser.close()
        spans = read_spans_jsonl(log)
    tree = validate_span_tree(spans, r.trace_id)
    if not np.array_equal(r.forest.columns, r_traffic.forest.columns):
        raise AssertionError("traced columns != the untraced parse's")
    span_s = {s["name"]: s["duration_s"] for s in tree["children"]}
    emit("obs_trace", trace_id=r.trace_id, root=tree["root"]["name"],
         root_s=tree["root"]["duration_s"], span_s=span_s,
         phases_line_s=host_secs, span_tree_valid=True, columns_equal_untraced=True)


# ------------------------------------------------------ the fleet, the analysis

FLEET_AB_PATTERNS = [f"(a|b)*a(a|b){{{k}}}" for k in range(1, 9)]
FLEET_AB, FLEET_AB_TEXTS, FLEET_AB_BYTES = 192, 4, 4 << 10
FLEET_TRAFFIC, FLEET_TRAFFIC_TEXTS, FLEET_BYTES = 48, 4, 64 << 10
FLEET_E125 = 16
FLEET_MAX_BATCH = 1024      # a bucket's requests in one dispatch


def fleet_tenants(seed: int):
    """The log-routing fleet: {tenant: (ParserConfig, [texts])}, 256 tenants
    in 5 automaton buckets: 192 on the 8 patterns (a|b)*a(a|b){k} (cuda, 4
    texts of 4 KiB of random a/b each), 48 on TRAFFIC (16 each on cuda,
    packed and sparse with kernel=True, 4 logs of 64 KiB each) and 16 on
    e125 (cuda, one text of 64 KiB each); about 16 MiB a sweep.  Chunks of
    about 1024 characters."""
    import numpy as np

    from repro_torch import ParserConfig

    rng = np.random.Generator(np.random.Philox(seed))
    ab = np.frombuffer(b"ab", dtype=np.uint8)
    tenants = {}
    for i in range(FLEET_AB):
        cfg = ParserConfig(regex=FLEET_AB_PATTERNS[i % 8], backend="cuda",
                           n_chunks=FLEET_AB_BYTES // 1024)
        tenants[f"ab{i:03d}"] = (cfg, [ab[rng.integers(0, 2, FLEET_AB_BYTES)].tobytes()
                                      for _ in range(FLEET_AB_TEXTS)])
    for j in range(FLEET_TRAFFIC):
        backend = ("cuda", "packed", "sparse")[j * 3 // FLEET_TRAFFIC]
        cfg = ParserConfig(regex=TRAFFIC_RE, backend=backend, kernel=backend != "cuda",
                           n_chunks=FLEET_BYTES // 1024)
        tenants[f"traffic-{backend}{j:02d}"] = (
            cfg, [traffic_log(FLEET_BYTES, seed + 100 + 8 * j + b)
                  for b in range(FLEET_TRAFFIC_TEXTS)])
    for j in range(FLEET_E125):
        cfg = ParserConfig(regex=E125_RE, backend="cuda", n_chunks=FLEET_BYTES // 1024)
        tenants[f"e125-{j:02d}"] = (cfg, [e125_text(FLEET_BYTES, seed + 1000 + j)])
    return tenants


class DispatchLog:
    """Launch counts of each bucket dispatch of a fleet: ``run_bucket``
    wrapped, the counts read before and after each (synchronized)."""

    KERNELS = ("reach_chunk_product", "packed_reach_chunk_product", "sparse_reach_rows",
               "build_merge_packed", "semiring_matmul")

    def __init__(self, engine):
        import torch

        from repro_torch.core.backend import next_pow2
        from repro_torch.kernels import build, ops, packed_reach, reach

        self.records = []
        run = engine.run_bucket

        def grids(bucket, items):
            """The bucket's reach and K2 launch grids (x, y = tenants, threads)."""
            (key, A1, lp), (c, _) = bucket
            per = {}
            for tid, _ in items:
                per[tid] = per.get(tid, 0) + 1
            T = next_pow2(len(per))
            C = T * next_pow2(max(per.values())) * c
            backend = engine.runner(bucket[0]).backend
            if key.startswith("cuda"):
                reach_grid, reach_kind = reach.grid(A1, lp, C, T), reach.plan(A1, lp)[0]
            else:
                rows = backend._width if key.startswith("sparse") else lp
                reach_grid = packed_reach.grid(A1, lp, rows, C, T)
                reach_kind = packed_reach.plan(A1, lp, rows)[0]
            return {"chunks": C, "reach": list(reach_grid), "reach_kernel": reach_kind,
                    "build_merge": list(build.grid(A1, lp, C, T)),
                    "build_merge_kernel": build.plan(A1, lp, C).kernel}

        def run_bucket(bucket, items):
            torch.cuda.synchronize()
            before = ops.launch_counts()
            t0 = time.perf_counter()
            out = run(bucket, items)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            after = ops.launch_counts()
            self.records.append({
                "bucket": "|".join(map(str, bucket[0])), "c_k": list(bucket[1]),
                "tenants": len({tid for tid, _ in items}), "texts": len(items),
                "seconds": seconds, "launches": {k: after[k] - before[k] for k in self.KERNELS},
                "grids": grids(bucket, items)})
            return out

        engine.run_bucket = run_bucket

    def check(self, label: str) -> None:
        """One reach launch (K1, K4 or K5) and one K2 launch a dispatch."""
        for rec in self.records:
            n = rec["launches"]
            reach = n["reach_chunk_product"] + n["packed_reach_chunk_product"] + n["sparse_reach_rows"]
            if reach != 1 or n["build_merge_packed"] != 1:
                raise AssertionError(f"{label}: a bucket dispatch launched {n}")


def fleet_kernel_records(fleet, tenants, counts):
    """K1, K2, K4 and K5 over a bucket's tenant stack, at the fleet run's
    shapes, against their plain versions (``torch.equal``): K1 and K2 on the
    192-tenant a/b bucket (their group kernel and walk, ``case`` "fleet")
    and on e125's (ℓp 512: K1's strip and K2's row fallback,
    "fleet_strip", "fleet_rows"), K4 and K5 on TRAFFIC's packed and sparse
    buckets; one record a launch kind, with the warm run's launches of that
    kind (``counts``) and the launch's grid.  Bounds count each tenant's real
    steps at its own ℓ (K5 at its mean feasible width)."""
    import numpy as np
    import torch

    from repro_torch.core.backend import TorchBackend
    from repro_torch.core.matrices import (
        feasible_start_widths,
        pack_transition_table_torch,
        sparse_init_rows,
    )
    from repro_torch.kernels import build, ops, packed_reach, reach

    engine = fleet.engine

    def bucket_inputs(prefix):
        tids = [t for t in tenants if t.startswith(prefix)]
        ts = engine.tenant(tids[0])
        runner = engine.runner(ts.bucket_key)
        per = {t: [engine.tenant(t).classes_of_text(x) for x in tenants[t][1]] for t in tids}
        c, k = ts.text_bucket(len(next(iter(per.values()))[0]))
        rows, grid = runner.host_batch(c, k, per)
        N, I, F = runner.operands(rows)
        ids = torch.from_numpy(grid.reshape(-1, k)).to(N.device)
        real = (grid != runner.pad_class).reshape(len(rows), -1).sum(axis=1)
        ells = [engine.tenant(t).tables.ell for t in tids]
        return runner, tids, grid, N, I, F, ids, real, ells

    records = []

    def once(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    def record(name, kern, args, n_ops, n_bytes, grid_xyz, runner, extra, case="fleet"):
        got, k_ms = once(lambda: kern(*args))
        want, p_ms = once(lambda: kern.plain(*args))
        if not torch.equal(got, want):
            raise AssertionError(f"{name} ({case}): kernel != plain version")
        del got, want
        # a call slower than SLOW_CALL_MS is timed by its one call here (it
        # has no launch gap for device_ms to remove)
        if k_ms >= SLOW_CALL_MS:
            fields = {"plain_ms": p_ms, "ms": k_ms, "library_ms": None, "device_ms": k_ms,
                      "library_device_ms": None}
        else:
            fields = timing_fields(lambda: kern(*args), (lambda: None) if p_ms >= SLOW_CALL_MS
                                   else (lambda: kern.plain(*args)), None)
            if p_ms >= SLOW_CALL_MS:
                fields["plain_ms"] = p_ms
        b_ms, b_by = bound_ms(n_ops, n_bytes)
        rec = {"name": name, "case": case, "route": "cuda", "source": extra["source"],
               "replaces": extra["replaces"], "launches": counts.get((name, case), 0),
               "max_abs_err": 0.0,
               **fields, "bound_ms": b_ms, "bound_by": b_by,
               "shapes": {"bucket": "|".join(map(str, runner.key)),
                          "tenants": int(args[0].shape[0]), "chunks": int(args[1].shape[0]),
                          "k": int(args[1].shape[1]),
                          "operands": [list(x.shape) for x in args]},
               "grid": list(grid_xyz)}
        emit("kernel", pattern="fleet", tolerance=0, **rec)
        records.append(rec)
        torch.cuda.empty_cache()

    runner, tids, grid, N, I, F, ids, real, ells = bucket_inputs("ab")
    T, A1, lp = N.shape[0], N.shape[1], N.shape[-1]
    C, k = ids.shape
    ops3 = sum(2.0 * s * e ** 3 for s, e in zip(real, ells))
    record("reach_chunk_product", ops.reach_chunk_product, (N, ids), ops3,
           4.0 * (C * k + T * A1 * lp * lp + C * lp * lp), reach.grid(A1, lp, C, T), runner,
           {"source": "src/repro_torch/csrc/reach.cu", "replaces": "src/repro/kernels/reach.py:49"})
    P = ops.reach_chunk_product.plain(N, ids).reshape(grid.shape[:3] + (lp, lp))
    Jf, Jb = TorchBackend().join(P, I[:, None], F[:, None])
    Jf, Jb = Jf.reshape(C, lp).contiguous(), Jb.reshape(C, lp).contiguous()
    del P
    record("build_merge_packed", ops.build_merge_packed, (N, ids, Jf, Jb),
           sum(4.0 * s * e ** 2 for s, e in zip(real, ells)),
           4.0 * (C * k + T * A1 * lp * lp + 2 * C * lp + C * k * lp // 32),
           build.grid(A1, lp, C, T), runner,
           {"source": "src/repro_torch/csrc/build_merge.cu", "replaces": "src/repro/kernels/build.py:60"})
    del Jf, Jb

    # e125's bucket: ℓp 257 → 512, where no group table fits: K1's strip and
    # K2's row fallbacks over the tenant stack
    runner, tids, grid, N, I, F, ids, real, ells = bucket_inputs("e125")
    T, A1, lp = N.shape[0], N.shape[1], N.shape[-1]
    C, k = ids.shape
    record("reach_chunk_product", ops.reach_chunk_product, (N, ids),
           sum(2.0 * s * e ** 3 for s, e in zip(real, ells)),
           4.0 * (C * k + T * A1 * lp * lp + C * lp * lp), reach.grid(A1, lp, C, T), runner,
           {"source": "src/repro_torch/csrc/reach.cu", "replaces": "src/repro/kernels/reach.py:49"},
           case="fleet_strip")
    P = ops.reach_chunk_product(N, ids).reshape(grid.shape[:3] + (lp, lp))
    Jf, Jb = TorchBackend().join(P, I[:, None], F[:, None])
    Jf, Jb = Jf.reshape(C, lp).contiguous(), Jb.reshape(C, lp).contiguous()
    del P
    record("build_merge_packed", ops.build_merge_packed, (N, ids, Jf, Jb),
           sum(4.0 * s * e ** 2 for s, e in zip(real, ells)),
           4.0 * (C * k + T * A1 * lp * lp + 2 * C * lp + C * k * lp // 32),
           build.grid(A1, lp, C, T), runner,
           {"source": "src/repro_torch/csrc/build_merge.cu", "replaces": "src/repro/kernels/build.py:60"},
           case="fleet_rows")
    del Jf, Jb

    runner, tids, grid, N, I, F, ids, real, ells = bucket_inputs("traffic-packed")
    T, A1, lp = N.shape[0], N.shape[1], N.shape[-1]
    C, k = ids.shape
    W = lp // 32
    Np = pack_transition_table_torch(N)
    record("packed_reach_chunk_product", ops.packed_reach_chunk_product, (Np, ids),
           sum(2.0 * s * e ** 3 for s, e in zip(real, ells)),
           4.0 * (C * k + T * A1 * lp * W + C * lp * W), packed_reach.grid(A1, lp, lp, C, T),
           runner, {"source": "src/repro_torch/csrc/packed_reach.cu",
                    "replaces": "src/repro/kernels/packed_reach.py:74"})

    runner, tids, grid, N, I, F, ids, real, ells = bucket_inputs("traffic-sparse")
    sparse = runner.backend
    S = sparse._width
    R0 = sparse_init_rows(sparse.feasible_rows(N, torch.from_numpy(grid).to(N.device)),
                          lp).reshape(C, S, W).contiguous()
    Np = pack_transition_table_torch(N)
    Nh = N.cpu().numpy()
    w_ops = 0.0
    for t, (s, e) in enumerate(zip(real, ells)):
        w = feasible_start_widths(Nh[t], grid[t].reshape(-1, k))
        w_ops += 2.0 * s * float(w[w >= 0].mean() if (w >= 0).any() else 0.0) * e ** 2
    record("sparse_reach_rows", ops.sparse_reach_rows, (Np, ids, R0), w_ops,
           4.0 * (C * k + T * A1 * lp * W + 2 * C * S * W), packed_reach.grid(A1, lp, S, C, T),
           runner, {"source": "src/repro_torch/csrc/packed_reach.cu",
                    "replaces": "src/repro/kernels/sparse_reach.py:71"})
    return records


def fleet_phase(args, dev):
    """The multi-tenant fleet on the card (``ParserFleet``): 256 tenants in
    5 automaton buckets, every tenant's results held against a solo
    ``Parser`` on its backend bit for bit, one reach launch and one K2
    launch a bucket dispatch, the join's K3 launches independent of the
    tenant count, fleet and solo-loop throughput side by side; returns the
    tenant-axis kernel records."""
    import numpy as np
    import torch

    from repro_torch import Parser, ParserFleet
    from repro_torch.core.fleet import clear_table_cache
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    tenants = fleet_tenants(args.seed + 7)
    items = [(tid, text) for tid, (_, texts) in tenants.items() for text in texts]
    n_bytes = sum(len(text) for _, text in items)
    clear_table_cache()
    t0 = time.perf_counter()
    fleet = ParserFleet({tid: cfg for tid, (cfg, _) in tenants.items()}, device=dev,
                        max_batch=FLEET_MAX_BATCH)
    setup_s = time.perf_counter() - t0
    log = DispatchLog(fleet.engine)

    got, fleet_cold_s, counts = counted(lambda: fleet.parse_batch(items))
    for name in DispatchLog.KERNELS:
        if counts[name] < 1:
            raise AssertionError(f"fleet parse_batch never launched {name}: {counts}")
    log.check("parse_batch")
    dispatches = list(log.records)

    # the solo loop: one Parser a (pattern, backend), each text parsed alone
    solos = {}
    for tid, (cfg, _) in tenants.items():
        key = (cfg.regex, cfg.backend)
        if key not in solos:
            solos[key] = Parser(cfg, device=dev)
    solo_secs = []
    solo_by_bucket = {}
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want, by_bucket = [], {}
        for tid, text in items:
            t1 = time.perf_counter()
            want.append(solos[(tenants[tid][0].regex, tenants[tid][0].backend)].parse(text))
            key = "|".join(map(str, fleet.engine.tenant(tid).bucket_key))
            by_bucket[key] = by_bucket.get(key, 0.0) + time.perf_counter() - t1
        torch.cuda.synchronize()
        solo_secs.append(time.perf_counter() - t0)
        solo_by_bucket = by_bucket
    for (tid, _), a, b in zip(items, got, want):
        if a.ok != b.ok or not np.array_equal(a.forest.columns, b.forest.columns):
            raise AssertionError(f"fleet tenant {tid}: result != its solo Parser's")
    del want

    # the same requests through the FleetParseService, warm: submit all, then
    # drain step by step
    log.records.clear()
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tickets = [fleet.submit(tid, text) for tid, text in items]
    steps = 0
    while fleet._service.step():
        steps += 1
    drained = [t.result() for t in tickets]
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    drain_counts = ops.launch_counts()
    log.check("service drain")
    log_warm = list(log.records)
    for a, b in zip(drained, got):
        if not np.array_equal(a.forest.columns, b.forest.columns):
            raise AssertionError("the service drain's result != parse_batch's")
    del drained, tickets

    # K3 launches of the a/b bucket's dispatch with 1 tenant and with 192
    ab = [tid for tid in tenants if tid.startswith("ab")]
    k3 = {}
    for group in (ab[:1], ab):
        log.records.clear()
        fleet.parse_batch([(tid, text) for tid in group for text in tenants[tid][1]])
        (rec,) = log.records
        k3[len(group)] = rec["launches"]["semiring_matmul"]
    if k3[1] != k3[len(ab)] or k3[1] < 1:
        raise AssertionError(f"the join's K3 launches depend on the tenant count: {k3}")

    stats = fleet.stats()
    snap = {str(k): v for k, v in stats["metrics"].items()}
    cache = {name: snap[name][0]["value"] if name in snap else 0.0
             for name in ("table_cache_hits_total", "table_cache_misses_total")}
    fleet_s, solo_s = drain_s, solo_secs[1]
    emit("fleet", tenants=len(tenants), texts=len(items), bytes=n_bytes,
         buckets=stats["fleet"]["bucket_sizes"], n_buckets=stats["fleet"]["n_buckets"],
         compile_count=fleet.compile_count, setup_s=setup_s,
         fleet_sweep_s={"parse_batch_cold": fleet_cold_s, "service_drain_warm": drain_s},
         solo_sweep_s=solo_secs,
         fleet_texts_per_s=len(items) / fleet_s, solo_texts_per_s=len(items) / solo_s,
         fleet_mb_per_s=n_bytes / fleet_s / 1e6, solo_mb_per_s=n_bytes / solo_s / 1e6,
         speedup=solo_s / fleet_s, dispatches=dispatches, launches=counts,
         bucket_s={rec["bucket"]: {"fleet_dispatch": rec["seconds"],
                                   "solo": solo_by_bucket[rec["bucket"]]}
                   for rec in log_warm},
         results_equal_solo_parsers=True, service={"steps": steps, "drain_s": drain_s,
                                                   "mb_per_s": n_bytes / drain_s / 1e6,
                                                   "launches": drain_counts},
         k3_launches_by_tenants={str(t): n for t, n in k3.items()}, table_cache=cache)
    # the warm run's launches by kernel and plan: the group kernels and
    # walks ("fleet") apart from the fallbacks
    case = {"group": "fleet", "walk": "fleet", "strip": "fleet_strip", "rows": "fleet_rows",
            "fold": "fleet_fold"}
    by_case = {}
    for rec in log_warm:
        n, g = rec["launches"], rec["grids"]
        reach_name = next(k for k in DispatchLog.KERNELS[:3] if n[k])
        for name, kind in ((reach_name, g["reach_kernel"]),
                           ("build_merge_packed", g["build_merge_kernel"])):
            by_case[(name, case[kind])] = by_case.get((name, case[kind]), 0) + n[name]
    records = fleet_kernel_records(fleet, tenants, by_case)
    emit("fleet_phase_total", seconds=time.perf_counter() - t_phase)
    del fleet, solos, got
    torch.cuda.empty_cache()
    return records


def analysis_phase(dev, parse_mb_per_s) -> None:
    """The static analyzer on TRAFFIC and e125: the report, the ``auto``
    choice on the card and whether the cost model's ranking agrees with the
    measured ``Parser.parse`` MB/s of the three kernel paths (``main_path``
    lines); an ``auto`` parser resolves to that path; then the phase-program
    lint over the kernel paths' phases at the main path's buckets, every
    finding printed."""
    from repro_torch import Parser, ParserConfig
    from repro_torch.analyze import analyze_pattern, lint_engine, resolve_backend

    for label, regex in (("TRAFFIC", TRAFFIC_RE), ("e125", E125_RE)):
        report = analyze_pattern(regex)
        choice = resolve_backend(report.recommended_backend, dev.type)
        auto = Parser(ParserConfig(regex=regex, backend="auto", n_chunks=N_CHUNKS), device=dev)
        ran = (auto.backend_name, getattr(auto.engine.backend, "kernel", False))
        if ran != choice:
            raise AssertionError(f"{label}: auto ran {ran}, resolved {choice}")
        cost = report.cost
        candidates = ["sparse", "packed", "torch"] if report.width_bucket < report.ell_pad \
            else ["packed", "torch"]
        model = [("cuda" if b == "torch" else b) for b in
                 sorted(candidates, key=lambda b: cost[b]["t_total"])]
        card = sorted(model, key=lambda b: -parse_mb_per_s[(label, b)])
        findings = {}
        for backend in ("cuda", "packed", "sparse"):
            p = Parser(ParserConfig(regex=regex, backend=backend, kernel=backend != "cuda",
                                    n_chunks=N_CHUNKS, analyze="off"), device=dev)
            k = p.engine.bucket_shape(E125_BYTES if label == "e125" else TRAFFIC_BYTES,
                                      N_CHUNKS)[1]
            findings[backend] = [str(f) for f in lint_engine(p.engine, ((N_CHUNKS, k),),
                                                             label=f"{label}:{backend}")]
            del p
        report_d = report.to_dict()
        report_d["pattern"] = label
        emit("analysis", cell=label, report=report_d, auto_choice=list(choice),
             model_ranking=model, card_ranking=card, ranking_agrees=model[0] == card[0],
             parse_mb_per_s={b: parse_mb_per_s[(label, b)] for b in model},
             lint_findings=findings, lint_clean=not any(findings.values()))


# ------------------------------------------------------------------ the mesh

MESH_TIMEOUT_S = 420
MESH_STREAM_BYTES = 1 << 20
MESH_STREAM_PIECES = 16
REACH_KERNEL = {"cuda": "reach_chunk_product", "packed": "packed_reach_chunk_product",
                "sparse": "sparse_reach_rows"}


def mesh_phase(args) -> None:
    """The mesh route across ranks, one process a rank (``torch.multiprocessing``,
    spawn): one rank a card over NCCL where there are two cards or more (up
    to 4), else two ranks sharing the one card in a gloo group (NCCL refuses
    two ranks on one device).  The kernels are already built (``main``): a
    rank only loads them.  A rank that fails fails the phase at once (the
    others are killed); a rank still running after MESH_TIMEOUT_S is killed
    and fails it too."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    cards = torch.cuda.device_count()
    world, group_backend = (min(4, cards), "nccl") if cards >= 2 else (2, "gloo")
    ctx = mp.get_context("spawn")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        procs = [ctx.Process(target=mesh_rank, args=(r, world, group_backend, tmp, args.seed))
                 for r in range(world)]
        for proc in procs:
            proc.start()
        deadline = time.monotonic() + MESH_TIMEOUT_S
        while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.5)
        killed = [r for r, p in enumerate(procs) if p.is_alive()]
        for proc in procs:
            if proc.is_alive():
                proc.kill()
            proc.join()
        reports, failures = [], []
        for r, proc in enumerate(procs):
            path = Path(tmp) / f"rank{r}.json"
            rep = json.loads(path.read_text()) if path.exists() else {}
            reports.append(rep)
            if r in killed:
                failures.append(f"rank {r} killed after {time.perf_counter() - t0:.0f} s "
                                f"(timeout {MESH_TIMEOUT_S} s, or another rank failed)")
            elif proc.exitcode != 0 or not rep.get("ok"):
                failures.append(f"rank {r} exit code {proc.exitcode}: "
                                f"{rep.get('error', 'no report')}")
    if failures:
        raise AssertionError("mesh: " + "\n".join(failures))
    emit("mesh", world=world, group_backend=group_backend, mesh_shape=reports[0]["mesh_shape"],
         transport=reports[0]["transport"], seconds=time.perf_counter() - t0,
         columns_equal_single_process=True, ranks=reports)


def mesh_rank(rank: int, world: int, group_backend: str, tmp: str, seed: int) -> None:
    """One rank of ``mesh_phase``: joins the group, runs ``mesh_runs`` and
    writes its report (or its traceback) to ``tmp``; exits 1 on a failure."""
    import os
    import traceback

    report = {"rank": rank, "ok": False}
    dist = None
    try:
        sys.path.insert(0, str(ROOT / "src"))
        import torch
        import torch.distributed as dist

        from repro_torch.kernels import ops

        missing = [s for s in ops._signatures() if not ops._target(s).exists()]
        if missing:
            raise RuntimeError(f"kernels not built before the ranks started: {missing}")
        ops.build()                       # loads the built libraries, compiles nothing
        dev = torch.device("cuda", rank if group_backend == "nccl" else 0)
        torch.cuda.set_device(dev)
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group(group_backend, init_method=f"file://{tmp}/store",
                                rank=rank, world_size=world)
        report.update(mesh_runs(dev, seed))
        report["ok"] = True
    except Exception:
        report["error"] = traceback.format_exc()[-6000:]
    finally:
        if dist is not None and dist.is_initialized():
            dist.destroy_process_group()
        (Path(tmp) / f"rank{rank}.json").write_text(json.dumps(report))
    if not report["ok"]:
        sys.exit(1)


def mesh_runs(dev, seed: int) -> dict:
    """On ``cuda`` and on ``packed`` / ``sparse`` with ``kernel=True``:
    ``Parser.parse`` of the 8 MiB TRAFFIC log and of 1 MiB of e125,
    ``parse_batch`` of the 8 mixed texts, and a ``StreamingParser`` on the
    mesh engine (1 MiB of TRAFFIC in 16 appends, then ``current_slpf``),
    each after the same text's single-process parse on the same card.  Each
    mesh run is counted on its own; its packed columns must equal the
    single-process run's, its reach kernel and K2 (and K3 on ``cuda``) must
    launch, and the product-stack payload must be the gathered chunks times
    one product's bytes."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch import Parser, ParserConfig
    from repro_torch.core.backend import next_pow2
    from repro_torch.core.stream import StreamingParser

    traffic = traffic_log(TRAFFIC_BYTES, seed)
    e125 = e125_text(E125_BYTES, seed + 1)
    batch = mixed_batch(traffic)
    stream_text = traffic_log(MESH_STREAM_BYTES, seed + 2)
    piece = MESH_STREAM_BYTES // MESH_STREAM_PIECES
    runs = {}
    mesh = None
    for backend, kernel in (("cuda", False), ("packed", True), ("sparse", True)):
        need = [REACH_KERNEL[backend], "build_merge_packed"] + (
            ["semiring_matmul"] if backend == "cuda" else [])
        cfgs = {regex: ParserConfig(regex=regex, backend=backend, kernel=kernel,
                                    n_chunks=N_CHUNKS) for regex in (TRAFFIC_RE, E125_RE)}
        single = {regex: Parser(cfg, device=dev) for regex, cfg in cfgs.items()}
        meshed = {regex: Parser(cfg.replace(mesh="host"), device=dev) for regex, cfg in cfgs.items()}
        out = {}
        for label, regex, text in (("traffic", TRAFFIC_RE, traffic), ("e125", E125_RE, e125),
                                   ("batch", TRAFFIC_RE, batch),
                                   ("stream", TRAFFIC_RE, stream_text)):
            p1, pm = single[regex], meshed[regex]
            d = pm.engine.dist
            mesh, transport = pm.engine.mesh, d.transport
            eye = pm.engine.backend.identity_product(pm.engine.tables.ell_pad)
            product_bytes = eye.numel() * eye.element_size()
            stacks = []        # products a join of the stream gathers (one an append)

            def run_stream(engine):
                sp = StreamingParser(engine, max_seal_len=STREAM_SEAL)
                for i in range(MESH_STREAM_PIECES):
                    sp.append(text[i * piece:(i + 1) * piece])
                    tail = 1 if sp.n > sum(len(c) for c in sp._sealed_classes) else 0
                    stacks.append(next_pow2(sp.n_sealed_chunks + tail + 1))
                return [sp.current_slpf()]

            for p in (p1, pm):     # first calls: kernel modules, allocator, process groups
                p.parse(batch[2])
                p.parse_batch(batch[:2])
            if label == "batch":
                want, s1, _ = counted(lambda: [r.forest for r in p1.parse_batch(text)])
                mesh_fn = lambda: [r.forest for r in pm.parse_batch(text)]  # noqa: E731
            elif label == "stream":
                want, s1, _ = counted(lambda: run_stream(p1.engine))
                want.append(p1.parse(text).forest)
                stacks.clear()
                mesh_fn = lambda: 2 * run_stream(pm.engine)  # noqa: E731
            else:
                want, s1, _ = counted(lambda: [p1.parse(text).forest])
                mesh_fn = lambda: [pm.parse(text).forest]  # noqa: E731
            payload = pm.obs.metrics.counter("allgather_payload_bytes_total")
            before, gathers = payload.value, d.gathers
            dist.barrier()
            got, sm, n = counted(mesh_fn)
            for g, w in zip(got, want):
                if not np.array_equal(g.pack(), w.pack()):
                    raise AssertionError(f"{backend} {label}: mesh columns != single-process")
            if min(n[k] for k in need) <= 0:
                raise AssertionError(f"{backend} {label}: a kernel never launched: {n}")
            if label == "batch":
                eng = pm.engine
                c_req = -(-N_CHUNKS // d.batch_chunk_devices) * d.batch_chunk_devices
                groups: dict = {}
                for t in text:
                    key = eng.bucket_shape(len(eng.classes_of_text(t)), c_req)
                    groups[key] = groups.get(key, 0) + 1
                dsz = d.batch_devices
                chunks = sum(-(-next_pow2(m) // dsz) * dsz * c for (c, _), m in groups.items())
            elif label == "stream":
                csz = d.chunk_devices
                chunks = sum(-(-c // csz) * csz for c in stacks)
            else:
                chunks = -(-N_CHUNKS // d.chunk_devices) * d.chunk_devices
            moved = payload.value - before
            if moved != chunks * product_bytes:
                raise AssertionError(f"{backend} {label}: payload {moved} != {chunks} chunks "
                                     f"x {product_bytes} bytes")
            n_bytes = sum(map(len, text)) if label == "batch" else len(text)
            out[label] = {"bytes": n_bytes, "single_s": s1, "mesh_s": sm,
                          "single_mb_per_s": n_bytes / s1 / 1e6,
                          "mesh_mb_per_s": n_bytes / sm / 1e6,
                          "launches": {k: v for k, v in n.items() if v},
                          "payload_bytes": moved, "gathered_chunks": chunks,
                          "product_bytes": product_bytes, "gathers": d.gathers - gathers}
            del got, want
        runs[backend + ("+kernel" if kernel else "")] = out
        del single, meshed
    return {"mesh_shape": mesh.shape, "transport": transport, "group": mesh.backend,
            "runs": runs}


if __name__ == "__main__":
    sys.exit(main())
