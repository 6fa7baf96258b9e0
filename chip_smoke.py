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
             text of 64 KiB each: 16 MiB; e125's ℓp-512 bucket walks its
             window ℓ' = 288 in K1 and K2).  ``parse_batch`` (cold, counted)
             and a ``FleetParseService`` drain of the same requests through
             ``submit`` (warm); every tenant's result equals a solo
             ``Parser`` on its backend; each bucket dispatch makes one reach
             launch (K1, K4 or K5) and one K2 launch, and the a/b dispatch's
             K3 launches are the same for 1 tenant as for 192.  Prints sweep
             seconds, texts/s and MB/s of the fleet and of the per-tenant
             solo loop (and per bucket), the table cache's hits and misses,
             buckets, ``compile_count``, and each dispatch's grids; then K1,
             K2, K4 and K5 over the tenant stacks against their plain
             versions (``kernel`` lines: ``case`` "fleet", "fleet_window" for
             e125's bucket at its window, and K1's strip and K2's row kernels
             on e125's stack with its block structure broken, "fleet_strip",
             "fleet_rows")
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
                  kernel SDPA ran; K6 again with a logit softcap (``SOFTCAP``,
                  case "softcap": the same limits, and the cap must move the
                  output)
  lm_prefill      ``prefill`` of 2 x 2048 tokens in bf16, counted: seconds,
                  tokens/s, peak memory, K6 and K7 launches (9 and 108 for
                  the two-pass SSD: 54 ``"state"``, 54 ``"y"``), finite logits
  lm_profile      one more prefill under ``torch.profiler``: device time by
                  kernel family (K6, K7, cuBLAS GEMMs, the rest) and the
                  largest kernels
  lm_consistency  the same model in f32, its depth cut to the first
                  CONSISTENCY_DEPTH = 12 of 54 layers (2 shared blocks; the
                  512 host-bound decode steps at 54 layers took 95 s on the
                  H100), on a
                  1 x 512 prompt: ``prefill``
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
prefill); then training, MoE and the frontends:

  train_grad_gate  zamba2-2.7b at full width, one 1 x 2048 microbatch:
                  ``forward_train``'s loss and gradients (the embedding, the
                  shared block's wq, the first SSM layer's in_proj, the global
                  norm; every leaf nonzero) through K6 / K7 (counted: 9 and
                  216 launches) against the plain versions on the same card,
                  beside the plain versions' own sensitivity to a 1e-3 nudge
                  of the embeddings: at the reference's initialization
                  (reported: the gradient is chaotic there), and gated at
                  unit-scale attention logits in bf16 (``GRAD_GATE``,
                  ``LOSS_GATE``) and in f32 compute over the bf16 params
  train           3 ``Trainer.run`` steps at full width (bf16 params, fp32
                  masters, 2 x 2048 tokens a step: accum 2 x microbatch 1, no
                  checkpoint), counted: step seconds, tokens/s, losses, peak
                  memory, K6 / K7 launches a step (18, 432)
  train_profile   one more step under ``torch.profiler``: device ms by kernel
                  family and within the AdamW update and the recomputed
                  backward of K6 / K7
  train_grad_gate_f32  the same gate on zamba2's smoke config in f32, every
                  leaf within 1e-3
  train_resume    tinyllama smoke, 6 steps, crash at step 4, resume from the
                  step-3 checkpoint: final loss within 1e-4 of the
                  uninterrupted run's
  train_moe       3 ``Trainer`` steps of the mixtral smoke config: finite
                  losses, K6 launches counted
  moe_frontend    mixtral-8x22b at full width cut to depth 2 of 56: prefill of
                  1 x 5120 tokens (past its 4096-token window) and 16 decode
                  steps; internvl2-1b at full width: prefill of 768 tokens
                  after (1, 256, 1024) seeded frontend features; counted,
                  finite logits
  train_mesh      the ``Trainer`` on a (2, 2) ('data', 'model') mesh of 4 gloo
                  ranks sharing the card (spawned; DTensor params, state and
                  activations, their collectives staged through the host),
                  zamba2-2.7b at full width cut to its first 6 layers (one
                  shared block), bf16 params, 2 steps of 4 x 512 tokens (accum
                  2 x microbatch 2), in bf16 and in f32 compute, each against
                  the one-rank ``Trainer`` on the same card with the same seed
                  and batches (run first, accum 4 x microbatch 1): every step's
                  loss within ``TRAIN_MESH_GATE`` (2e-2 bf16, 1e-4 f32); per
                  rank step seconds, tokens/s, peak memory, K6 / K7 launches
                  (checked: one microbatch's count times the microbatches, the
                  same on every rank) and the staged collectives' calls and
                  bytes a step; a rank that fails or hangs fails it
  dryrun          the launch tools (``repro_torch/launch/``):
                  ``ParserEngine.phase_static_cost`` at TRAFFIC's and e125's
                  buckets on ``cuda`` and on ``packed`` / ``sparse`` with
                  ``kernel=True``, whose modeled launches by kernel must equal
                  the launches of the same engine's real parse of the text
                  (counted) and each kernel's modeled bound the sum of its
                  launcher's ``cost`` over those real launches;
                  ``stats()["hlo"]`` of a traced parser; the ``train`` phase's
                  zamba2-2.7b step traced on meta tensors against one real step
                  (modeled K6 / K7 launches equal to the real counts, traced
                  dot flops within DRYRUN_FLOP_TOL of ``FlopCounterMode``'s,
                  ``peak_bytes`` beside ``max_memory_allocated``); one
                  production cell (DRYRUN_CELL: zamba2-2.7b x prefill_32k on
                  the fake (16, 16) mesh) and its modeled record

then the tooling, in this process:

  examples        the nine ``examples/torch_*.py`` through ``main(argv)`` with
                  ``--device cuda`` at their default sizes, each run counted
                  (launch counts set to 0 just before, read just after) and
                  required to return 0, one ``example`` line a run with its
                  seconds, launches by kernel and key results: quickstart,
                  traced_parse and regrep ``--demo`` on ``cuda``, batch_parse,
                  stream_parse and edit_stream on ``cuda`` and on ``packed`` /
                  ``sparse`` with ``--kernel`` (K1 and K2 must launch on
                  ``cuda``; K4 or K5, and K2, with ``--kernel``), each one's
                  lines equal to its ``--device cpu`` lines (backend names,
                  timings, trace ids, program counts and the p99 verdict
                  aside); regrep over
                  the 8 MiB TRAFFIC log in a temporary file with three ``-e``
                  patterns (TRAFFIC, e125 and REGREP_MISS, which cannot match)
                  at 1024 chunks, its TRAFFIC group matches against a solo
                  ``cuda`` parse, MB/s; sharded_parse on 2 ranks (gloo sharing
                  the card; NCCL on two cards or more), K1 and K2 on every
                  rank; constrained_serve (every output in L(e); the prompt
                  goes through ``decode_step``, plain code: no launch);
                  train_lm ``--preset 100m`` at 30 steps (K6 must launch),
                  logged step seconds and losses
  gates           ``scripts/torch_obs_smoke.py`` and
                  ``scripts/torch_analyze_gate.py`` through ``main(["--device",
                  "cuda"])``, counted: each must return 0; prints the checks
                  each passed

then the kernel table (K6 and K7 records also carry their launches in the
``train`` run, ``train_launches``, and on each rank of the ``train_mesh``
run, ``train_mesh_launches_per_rank``) (one record a launch kind: K7's ``"state"`` and
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
import contextlib
import dataclasses
import json
import math
import re
import statistics
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

LM_ARCH = "zamba2-2.7b"
LM_BATCH, LM_LEN = 2, 2048          # a multiple of the SSD chunk (256)
CONSISTENCY_LEN = 512               # two SSD chunks: the join carries a state
CONSISTENCY_DEPTH = 12              # layers of 54: two shared blocks
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
# K6's logit softcap in its check: with unit-normal q and k the scaled scores
# have scale ~1, so a cap of 1 bends most of them
SOFTCAP = 1.0


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_query(fields: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def nvidia_smi_cards() -> list:
    """Every card's ``nvidia-smi`` index, name and power limit."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=index,name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()


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


def bound_ms(cost):
    """A launch's bound in ms and what sets it ("operations" or "bytes"),
    from its launcher's ``cost`` (``repro_torch.kernels.cost.Cost``): the
    one formula the dry-run's modeled launches use too."""
    return cost.seconds * 1e3, cost.bound_by


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

    Each bound is its launcher's ``cost`` (``bound_ms``) at what this text
    needs: its real (non-PAD) steps and its ℓ states (the padded states are
    unreachable and PAD steps are identities); K5 folds only the feasible
    rows, w̄ of them per chunk on average (the text's mean observed feasible
    width, which the sparse run's ``speculation["width_mean"]`` reports).
    Bytes count the tensors as given, each read or written once."""
    import torch

    from repro_torch.core.backend import SparseBackend, TorchBackend
    from repro_torch.core.matrices import (
        feasible_start_widths,
        pack_transition_table_torch,
        sparse_init_rows,
    )
    from repro_torch.kernels import build, ops, packed_reach, reach, semiring, sparse_reach

    eng = parser.engine
    t = eng.tables
    classes = eng.classes_of_text(text)
    c, k = eng.bucket_shape(len(classes), parser.config.n_chunks)
    grid = eng._pad_to(classes, c, k)
    ids = eng.chunks_tensor(grid)
    lp, ell, steps = t.ell_pad, t.ell, len(classes)
    A1 = t.N.shape[0]
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

    real = {"steps": steps, "ell": ell}
    cases = [
        ("reach_chunk_product", "src/repro_torch/csrc/reach.cu",
         "src/repro/kernels/reach.py:49", ops.reach_chunk_product, (t.N, ids), None,
         reach.cost(t.N, ids, **real)),
        ("build_merge_packed", "src/repro_torch/csrc/build_merge.cu",
         "src/repro/kernels/build.py:60", ops.build_merge_packed, (t.N, ids, Jf, Jb), None,
         build.cost(t.N, ids, Jf, Jb, **real)),
        ("semiring_matmul", "src/repro_torch/csrc/semiring.cu",
         "src/repro/kernels/semiring.py:40", ops.semiring_matmul, (a, b),
         lambda: torch.clamp(torch.bmm(a, b), max=1.0), semiring.cost(a, b, ell=ell)),
        ("packed_reach_chunk_product", "src/repro_torch/csrc/packed_reach.cu",
         "src/repro/kernels/packed_reach.py:74", ops.packed_reach_chunk_product, (Np, ids), None,
         packed_reach.cost(Np, ids, **real)),
        ("sparse_reach_rows", "src/repro_torch/csrc/packed_reach.cu",
         "src/repro/kernels/sparse_reach.py:71", ops.sparse_reach_rows, (Np, ids, R0), None,
         sparse_reach.cost(Np, ids, R0, rows=w_mean, **real)),
    ]
    # K3 at the join's mat-vec shapes too: the forward act (n = 1) and the
    # backward act (m = 1), on the join's own entries; reported, not listed
    v = Jf[:-1].contiguous()
    mv, vm = (a, v.unsqueeze(-1)), (v.unsqueeze(-2), b)
    cases += [
        ("semiring_matmul", "src/repro_torch/csrc/semiring.cu", "src/repro/kernels/semiring.py:40",
         ops.semiring_matmul, args, lambda args=args: torch.clamp(torch.bmm(*args), max=1.0),
         semiring.cost(*args, ell=ell), case)
        for case, args in (("matvec", mv), ("vecmat", vm))
    ]
    records = []
    for name, source, replaces, kern, args, library, cost, *case in cases:
        got = kern(*args)
        torch.cuda.synchronize()
        want = kern.plain(*args)
        equal = torch.equal(got, want)
        err = (got.double() - want.double()).abs().max().item() if got.numel() else 0.0
        if not equal:
            raise AssertionError(f"{name} {case}: kernel != plain version, max |err| {err}")
        del got, want
        b_ms, b_by = bound_ms(cost)
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

    from repro_torch.kernels import flash_attention, ops
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
        b_ms, b_by = bound_ms(flash_attention.cost(*qkv, causal=True, window=None))
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
        emit("kernel", **softcap_record(qkv, tag, tol, rel_tol))
        del qkv, qt, kt, vt
        torch.cuda.empty_cache()

        xdt = randn(P, q, hp, scale=0.3).to(dtype)
        cs = torch.cumsum(-(torch.rand((P, q, 1), generator=gen, device=dev) * 0.39 + 0.01), dim=1)
        B, C = randn(P, q, n, scale=0.3).to(dtype), randn(P, q, n, scale=0.3).to(dtype)
        S_prev = randn(P, hp, n, scale=0.3)
        args = (xdt, cs, B, C, S_prev)
        emit("kernel", **recs[0])
        recs += ssd_records(args, tag)
        del args, xdt, cs, B, C, S_prev
        torch.cuda.empty_cache()
        out[tag] = recs
    return out


def softcap_record(qkv, tag, tol, rel_tol) -> dict:
    """K6 with a logit softcap (SOFTCAP, where the scores' scale is ~1, so
    that it bites) against its plain version, at the prefill's shapes; no
    path of zamba2 launches it and no PyTorch call computes it."""
    import torch

    from repro_torch.kernels import flash_attention, ops

    kw = dict(causal=True, window=None, softcap=SOFTCAP)
    got = ops.flash_attention(*qkv, **kw)
    torch.cuda.synchronize()
    want = ops.flash_attention.plain(*qkv, **kw)
    uncapped = ops.flash_attention.plain(*qkv, causal=True, window=None)
    err = (got.float() - want.float()).abs().max().item()
    rel = row_rel_err(got, want)
    moved = (want.float() - uncapped.float()).abs().max().item()
    if not (err <= tol and rel <= rel_tol and torch.isfinite(got).all() and moved > tol):
        raise AssertionError(f"flash_attention softcap {tag}: max |err| {err} (limit {tol}), "
                             f"row-relative {rel} (limit {rel_tol}), cap moves {moved}")
    b, L, h, hd = qkv[0].shape
    b_ms, b_by = bound_ms(flash_attention.cost(*qkv, **kw))
    return {"name": "flash_attention", "case": "softcap", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:96",
            "launches": None, "max_abs_err": err, "max_row_rel_err": rel,
            "softcap_moves_output_by": moved,
            **timing_fields(lambda: ops.flash_attention(*qkv, **kw),
                            lambda: ops.flash_attention.plain(*qkv, **kw), None),
            "bound_ms": b_ms, "bound_by": b_by,
            "shapes": {"dtype": tag, "b": b, "L": L, "h": h, "hd": hd, "softcap": SOFTCAP,
                       "tolerance_atol": tol, "tolerance_row_rel": rel_tol}}


def ssd_records(args, tag):
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
        b_ms, b_by = bound_ms(ssd_launcher.cost(*args, outputs=outputs))
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
                                attn_p_dtype="float32", n_layers=CONSISTENCY_DEPTH,
                                layout=cfg.layout[:CONSISTENCY_DEPTH])
    counts32 = lm_consistency_phase(cfg32, params32, dev, seed)
    for rec in kernel_records["float32"]:
        rec["launches"] = counts32.get(count_key(rec), 0)
    emit("kernels_f32", prompt=CONSISTENCY_LEN, kernels=kernel_records["float32"])
    del params32
    torch.cuda.empty_cache()
    return bf16


# ------------------------------------------------------------ training path

TRAIN_LEN, TRAIN_BATCH, TRAIN_STEPS = 2048, 2, 3      # one rank: accum 2 x microbatch 1
# kernels against plain versions, by compute dtype: forward_train's loss
# (relative) and the gradients' relative L2 error.  In bf16 a leaf whose
# plain-version gradient itself moves by more under a bf16-sized nudge of the
# embeddings (``sensitivity``) is held to that instead: at 54 layers the bf16
# gradient is only defined to that noise (PERF.md, training findings)
GRAD_GATE = {"bfloat16": 5e-2, "float32": 1e-3}
LOSS_GATE = {"bfloat16": 1e-2, "float32": 1e-3}
RESUME_BOUND = 1e-4                  # the reference's (tests/test_train_e2e.py)
MIXTRAL_DEPTH, MIXTRAL_PROMPT, MIXTRAL_DECODE = 2, 5120, 16
INTERNVL_TEXT = 768                  # text tokens after its 256 frontend features


def expected_train_launches(cfg) -> dict:
    """K6 and K7 launches of one microbatch's forward and backward: every
    stacked layer's forward runs again in the backward under remat (kernels
    included), the zamba2 shared block's does not (the reference does not
    wrap it); the backward itself recomputes the plain versions."""
    again = 2 if cfg.remat else 1
    kinds = cfg.layer_kinds
    n_attn = sum(1 for k in kinds if k in ("attn", "moe"))
    n_shared = len(kinds) // cfg.shared_attn_every if cfg.shared_attn_every else 0
    n_ssm = kinds.count("ssm")
    return {"flash_attention": n_attn * again + n_shared, "ssd_chunk": 2 * n_ssm * again,
            "ssd_chunk/state": n_ssm * again, "ssd_chunk/y": n_ssm * again}


def check_launches(label, counts, want) -> None:
    got = {k: counts.get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")


def _paths(tree, prefix=""):
    """(path, leaf) pairs of a param tree in its flatten order (keys sorted)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _paths(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


class plain_kernels:
    """Within the block the model's K6 and K7 calls go to their plain
    versions (``ops.flash_attention.plain``, ``ops.ssd_chunk.plain``): the
    yardstick of the gradient gates, never a path of the port."""

    def __enter__(self):
        from repro_torch.kernels import ops

        self._saved = ops.flash_attention, ops.ssd_chunk
        ops.flash_attention, ops.ssd_chunk = (w.plain for w in self._saved)

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        ops.flash_attention, ops.ssd_chunk = self._saved


def forward_backward(cfg, params, micro, keep):
    """forward_train's loss and gradients of one microbatch; returns (loss,
    {path: gradient} for the paths in ``keep`` (a leaf path, or a path and a
    layer index), f32 global norm, paths whose gradient is zero or absent)."""
    import torch

    from repro_torch.models.model import forward_train

    from repro_torch.optim.adamw import tree_map

    tree = tree_map(lambda p: p.detach().requires_grad_(True), params)
    named = list(_paths(tree))
    live = [p for _, p in named]
    total, metrics = forward_train(tree, micro, cfg)
    grads = torch.autograd.grad(total, live, allow_unused=True)
    kept, sq, dead = {}, torch.zeros((), device=live[0].device), []
    for (path, _), g in zip(named, grads):
        if g is None or not bool(g.ne(0).any()):
            dead.append(path)
            continue
        sq = sq + g.float().square().sum()
        for want in keep:
            name, index = want if isinstance(want, tuple) else (want, None)
            if name == path:
                kept[want if index is None else f"{name}[{index}]"] = (
                    g if index is None else g[index]).float().clone()
    del grads, live, tree, total
    return float(metrics["loss"].detach()), kept, float(sq.sqrt()), dead


def grad_gate(label, cfg, params, micro, keep, init="as initialized", gated=True):
    """Loss and gradients through the kernels (counted) and through the plain
    versions on the same card and inputs, and the plain versions' own
    ``sensitivity``: their gradients' change when the embeddings move by a
    relative 1e-3 (about bf16's rounding), which bounds how far any two
    evaluation orders of an ill-conditioned function may drift apart.  A
    gated run fails past LOSS_GATE and GRAD_GATE of ``cfg.dtype`` (in bf16,
    a leaf's sensitivity where that is larger); every run fails on a zero or
    absent gradient."""
    import torch

    (k_loss, k_grads, k_norm, k_dead), secs, counts = counted(
        lambda: forward_backward(cfg, params, micro, keep))
    check_launches(f"{label} forward+backward", counts, expected_train_launches(cfg))
    torch.cuda.empty_cache()
    gen = torch.Generator(device=params["embed"].device)
    gen.manual_seed(1)
    noise = 1.0 + 1e-3 * torch.randn(params["embed"].shape, generator=gen,
                                     device=params["embed"].device)
    nudged = dict(params, embed=(params["embed"].float() * noise).to(params["embed"].dtype))
    del noise
    with plain_kernels():
        p_loss, p_grads, p_norm, p_dead = forward_backward(cfg, params, micro, keep)
        n_loss, n_grads, n_norm, _ = forward_backward(cfg, nudged, micro, keep)
    del nudged

    def compare(a_loss, a_grads, a_norm):
        rel = {k: ((a_grads[k] - p_grads[k]).norm() / p_grads[k].norm().clamp_min(1e-30)).item()
               for k in p_grads}
        rel["global_norm"] = abs(a_norm - p_norm) / max(p_norm, 1e-30)
        return abs(a_loss - p_loss) / max(abs(p_loss), 1e-30), rel

    loss_rel, rel = compare(k_loss, k_grads, k_norm)
    sens_loss, sens = compare(n_loss, n_grads, n_norm)
    dtype_name = cfg.dtype
    loss_bound = LOSS_GATE[dtype_name]
    bound = {k: max(GRAD_GATE[dtype_name], sens[k]) if dtype_name == "bfloat16"
             else GRAD_GATE[dtype_name] for k in rel}
    fields = dict(model=cfg.name, dtype=dtype_name, param_dtype=cfg.param_dtype, init=init,
                  gated=gated,
                  loss_kernels=k_loss, loss_plain=p_loss,
                  loss_rel=loss_rel, loss_bound=loss_bound, grad_rel_l2=rel, grad_bound=bound,
                  global_norm_kernels=k_norm, global_norm_plain=p_norm,
                  sensitivity={"loss_rel": sens_loss, "grad_rel_l2": sens},
                  zero_or_absent=k_dead + p_dead, seconds_kernels=secs,
                  launches={k: counts.get(k, 0) for k in expected_train_launches(cfg)})
    emit(label, **fields)
    if k_dead or p_dead or set(k_grads) != set(keep_names(keep)):
        raise AssertionError(f"{label}: zero or absent gradients {k_dead + p_dead}")
    if gated and not (loss_rel <= loss_bound and all(v <= bound[k] for k, v in rel.items())):
        raise AssertionError(f"{label}: kernels against plain {fields}")
    return counts


def keep_names(keep):
    return [k if isinstance(k, str) else f"{k[0]}[{k[1]}]" for k in keep]


def train_profile(trainer, step_s: float, label="train_profile") -> dict:
    """Device time of one train step by kernel family, and within the
    optimizer update and the recomputed backward of K6 and of K7 (the
    kernels launched inside each ``record_function`` range).  The idle share
    is the card's: 1 − device time / ``step_s``, an unprofiled step's seconds
    (the profiler's own host work slows the profiled step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.kernels import ops
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_mod

    params, opt_state = trainer.init_state()
    batch = trainer.device_batch(0)
    apply, recompute = step_mod.apply_updates, ops._recompute_grads

    def apply_ranged(*a, **k):
        with record_function("train.adamw"):
            return apply(*a, **k)

    def recompute_ranged(ctx, plain, *a, **k):
        with record_function(f"train.recompute_backward/{plain.__name__}"):
            return recompute(ctx, plain, *a, **k)

    step_mod.apply_updates, ops._recompute_grads = apply_ranged, recompute_ranged
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer._step(params, opt_state, batch)
            torch.cuda.synchronize()
            prof_s = time.perf_counter() - t0
    finally:
        step_mod.apply_updates, ops._recompute_grads = apply, recompute
    del params, opt_state, batch
    families = {"flash_attention": 0.0, "ssd_chunk": 0.0, "gemm": 0.0, "collective": 0.0,
                "other": 0.0}
    ranges = {"train.adamw": 0.0, "train.recompute_backward/flash_attention_ref": 0.0,
              "train.recompute_backward/ssd_chunk_ref": 0.0}
    top = []
    # a range's device time: the kernels launched by the CPU ops that run
    # inside its CPU-side event, on its thread (the profiler's GPU-side
    # annotation of the same name spans the gaps between them too)
    events = [ev for ev in prof.events() if ev.device_type.name == "CPU"]
    spans = [(ev.name, ev.thread, ev.time_range.start, ev.time_range.end)
             for ev in events if ev.name in ranges]
    for ev in events:
        us = sum(k.duration for k in ev.kernels)
        if not us or ev.name in ranges:
            continue
        for name, thread, start, end in spans:
            if ev.thread == thread and start <= ev.time_range.start and ev.time_range.end <= end:
                ranges[name] += us / 1e3
                break
    for ev in prof.key_averages():
        us = _device_us(ev)
        # "nccl:…" are the profiler's annotations of collectives: their time
        # is their kernels' again
        if not us or ev.key in ranges or ev.device_type.name != "CUDA" or ev.key.startswith(
                "nccl:"):
            continue
        name = ev.key.lower()
        fam = ("flash_attention" if "flash_" in name and "kernel" in name
               else "ssd_chunk" if "ssd_" in name and "kernel" in name
               else "collective" if "nccl" in name
               else "gemm" if any(w in name for w in ("gemm", "nvjet", "xmma", "cutlass", "sm90"))
               else "other")
        families[fam] += us / 1e3
        top.append((us / 1e3, ev.key[:80], ev.count))
    top.sort(reverse=True)
    total = sum(families.values())
    compute = total - families["collective"]
    # a collective's kernel occupies the card while it waits for its peers,
    # so the compute kernels' share is read beside the idle share
    out = {"step_s": step_s, "step_s_profiled": prof_s, "device_ms_by_family": families,
           "device_ms_in_range": ranges, "device_ms_total": total,
           "idle_share": max(0.0, 1.0 - total / (step_s * 1e3)),
           "compute_share": compute / (step_s * 1e3), "top": top[:12]}
    if label:
        emit(label, **out)
    return out


def train_full_width_phase(dev, seed: int, workdir) -> dict:
    """The gradient gate and three ``Trainer`` steps of zamba2-2.7b at full
    width (bf16 params, fp32 masters), counted; then one step profiled."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.config import ShapeSpec
    from repro_torch.models.model import init_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import Trainer, TrainerConfig

    cfg = get_config(LM_ARCH)
    params = init_params(cfg, seed=seed, device=dev)
    toks = SyntheticLM(cfg.vocab_size, TRAIN_LEN, TRAIN_BATCH, seed).batch_at(0)["tokens"]
    micro = {"tokens": torch.from_numpy(toks[:1].astype("int64")).to(dev)}
    keep = ["embed", "shared_attn/wq", ("stacks/ssm/ssm/w_in", 0)]
    grad_gate("train_grad_gate", cfg, params, micro, keep, gated=False)
    unit = _unit_scale_attention(params, cfg)
    grad_gate("train_grad_gate", cfg, unit, micro, keep, init="unit_scale_attention")
    f32_compute = dataclasses.replace(cfg, dtype="float32", attn_p_dtype="float32")
    grad_gate("train_grad_gate", f32_compute, unit, micro, keep, init="unit_scale_attention")
    del params, unit, micro
    torch.cuda.empty_cache()

    shape = ShapeSpec("train", seq_len=TRAIN_LEN, global_batch=TRAIN_BATCH, kind="train")
    trainer = Trainer(cfg, shape, make_host_mesh(), workdir,
                      TrainerConfig(total_steps=TRAIN_STEPS, checkpoint_every=0, log_every=1,
                                    seed=seed),
                      opt=AdamWConfig(warmup_steps=1, total_steps=TRAIN_STEPS), device=dev)
    if (trainer.plan.accum_steps, trainer.plan.microbatch) != (2, 1):
        raise AssertionError(f"train plan {trainer.plan}")
    torch.cuda.reset_peak_memory_stats()
    result, secs, counts = counted(trainer.run)
    per_micro = expected_train_launches(cfg)
    n_micro = TRAIN_STEPS * trainer.plan.accum_steps
    check_launches("train", counts, {k: v * n_micro for k, v in per_micro.items()})
    hist = result["history"]
    if not all(map(math.isfinite, (h["loss"] for h in hist))):
        raise AssertionError(f"train: losses {hist}")
    tokens = TRAIN_LEN * TRAIN_BATCH
    fields = dict(model=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
                  n_params=cfg.n_params,
                  param_dtype=cfg.param_dtype, seq=TRAIN_LEN, global_batch=TRAIN_BATCH,
                  accum_steps=trainer.plan.accum_steps, microbatch=trainer.plan.microbatch,
                  steps=TRAIN_STEPS, seconds=secs,
                  step_seconds=[h["dt"] for h in hist],
                  tokens_per_s=[tokens / h["dt"] for h in hist],
                  losses=[h["loss"] for h in hist], grad_norms=[h["grad_norm"] for h in hist],
                  lrs=[h["lr"] for h in hist],
                  max_memory_allocated=torch.cuda.max_memory_allocated(),
                  launches={k: counts.get(k, 0) for k in per_micro},
                  launches_per_step={k: counts.get(k, 0) // TRAIN_STEPS for k in per_micro},
                  expected_per_microbatch=per_micro, nvidia_smi=nvidia_smi_line())
    emit("train", **fields)
    torch.cuda.empty_cache()
    train_profile(trainer, statistics.median(h["dt"] for h in hist))
    torch.cuda.empty_cache()
    return counts


def train_smoke_phases(dev, seed: int, workdir) -> None:
    """The f32 gradient gate at smoke size, crash → resume, and the mixtral
    smoke config's Trainer steps, on the card."""
    import torch

    from repro_torch.configs import get_smoke
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.config import ShapeSpec
    from repro_torch.models.model import init_params
    from repro_torch.train.loop import Trainer, TrainerConfig

    cfg = dataclasses.replace(get_smoke(LM_ARCH), dtype="float32", param_dtype="float32",
                              attn_p_dtype="float32")
    params = init_params(cfg, seed=seed, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    micro = {"tokens": torch.randint(0, cfg.vocab_size, (2, 64), generator=gen, device=dev)}
    keep = [path for path, _ in _paths(params)]
    grad_gate("train_grad_gate_f32", cfg, params, micro, keep)
    del params

    smoke = get_smoke("tinyllama-1.1b")
    shape = ShapeSpec("tiny_train", seq_len=32, global_batch=4, kind="train")

    def crash_resume(label):
        a = Trainer(smoke, shape, make_host_mesh(), Path(workdir) / f"{label}_a",
                    TrainerConfig(total_steps=6, checkpoint_every=3, log_every=1), device=dev)
        ra = a.run()
        b1 = Trainer(smoke, shape, make_host_mesh(), Path(workdir) / f"{label}_b",
                     TrainerConfig(total_steps=6, checkpoint_every=3, log_every=1,
                                   fail_at_step=4), device=dev)
        try:
            b1.run()
            raise AssertionError("train_resume: the injected failure did not fire")
        except RuntimeError as e:
            if "injected failure" not in str(e):
                raise
        b2 = Trainer(smoke, shape, make_host_mesh(), Path(workdir) / f"{label}_b",
                     TrainerConfig(total_steps=6, checkpoint_every=3, log_every=1), device=dev)
        rb = b2.run()
        return ra["final_loss"], rb["final_loss"], [h["step"] for h in rb["history"]]

    ra, rb, resumed = crash_resume("resume")
    runs = {"default": {"final_loss": ra, "resumed_final_loss": rb, "delta": abs(ra - rb),
                        "resumed_steps": resumed}}
    if not abs(ra - rb) < RESUME_BOUND:
        torch.use_deterministic_algorithms(True, warn_only=False)
        try:
            ra, rb, resumed = crash_resume("resume_deterministic")
        finally:
            torch.use_deterministic_algorithms(False)
        runs["deterministic"] = {"final_loss": ra, "resumed_final_loss": rb,
                                 "delta": abs(ra - rb), "resumed_steps": resumed}
    emit("train_resume", model=smoke.name, bound=RESUME_BOUND, gated=list(runs)[-1], **runs)
    if not (abs(ra - rb) < RESUME_BOUND and resumed == [4, 5, 6]):
        raise AssertionError(f"train_resume: {runs}")

    moe = get_smoke("mixtral-8x22b")
    t = Trainer(moe, ShapeSpec("t", seq_len=16, global_batch=2, kind="train"), make_host_mesh(),
                Path(workdir) / "moe", TrainerConfig(total_steps=3, checkpoint_every=100),
                device=dev)
    result, secs, counts = counted(t.run)
    losses = [h["loss"] for h in result["history"]]
    per_micro = expected_train_launches(moe)
    check_launches("train_moe", counts,
                   {k: v * 3 * t.plan.accum_steps for k, v in per_micro.items()})
    emit("train_moe", model=moe.name, losses=losses, seconds=secs,
         launches={k: counts.get(k, 0) for k in per_micro})
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"train_moe: losses {losses}")


def moe_frontend_phase(dev, seed: int) -> dict:
    """mixtral-8x22b at full width, depth MIXTRAL_DEPTH: prefill of
    MIXTRAL_PROMPT tokens (K6 with its 4096-token window, which they exceed)
    and MIXTRAL_DECODE decode steps; internvl2-1b at full width: prefill
    with a seeded (1, 256, 1024) ``extra``.  Counted; finite logits."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import decode_step, init_params, make_cache, prefill

    out = {}
    cfg = dataclasses.replace(get_config("mixtral-8x22b"), n_layers=MIXTRAL_DEPTH)
    params = init_params(cfg, seed=seed, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (1, MIXTRAL_PROMPT), generator=gen, device=dev)
    with torch.no_grad():
        prefill(params, tokens[:, :256], cfg)                      # warm-up
        torch.cuda.reset_peak_memory_stats()
        (logits, _), secs, counts = counted(lambda: prefill(params, tokens, cfg))
        check_launches("moe_prefill", counts, {"flash_attention": MIXTRAL_DEPTH, "ssd_chunk": 0})
        caches = make_cache(cfg, 1, MIXTRAL_PROMPT + MIXTRAL_DECODE, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(MIXTRAL_DECODE):
            step_logits, caches = decode_step(params, caches, tokens[:, t : t + 1], cfg)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    finite = bool(torch.isfinite(logits).all() and torch.isfinite(step_logits).all())
    out["mixtral"] = dict(model=cfg.name, depth=f"{MIXTRAL_DEPTH} of 56", d_model=cfg.d_model,
                          n_params=cfg.n_params, window=cfg.sliding_window,
                          prompt=MIXTRAL_PROMPT, prefill_s=secs,
                          prefill_tokens_per_s=MIXTRAL_PROMPT / secs,
                          decode_steps=MIXTRAL_DECODE, decode_s=decode_s,
                          decode_tokens_per_s=MIXTRAL_DECODE / decode_s,
                          cache_len=int(caches["attn"]["k"].shape[2]),
                          max_memory_allocated=torch.cuda.max_memory_allocated(),
                          launches={k: counts[k] for k in ("flash_attention", "ssd_chunk")},
                          logits_finite=finite)
    if not finite or tuple(logits.shape) != (1, 1, cfg.vocab_size):
        raise AssertionError(f"moe_prefill: {out['mixtral']}")
    del params, caches, logits, step_logits
    torch.cuda.empty_cache()

    cfg = get_config("internvl2-1b")
    params = init_params(cfg, seed=seed, device=dev)
    fe = cfg.frontend
    tokens = torch.randint(0, cfg.vocab_size, (1, INTERNVL_TEXT), generator=gen, device=dev)
    extra = torch.randn((1, fe.n_extra_tokens, fe.feature_dim), generator=gen,
                        device=dev).to(torch.bfloat16)
    with torch.no_grad():
        prefill(params, tokens, cfg, extra=extra)                   # warm-up
        (logits, cache), secs, counts = counted(lambda: prefill(params, tokens, cfg, extra=extra))
        check_launches("frontend_prefill", counts, {"flash_attention": cfg.n_layers})
        plain_logits, _ = prefill(params, tokens, cfg)
    finite = bool(torch.isfinite(logits).all())
    moved = (logits.float() - plain_logits.float()).abs().max().item()
    out["internvl2"] = dict(model=cfg.name, n_params=cfg.n_params, text=INTERNVL_TEXT,
                            extra=list(extra.shape), pos=cache["pos"], prefill_s=secs,
                            tokens_per_s=(INTERNVL_TEXT + fe.n_extra_tokens) / secs,
                            launches={"flash_attention": counts["flash_attention"]},
                            logits_finite=finite, extra_moves_logits=moved)
    if not finite or cache["pos"] != INTERNVL_TEXT + fe.n_extra_tokens or not moved > 0:
        raise AssertionError(f"frontend_prefill: {out['internvl2']}")
    emit("moe_frontend", **out)
    del params
    torch.cuda.empty_cache()
    return out


def train_phases(dev, seed: int) -> dict:
    """Training at full width and smoke size, then MoE and the frontends;
    returns the full-width run's launch counts."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        counts = train_full_width_phase(dev, seed, Path(tmp) / "full")
        train_smoke_phases(dev, seed, tmp)
    moe_frontend_phase(dev, seed)
    emit("train_phases_total", seconds=time.perf_counter() - t0)
    return counts


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def _map_leaves(tree, fn):
    return {k: _map_leaves(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


DRYRUN_CELL = ("zamba2-2.7b", "prefill_32k", "pod")
DRYRUN_FLOP_TOL = 1e-3               # traced dot flops against FlopCounterMode's


@contextlib.contextmanager
def launch_bounds():
    """Each real kernel launch's bound in seconds, summed by kernel, from its
    launcher's ``cost`` on the launch's own tensors (the formula the dry-run's
    modeled launches use); the launch counts are the wrappers' own."""
    from repro_torch.kernels import ops

    sums: dict = {}
    run = ops.KernelWrapper.run

    def bounded(self, *tensors, **static):
        if all(t is None or t.is_cuda for t in tensors):
            sums[self.name] = sums.get(self.name, 0.0) + \
                self._launcher.cost(*tensors, **static).seconds
        return run(self, *tensors, **static)

    ops.KernelWrapper.run = bounded
    try:
        yield sums
    finally:
        ops.KernelWrapper.run = run


def dryrun_parser(args, dev) -> None:
    """``ParserEngine.phase_static_cost`` at TRAFFIC's and e125's buckets on
    ``cuda`` and on ``packed`` / ``sparse`` with ``kernel=True``: the modeled
    launches by kernel equal the launches of the same engine's real parse of
    that text (counts set to 0 just before it), and each kernel's modeled
    bound equals the sum of its launcher's ``cost`` over the real launches;
    then ``stats()["hlo"]`` of a traced ``cuda`` parser."""
    from repro_torch import ObsConfig, Parser, ParserConfig

    traffic = traffic_log(TRAFFIC_BYTES, args.seed)
    e125 = e125_text(E125_BYTES, args.seed + 1)
    for label, regex, text in (("traffic", TRAFFIC_RE, traffic), ("e125", E125_RE, e125)):
        for backend, kernel in (("cuda", False), ("packed", True), ("sparse", True)):
            p = Parser(ParserConfig(regex=regex, backend=backend, kernel=kernel,
                                    n_chunks=N_CHUNKS), device=dev)
            eng = p.engine
            c, k = eng.bucket_shape(len(eng.classes_of_text(text)), N_CHUNKS)
            t0 = time.perf_counter()
            traces = eng.phase_traces(c, k)
            trace_s = time.perf_counter() - t0
            cost = eng.phase_static_cost(c, k)
            modeled, modeled_s = {}, {}
            for st in traces.values():
                for name, n in st.kernel_launches.items():
                    modeled[name] = modeled.get(name, 0) + n
                for name, sec in st.kernel_bound_s.items():
                    modeled_s[name] = modeled_s.get(name, 0.0) + sec
            with launch_bounds() as real_s:
                _, _, counts = counted(lambda: p.parse(text))
            real = {name: n for name, n in counts.items() if n}
            if modeled != real:
                raise AssertionError(f"dryrun {label} {backend}: modeled launches {modeled}, "
                                     f"real {real}")
            if set(modeled_s) != set(real_s) or any(
                    abs(modeled_s[n] - real_s[n]) > 1e-9 * real_s[n] for n in real_s):
                raise AssertionError(f"dryrun {label} {backend}: modeled bounds {modeled_s}, "
                                     f"real launches' {real_s}")
            emit("dryrun_parser", text=label, backend=backend, kernel=kernel, bucket=[c, k],
                 trace_s=trace_s, modeled_launches=modeled, real_launches=real,
                 modeled_bound_ms={n: v * 1e3 for n, v in modeled_s.items()},
                 real_bound_ms={n: v * 1e3 for n, v in real_s.items()},
                 phases={ph: {**cost[ph], "launches": traces[ph].kernel_launches}
                         for ph in traces})
            del p, eng
    p = Parser(ParserConfig(regex=TRAFFIC_RE, backend="cuda", n_chunks=N_CHUNKS,
                            obs=ObsConfig(enabled=True)), device=dev)
    p.parse(traffic)
    hlo = p.stats()["hlo"]
    if not hlo:
        raise AssertionError("dryrun: a traced parser's stats()['hlo'] is empty")
    emit("dryrun_stats_hlo", hlo=hlo)


def dryrun_train(dev, seed: int) -> None:
    """The ``train`` phase's zamba2-2.7b step (full width, 2 x 2048 tokens:
    accum 2 x microbatch 1, bf16 params, fp32 masters, remat on) traced on
    meta tensors, against one real step on the card: the modeled K6 / K7
    launches equal the real ones, the traced dot flops equal
    ``FlopCounterMode``'s count of the real step within DRYRUN_FLOP_TOL, and
    the trace's ``peak_bytes`` beside ``torch.cuda.max_memory_allocated``."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import trace_step
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.config import ShapeSpec
    from repro_torch.models.model import init_params
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.parallel.sharding import MeshRules, adapt_rules_for
    from repro_torch.train.step import make_train_step, plan_for

    cfg = get_config(LM_ARCH)
    mesh = make_host_mesh()
    shape = ShapeSpec("train", seq_len=TRAIN_LEN, global_batch=TRAIN_BATCH, kind="train")
    plan = plan_for(cfg, shape, mesh, opt=AdamWConfig(warmup_steps=1, total_steps=TRAIN_STEPS))
    if (plan.accum_steps, plan.microbatch) != (2, 1):
        raise AssertionError(f"dryrun train plan {plan}")
    rules = adapt_rules_for(cfg, mesh, MeshRules())
    t0 = time.perf_counter()
    stats, _ = trace_step(cfg, shape, mesh, rules, plan=plan)
    trace_s = time.perf_counter() - t0
    params = init_params(cfg, seed=seed, device=dev)
    state = init_opt_state(params)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (2, 1, TRAIN_LEN), generator=gen, device=dev)
    step = make_train_step(plan, mesh, rules)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as fc:
        _, step_s, counts = counted(lambda: step(params, state, {"tokens": tokens}))
    peak = torch.cuda.max_memory_allocated()
    del params, state, tokens
    torch.cuda.empty_cache()
    real = {n: v for n, v in counts.items() if v}
    if stats.kernel_launches != real or not real.get("flash_attention"):
        raise AssertionError(f"dryrun train: modeled launches {stats.kernel_launches}, "
                             f"real {counts}")
    dots = fc.get_total_flops()
    rel = abs(stats.dot_flops - dots) / dots
    if rel > DRYRUN_FLOP_TOL:
        raise AssertionError(f"dryrun train: traced dot flops {stats.dot_flops}, "
                             f"FlopCounterMode {dots} (rel {rel})")
    emit("dryrun_train", model=cfg.name, seq=TRAIN_LEN, global_batch=TRAIN_BATCH,
         accum_steps=plan.accum_steps, microbatch=plan.microbatch, trace_s=trace_s,
         step_s=step_s, modeled_launches=stats.kernel_launches, real_launches=real,
         traced_dot_flops=stats.dot_flops, flop_counter_flops=dots, dot_flops_rel_err=rel,
         tolerance=DRYRUN_FLOP_TOL, traced_flops=stats.flops, traced_bytes=stats.bytes,
         kernel_bound_ms={n: v * 1e3 for n, v in stats.kernel_bound_s.items()},
         peak_bytes=stats.peak_bytes, max_memory_allocated=peak,
         peak_over_measured=stats.peak_bytes / peak, nvidia_smi=nvidia_smi_line())


def dryrun_cell() -> None:
    """One production cell (DRYRUN_CELL: zamba2-2.7b x prefill_32k on the
    fake (16, 16) 'pod' mesh), traced as ``python -m
    repro_torch.launch.dryrun`` traces it; prints its record."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.config import SHAPE_BY_NAME

    arch, shape, mesh_name = DRYRUN_CELL
    mesh = make_production_mesh(multi_pod=mesh_name == "multipod")
    try:
        rec = dryrun.run_cell(get_config(arch), SHAPE_BY_NAME[shape], mesh, mesh_name)
    finally:
        dist.destroy_process_group()
    launches = rec["coll_detail"]["kernel_launches"]
    if not (rec["ok"] and launches.get("flash_attention") and launches.get("ssd_chunk")):
        raise AssertionError(f"dryrun cell {DRYRUN_CELL}: {rec}")
    emit("dryrun_cell", key=dryrun.cell_key(arch, shape, mesh_name), modeled=True, **rec)


def dryrun_phase(args, dev) -> None:
    """The launch tools: ``phase_static_cost`` against real parses, the
    train step's trace against a real step, one production cell."""
    t0 = time.perf_counter()
    dryrun_parser(args, dev)
    dryrun_train(dev, args.seed)
    dryrun_cell()
    emit("dryrun_total", seconds=time.perf_counter() - t0)


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
    lm_records = lm_phases(dev, args.seed)
    train_counts = train_phases(dev, args.seed)
    mesh_counts = train_mesh_phase(dev, args.seed)
    dryrun_phase(args, dev)
    examples_phase(args, dev)
    gates_phase()
    for rec in lm_records:
        rec["train_launches"] = train_counts.get(count_key(rec), 0)
        rec["train_mesh_launches_per_rank"] = mesh_counts.get(count_key(rec), 0)
    records += lm_records
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
FLEET_E125, FLEET_E125_BYTES = 16, 64 << 10
FLEET_STRIP_K = 256         # steps a chunk of the strip / row kernels' records
FLEET_MAX_BATCH = 1024      # a bucket's requests in one dispatch


def fleet_tenants(seed: int):
    """The log-routing fleet: {tenant: (ParserConfig, [texts])}, 256 tenants
    in 5 automaton buckets: 192 on the 8 patterns (a|b)*a(a|b){k} (cuda, 4
    texts of 4 KiB of random a/b each), 48 on TRAFFIC (16 each on cuda,
    packed and sparse with kernel=True, 4 logs of 64 KiB each) and 16 on
    e125 (cuda, one text of 64 KiB each, in the ℓp-512 bucket whose window
    ℓ' = 288 K1 and K2 walk); 16 MiB a sweep.  Chunks of about 1024
    characters."""
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
        cfg = ParserConfig(regex=E125_RE, backend="cuda", n_chunks=FLEET_E125_BYTES // 1024)
        tenants[f"e125-{j:02d}"] = (cfg, [e125_text(FLEET_E125_BYTES, seed + 1000 + j)])
    return tenants


class DispatchLog:
    """Launch counts of each bucket dispatch of a fleet: ``run_bucket``
    wrapped, the counts read before and after each (synchronized), with the
    launches' grids, plans and the live window of the dispatch's stack."""

    KERNELS = ("reach_chunk_product", "packed_reach_chunk_product", "sparse_reach_rows",
               "build_merge_packed", "semiring_matmul")

    def __init__(self, engine):
        import torch

        from repro_torch.core.backend import next_pow2
        from repro_torch.kernels import build, ops, packed_reach, reach, window

        self.records = []
        run = engine.run_bucket

        def grids(bucket, items):
            """The bucket's reach and K2 launch grids (x, y = tenants,
            threads) and plans, at the window ℓ' that the dispatch's gathered
            stack carries (K1's group kernel and K2's walk visit ℓ' states)."""
            (key, A1, lp), (c, k) = bucket
            per = {}
            for tid, classes in items:
                per.setdefault(tid, []).append(classes)
            runner = engine.runner(bucket[0])
            rows, _ = runner.host_batch(c, k, per)
            lw = window.width(runner.operands(rows)[0])
            T = len(rows)
            C = T * next_pow2(max(len(v) for v in per.values())) * c
            if key.startswith("cuda"):
                reach_grid = reach.grid(A1, lp, C, T, lw=lw)
                reach_kind = reach.plan(A1, lp, lw)[0]
            else:
                width = runner.backend._width if key.startswith("sparse") else lp
                reach_grid = packed_reach.grid(A1, lp, width, C, T)
                reach_kind = packed_reach.plan(A1, lp, width)[0]
            return {"chunks": C, "ell_pad": lp, "window": lw, "reach": list(reach_grid),
                    "reach_kernel": reach_kind,
                    "build_merge": list(build.grid(A1, lp, C, T, lw=lw)),
                    "build_merge_kernel": build.plan(A1, lp, C, lw).kernel}

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
    and on e125's (ℓp 512, window ℓ' = 288: the group kernel and the walk
    over the live states, "fleet_window"), K4 and K5 on TRAFFIC's packed and
    sparse buckets; then K1's strip and K2's row kernel ("fleet_strip",
    "fleet_rows"), which no fleet dispatch takes any more, on e125's stack
    with its block structure broken (an arc into the last padded state: ℓ'
    = ℓp), its chunks cut to FLEET_STRIP_K steps.  One record a launch
    kind, with the warm run's launches of that kind (``counts``) and the
    launch's grid.  Bounds count each tenant's real steps at its own ℓ (K5
    at its mean feasible width)."""
    import numpy as np
    import torch

    from repro_torch.core.backend import TorchBackend
    from repro_torch.core.matrices import (
        feasible_start_widths,
        pack_transition_table_torch,
        sparse_init_rows,
    )
    from repro_torch.kernels import build, ops, packed_reach, reach, sparse_reach, window

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
        # real steps of each tenant's row (the rows past the tenants pad the
        # stack and are all PAD)
        real = (grid != runner.pad_class).reshape(len(rows), -1).sum(axis=1)[:len(tids)]
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

    def record(name, kern, args, cost, grid_xyz, runner, extra, case="fleet"):
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
        b_ms, b_by = bound_ms(cost)
        shapes = {"bucket": "|".join(map(str, runner.key)),
                  "tenants": int(args[0].shape[0]), "chunks": int(args[1].shape[0]),
                  "k": int(args[1].shape[1]), "operands": [list(x.shape) for x in args]}
        if name in ("reach_chunk_product", "build_merge_packed"):
            A1, lp, lw = args[0].shape[-3], args[0].shape[-1], window.width(args[0])
            plan = (reach.plan(A1, lp, lw) if name == "reach_chunk_product"
                    else build.plan(A1, lp, shapes["chunks"], lw))
            shapes.update(ell_pad=lp, window=lw, plan=list(plan))
        rec = {"name": name, "case": case, "route": "cuda", "source": extra["source"],
               "replaces": extra["replaces"], "launches": counts.get((name, case), 0),
               "max_abs_err": 0.0,
               **fields, "bound_ms": b_ms, "bound_by": b_by, "shapes": shapes,
               "grid": list(grid_xyz)}
        emit("kernel", pattern="fleet", tolerance=0, **rec)
        records.append(rec)
        torch.cuda.empty_cache()

    runner, tids, grid, N, I, F, ids, real, ells = bucket_inputs("ab")
    T, A1, lp = N.shape[0], N.shape[1], N.shape[-1]
    C, k = ids.shape
    record("reach_chunk_product", ops.reach_chunk_product, (N, ids),
           reach.cost(N, ids, steps=real, ell=ells), reach.grid(A1, lp, C, T), runner,
           {"source": "src/repro_torch/csrc/reach.cu", "replaces": "src/repro/kernels/reach.py:49"})
    P = ops.reach_chunk_product.plain(N, ids).reshape(grid.shape[:3] + (lp, lp))
    Jf, Jb = TorchBackend().join(P, I[:, None], F[:, None])
    Jf, Jb = Jf.reshape(C, lp).contiguous(), Jb.reshape(C, lp).contiguous()
    del P
    record("build_merge_packed", ops.build_merge_packed, (N, ids, Jf, Jb),
           build.cost(N, ids, Jf, Jb, steps=real, ell=ells), build.grid(A1, lp, C, T), runner,
           {"source": "src/repro_torch/csrc/build_merge.cu", "replaces": "src/repro/kernels/build.py:60"})
    del Jf, Jb

    # e125's bucket: ℓ = 257 padded to ℓp 512; the gathered stack carries
    # its window ℓ' = 288, so K1 takes the group kernel and K2 the walk over
    # the live states, the padded part written from the block algebra
    runner, tids, grid, N, I, F, ids, real, ells = bucket_inputs("e125")
    T, A1, lp = N.shape[0], N.shape[1], N.shape[-1]
    C, k = ids.shape
    lw = window.width(N)
    if (lp, lw) != (512, 288) or reach.plan(A1, lp, lw)[0] != "group" \
            or build.plan(A1, lp, C, lw).kernel != "walk":
        raise AssertionError(f"e125's bucket: ℓp {lp}, window {lw}: not the group kernel, walk")
    k1 = {"source": "src/repro_torch/csrc/reach.cu", "replaces": "src/repro/kernels/reach.py:49"}
    k2 = {"source": "src/repro_torch/csrc/build_merge.cu",
          "replaces": "src/repro/kernels/build.py:60"}
    record("reach_chunk_product", ops.reach_chunk_product, (N, ids),
           reach.cost(N, ids, steps=real, ell=ells), reach.grid(A1, lp, C, T, lw=lw), runner, k1,
           case="fleet_window")
    P = ops.reach_chunk_product(N, ids).reshape(grid.shape[:3] + (lp, lp))
    Jf, Jb = TorchBackend().join(P, I[:, None], F[:, None])
    Jf, Jb = Jf.reshape(C, lp).contiguous(), Jb.reshape(C, lp).contiguous()
    del P
    record("build_merge_packed", ops.build_merge_packed, (N, ids, Jf, Jb),
           build.cost(N, ids, Jf, Jb, steps=real, ell=ells), build.grid(A1, lp, C, T, lw=lw),
           runner, k2, case="fleet_window")

    # the strip and row kernels, on the same stack with its block structure
    # broken: an arc from state 0 into the last padded state in class 0 of
    # every tenant leaves no window short of ℓp
    Nb = N.clone()
    Nb[:, 0, 0, lp - 1] = 1.0
    lw = window.live_window(Nb).width
    if lw != lp or reach.plan(A1, lp)[0] != "strip" or build.plan(A1, lp, C).kernel != "rows":
        raise AssertionError(f"the broken stack: window {lw}, not the strip and row kernels")
    ids_b = ids[:, :FLEET_STRIP_K].contiguous()
    real_b = (grid.reshape(-1, k)[:, :FLEET_STRIP_K] != runner.pad_class).reshape(T, -1).sum(
        axis=1)[:len(tids)]
    record("reach_chunk_product", ops.reach_chunk_product, (Nb, ids_b),
           reach.cost(Nb, ids_b, steps=real_b, ell=ells), reach.grid(A1, lp, C, T), runner, k1,
           case="fleet_strip")
    record("build_merge_packed", ops.build_merge_packed, (Nb, ids_b, Jf, Jb),
           build.cost(Nb, ids_b, Jf, Jb, steps=real_b, ell=ells), build.grid(A1, lp, C, T),
           runner, k2, case="fleet_rows")
    del Jf, Jb, Nb

    runner, tids, grid, N, I, F, ids, real, ells = bucket_inputs("traffic-packed")
    T, A1, lp = N.shape[0], N.shape[1], N.shape[-1]
    C, k = ids.shape
    W = lp // 32
    Np = pack_transition_table_torch(N)
    record("packed_reach_chunk_product", ops.packed_reach_chunk_product, (Np, ids),
           packed_reach.cost(Np, ids, steps=real, ell=ells), packed_reach.grid(A1, lp, lp, C, T),
           runner, {"source": "src/repro_torch/csrc/packed_reach.cu",
                    "replaces": "src/repro/kernels/packed_reach.py:74"})

    runner, tids, grid, N, I, F, ids, real, ells = bucket_inputs("traffic-sparse")
    sparse = runner.backend
    S = sparse._width
    R0 = sparse_init_rows(sparse.feasible_rows(N, torch.from_numpy(grid).to(N.device)),
                          lp).reshape(C, S, W).contiguous()
    Np = pack_transition_table_torch(N)
    Nh = N.cpu().numpy()
    widths = [feasible_start_widths(Nh[t], grid[t].reshape(-1, k)) for t in range(len(real))]
    w_mean = [float(w[w >= 0].mean() if (w >= 0).any() else 0.0) for w in widths]
    record("sparse_reach_rows", ops.sparse_reach_rows, (Np, ids, R0),
           sparse_reach.cost(Np, ids, R0, steps=real, ell=ells, rows=w_mean),
           packed_reach.grid(A1, lp, S, C, T),
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
    # walks over all ℓp ("fleet") and over a window ("fleet_window") apart
    # from the fallbacks
    case = {"group": "fleet", "walk": "fleet", "strip": "fleet_strip", "rows": "fleet_rows",
            "fold": "fleet_fold"}
    by_case = {}
    for rec in log_warm:
        n, g = rec["launches"], rec["grids"]
        reach_name = next(k for k in DispatchLog.KERNELS[:3] if n[k])
        for name, kind in ((reach_name, g["reach_kernel"]),
                           ("build_merge_packed", g["build_merge_kernel"])):
            on_window = g["window"] < g["ell_pad"] and kind in ("group", "walk") \
                and name in ("reach_chunk_product", "build_merge_packed")     # K4 / K5 take none
            label = "fleet_window" if on_window else case[kind]
            by_case[(name, label)] = by_case.get((name, label), 0) + n[name]
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
    import torch

    cards = torch.cuda.device_count()
    world, group_backend = (min(4, cards), "nccl") if cards >= 2 else (2, "gloo")
    t0 = time.perf_counter()
    reports = run_ranks("mesh", mesh_rank, world, (group_backend, args.seed), MESH_TIMEOUT_S)
    emit("mesh", world=world, group_backend=group_backend, mesh_shape=reports[0]["mesh_shape"],
         transport=reports[0]["transport"], seconds=time.perf_counter() - t0,
         columns_equal_single_process=True, ranks=reports)


def run_ranks(label: str, target, world: int, args: tuple, timeout_s: float) -> list:
    """``target(rank, world, tmp, *args)`` in ``world`` processes
    (``torch.multiprocessing``, spawn), each writing its JSON report to
    ``tmp/rank<r>.json``; returns the reports in rank order.  A rank that
    fails fails the phase at once (the others are killed); a rank still
    running after ``timeout_s`` is killed and fails it too."""
    import tempfile

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{label}_") as tmp:
        procs = [ctx.Process(target=target, args=(r, world, tmp, *args)) for r in range(world)]
        for proc in procs:
            proc.start()
        deadline = time.monotonic() + timeout_s
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
                                f"(timeout {timeout_s} s, or another rank failed)")
            elif proc.exitcode != 0 or not rep.get("ok"):
                failures.append(f"rank {r} exit code {proc.exitcode}: "
                                f"{rep.get('error', 'no report')}")
    if failures:
        raise AssertionError(f"{label}: " + "\n".join(failures))
    return reports


def rank_main(rank: int, world: int, group_backend: str, tmp: str, runs, *args) -> None:
    """One rank of a multi-process phase: loads the built kernels (compiling
    nothing), joins the group (rendezvous through a file in ``tmp``), runs
    ``runs(dev, *args)`` and writes its report (or its traceback) to ``tmp``;
    exits 1 on a failure."""
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
        report.update(runs(dev, *args))
        report["ok"] = True
    except Exception:
        report["error"] = traceback.format_exc()[-6000:]
    finally:
        if dist is not None and dist.is_initialized():
            dist.destroy_process_group()
        (Path(tmp) / f"rank{rank}.json").write_text(json.dumps(report))
    if not report["ok"]:
        sys.exit(1)


def mesh_rank(rank: int, world: int, tmp: str, group_backend: str, seed: int) -> None:
    """One rank of ``mesh_phase``: ``mesh_runs`` under ``rank_main``."""
    rank_main(rank, world, group_backend, tmp, mesh_runs, seed)


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


# ------------------------------------------------------ training on a mesh

# zamba2-2.7b at full width cut to its first shared block, on a (2, 2)
# ('data', 'model') mesh of 4 ranks: accum 2 x microbatch 2 (one rank: 4 x 1)
TRAIN_MESH = dict(depth=6, seq=512, batch=4, steps=2, opt="default", profile=False,
                  variants=("bfloat16", "float32"))
# losses against the one-rank Trainer, by compute dtype: the reference itself
# moves by up to 1.3e-2 between one device and (2, 2) in bf16 (PERF.md)
TRAIN_MESH_GATE = {"bfloat16": 2e-2, "float32": 1e-4}
TRAIN_MESH_TIMEOUT_S = 300


def train_mesh_config(depth: int, variant: str):
    """zamba2-2.7b at full width, its first ``depth`` layers, bf16 params,
    computing in ``variant`` (bf16, or f32 over the bf16 params)."""
    from repro_torch.configs import get_config

    cfg = get_config(LM_ARCH)
    cfg = dataclasses.replace(cfg, n_layers=depth, layout=cfg.layout[:depth])
    if variant == "float32":
        cfg = dataclasses.replace(cfg, dtype="float32", attn_p_dtype="float32")
    return cfg


@contextlib.contextmanager
def trainer_init(init: str):
    """The ``Trainer``'s params as initialized (``init`` "as initialized"),
    or with unit-scale attention logits (``"unit_scale_attention"``:
    ``_unit_scale_attention`` applied to the whole params before the
    ``Trainer`` places them)."""
    from repro_torch.train import loop

    made = loop.init_params
    if init == "unit_scale_attention":
        loop.init_params = lambda cfg, **kw: _unit_scale_attention(made(cfg, **kw), cfg)
    elif init != "as initialized":
        raise ValueError(f"unknown init {init!r}")
    try:
        yield
    finally:
        loop.init_params = made


def train_mesh_run(dev, mesh, spec: dict, variant: str, seed: int, workdir) -> dict:
    """``spec["steps"]`` counted ``Trainer`` steps on ``mesh`` (on a mesh of
    several ranks, this rank's share): losses, step seconds, tokens/s, peak
    memory and K6 / K7 launches (checked: one microbatch's count times the
    microbatches), and with ``spec["profile"]`` one more step profiled.
    ``spec["init"]`` (default "as initialized") picks the params
    (``trainer_init``)."""
    import torch

    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import Trainer, TrainerConfig

    cfg = train_mesh_config(spec["depth"], variant)
    steps = spec["steps"]
    opt = (AdamWConfig() if spec["opt"] == "default"
           else AdamWConfig(warmup_steps=1, total_steps=steps))
    shape = ShapeSpec("train", seq_len=spec["seq"], global_batch=spec["batch"], kind="train")
    trainer = Trainer(cfg, shape, mesh, Path(workdir) / variant,
                      TrainerConfig(total_steps=steps, checkpoint_every=0, log_every=1,
                                    seed=seed), opt=opt, device=dev)
    torch.cuda.reset_peak_memory_stats()
    with trainer_init(spec.get("init", "as initialized")):
        result, secs, counts = counted(trainer.run)
    per_micro = expected_train_launches(cfg)
    check_launches(f"train_mesh {variant}", counts,
                   {k: v * steps * trainer.plan.accum_steps for k, v in per_micro.items()})
    hist = result["history"]
    if not all(map(math.isfinite, (h["loss"] for h in hist))):
        raise AssertionError(f"train_mesh {variant}: losses {hist}")
    tokens = spec["seq"] * spec["batch"]
    out = {"plan": [trainer.plan.accum_steps, trainer.plan.microbatch, trainer.plan.tp],
           "losses": [h["loss"] for h in hist], "grad_norms": [h["grad_norm"] for h in hist],
           "step_seconds": [h["dt"] for h in hist],
           "tokens_per_s": [tokens / h["dt"] for h in hist], "seconds": secs,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches": {k: counts.get(k, 0) for k in per_micro},
           "expected_per_microbatch": per_micro}
    if spec["profile"]:
        torch.cuda.empty_cache()
        out["profile"] = train_profile(trainer, statistics.median(out["step_seconds"]),
                                       label=None)
    return out


def train_mesh_runs(dev, spec: dict, seed: int, workdir) -> dict:
    """One rank of ``train_mesh_phase``: every variant on the (2, 2)
    ('data', 'model') mesh, with the calls and bytes this rank sent a step
    through the host-staged collectives (gloo ranks sharing one card)."""
    from repro_torch.launch import mesh as mesh_mod

    mesh = mesh_mod.ParseMesh((2, 2), ("data", "model"))
    out = {"mesh_shape": mesh.shape, "group": mesh.backend}
    for variant in spec["variants"]:
        mesh_mod.STAGED_TRAFFIC.clear()
        out[variant] = train_mesh_run(dev, mesh, spec, variant, seed,
                                      Path(workdir) / f"rank{mesh.rank}")
        out[variant]["staged_traffic_per_step"] = {
            op: {k: v / spec["steps"] for k, v in seen.items()}
            for op, seen in mesh_mod.STAGED_TRAFFIC.items()}
    return out


def train_mesh_rank(rank: int, world: int, tmp: str, group_backend: str, spec: dict,
                    seed: int) -> None:
    """One rank of ``train_mesh_phase``: ``train_mesh_runs`` under
    ``rank_main``."""
    rank_main(rank, world, group_backend, tmp, train_mesh_runs, spec, seed, tmp)


def train_mesh_phase(dev, seed: int, spec: dict = TRAIN_MESH, label: str = "train_mesh",
                     timeout_s: float = TRAIN_MESH_TIMEOUT_S) -> dict:
    """``Trainer`` on a (2, 2) ('data', 'model') mesh of 4 ranks against the
    one-rank ``Trainer`` on card 0 (same seed and batches, run first, in this
    process): one rank a card over NCCL on four cards, else 4 gloo ranks
    sharing the one card (their DTensor collectives staged through the
    host).  Per rank and variant: losses and their gap to the one-rank
    run's (gated by ``TRAIN_MESH_GATE``), step seconds, tokens/s, peak
    memory, K6 / K7 launches (checked per rank and equal across ranks).
    Returns rank 0's launches in the first variant."""
    import tempfile

    import torch

    from repro_torch.launch.mesh import make_host_mesh

    t0 = time.perf_counter()
    single = {}
    with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{label}_") as tmp:
        for variant in spec["variants"]:
            single[variant] = train_mesh_run(dev, make_host_mesh(), spec, variant, seed, tmp)
            torch.cuda.empty_cache()
    group_backend = "nccl" if torch.cuda.device_count() >= 4 else "gloo"
    reports = run_ranks(label, train_mesh_rank, 4, (group_backend, spec, seed), timeout_s)
    gaps, failures = {}, []
    for variant in spec["variants"]:
        want = single[variant]["losses"]
        gaps[variant] = [max(abs(rep[variant]["losses"][i] - want[i]) for rep in reports)
                         for i in range(len(want))]
        if max(gaps[variant]) > TRAIN_MESH_GATE[variant]:
            failures.append(f"{variant}: loss gaps {gaps[variant]} > {TRAIN_MESH_GATE[variant]}")
        if any(rep[variant]["launches"] != reports[0][variant]["launches"] for rep in reports):
            failures.append(f"{variant}: the ranks launched K6 / K7 unequally")
    cfg = train_mesh_config(spec["depth"], spec["variants"][0])
    emit(label, model=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
         param_dtype=cfg.param_dtype, seq=spec["seq"], global_batch=spec["batch"],
         steps=spec["steps"], optimizer=spec["opt"], init=spec.get("init", "as initialized"),
         world=4, group_backend=group_backend,
         mesh_shape=reports[0]["mesh_shape"], gate=TRAIN_MESH_GATE, loss_gaps_per_step=gaps,
         seconds=time.perf_counter() - t0, one_rank=single,
         ranks=[{k: v for k, v in rep.items() if k != "ok"} for rep in reports],
         cards=nvidia_smi_cards())
    if failures:
        raise AssertionError(f"{label}: " + "; ".join(failures))
    return reports[0][spec["variants"][0]]["launches"]


# ---------------------------------------------- the examples and the gates

EXAMPLE_KERNELS = {"cuda": ("reach_chunk_product", "build_merge_packed"),
                   "packed": ("packed_reach_chunk_product", "build_merge_packed"),
                   "sparse": ("sparse_reach_rows", "build_merge_packed")}
# regrep's 8 MiB run: the TRAFFIC pattern, e125's (the log is not a/b text)
# and one that cannot match (a log of only /x paths that all answer 200 ok)
REGREP_MISS = r"((GET|POST|PUT) /x* 200 ok\n)+"
# The line parts of the parse examples that differ by design, between the
# card and the CPU here and between the port and the JAX package's examples
# in tests/test_torch_examples.py: (pattern, placeholder, why).  Both compare
# every line after ``example_lines`` puts the placeholders in.
EXAMPLE_DESIGNED = [
    (r"backend=\w+", "backend=<b>",
     "backend names: jnp / torch / cuda / packed / sparse"),
    (r"'backend': '\w+'", "'backend': <b>", "the same, in a root span's attrs"),
    (r"\d+ compiled program", "<n> compiled program",
     "compile_count: the port counts the distinct shapes it ran"),
    (r" *-?\d+\.\d+ ms", " <t> ms", "timings (and their padding)"),
    (r"p99 targets met: \w+", "p99 targets met: <verdict>",
     "a latency verdict: the wall time of a batch against its 5 s target"),
    (r"\b[0-9a-f]{16}\b", "<trace_id>", "trace ids: random per request"),
    (r"^static .* \(flops / bytes\):$", "<static cost header>",
     "the JAX package reads XLA's HLO cost analysis, the port its modeled cost"),
    (r"^(  bucket \d+x\d+:) .* flops, .* bytes \(.*\)$", r"\1 <static cost>",
     "the same: the bucket keys are compared, not the costs"),
]


def example_lines(text: str) -> list:
    """``text``'s lines with ``EXAMPLE_DESIGNED``'s placeholders put in."""
    lines = []
    for line in text.splitlines():
        for pattern, placeholder, _ in EXAMPLE_DESIGNED:
            line = re.sub(pattern, placeholder, line)
        lines.append(line)
    return lines


def run_example(name: str, argv: list, folder: str = "examples"):
    """``<folder>/<name>.py``'s ``main(argv)`` in this process, its stdout
    captured, counted (``counted``): (exit code, stdout, seconds, nonzero
    launches by kernel)."""
    import importlib
    import io

    if str(ROOT / folder) not in sys.path:
        sys.path.insert(0, str(ROOT / folder))
    module = importlib.import_module(name)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc, seconds, n = counted(lambda: module.main(list(argv)))
    return rc, out.getvalue(), seconds, {k: v for k, v in n.items() if v}


def _need(label: str, launches: dict, kernels) -> None:
    missing = [k for k in kernels if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"examples {label}: {missing} never launched: {launches}")


def examples_phase(args, dev) -> None:
    """The nine ``examples/torch_*.py`` through ``main(argv)`` with ``--device
    cuda`` at their default sizes, each run counted and required to return
    0: the parse examples on ``cuda`` (K1 and K2 must launch) and
    batch_parse, stream_parse and edit_stream also on ``packed`` and
    ``sparse`` with ``--kernel`` (K4 or K5, and K2); each parse example's
    lines on ``cuda`` equal its ``--device cpu`` lines; regrep also over the
    8 MiB TRAFFIC log (written to a temporary file) with the TRAFFIC, e125
    and a non-matching pattern as one fleet, its TRAFFIC group matches
    against a solo ``cuda`` parse; sharded_parse on 2 ranks (each rank's
    launches from its line); constrained_serve (every output in L(e));
    train_lm ``--preset 100m`` at its default 30 steps (K6 in every step)."""
    import tempfile

    import torch

    from repro_torch import Parser, ParserConfig

    t_phase = time.perf_counter()
    runs = []

    def record(label, argv, rc, out, seconds, launches, **results):
        if rc != 0:
            raise AssertionError(f"examples {label} {argv}: exit code {rc}\n{out[-2000:]}")
        runs.append(label)
        emit("example", run=label, argv=argv, seconds=seconds, launches=launches, **results)

    # the six parse examples: each on the card against its CPU lines, and on
    # the word kernels where it takes a backend
    parse_runs = [("torch_quickstart", []), ("torch_traced_parse", []), ("torch_regrep", ["--demo"])]
    for name in ("torch_batch_parse", "torch_stream_parse", "torch_edit_stream"):
        parse_runs += [(name, []), (name, ["--backend", "packed", "--kernel"]),
                       (name, ["--backend", "sparse", "--kernel"])]
    for name, flags in parse_runs:
        rc, out, secs, n = run_example(name, [*flags, "--device", "cuda"])
        backend = flags[1] if flags[:1] == ["--backend"] else "cuda"
        _need(f"{name} {backend}", n, EXAMPLE_KERNELS[backend])
        cpu_flags = [f for f in flags if f not in ("--kernel",)]
        rc_cpu, out_cpu, _, _ = run_example(name, [*cpu_flags, "--device", "cpu"])
        same = example_lines(out) == example_lines(out_cpu) and rc_cpu == rc
        if not same:
            raise AssertionError(f"examples {name} {flags}: the card's lines != the CPU's\n"
                                 f"{out[-2000:]}\n--- cpu ---\n{out_cpu[-2000:]}")
        bits = re.findall(r"bit-identical=(\w+)", out)
        if bits and set(bits) != {"True"}:
            raise AssertionError(f"examples {name} {flags}: bit-identical flags {bits}")
        record(f"{name} {backend}" + (" --kernel" if "--kernel" in flags else ""), flags,
               rc, out, secs, n, lines_equal_cpu=True,
               trees=[int(next(x for x in m if x)) for m in re.findall(
                   r"trees=(\d+)|(\d+) syntax trees|(\d+) parse tree", out)],
               ok=[w == "True" for w in re.findall(r"ok=(\w+)", out)],
               bit_identical=len(bits))

    # regrep over the 8 MiB TRAFFIC log: three patterns in one fleet
    traffic = traffic_log(TRAFFIC_BYTES, args.seed)
    patterns = [TRAFFIC_RE, E125_RE, REGREP_MISS]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_regrep_") as tmp:
        path = Path(tmp) / "traffic.log"
        path.write_bytes(traffic)
        argv = [a for p in patterns for a in ("-e", p)] + [
            "--chunks", str(N_CHUNKS), str(path), "--device", "cuda"]
        rc, out, secs, n = run_example("torch_regrep", argv)
    _need("torch_regrep 8 MiB", n, EXAMPLE_KERNELS["cuda"])
    lines = out.splitlines()
    if "[p0] " not in out or "[p1] " + repr(E125_RE) + ": text does not match" not in out \
            or "[p2] " + repr(REGREP_MISS) + ": text does not match" not in out:
        raise AssertionError(f"regrep 8 MiB: verdicts wrong:\n{out[:2000]}")
    # the referee, timed by part: a solo parse, the tree count, the group
    # matches, their lines
    t0 = time.perf_counter()
    solo = Parser(ParserConfig(regex=TRAFFIC_RE, backend="cuda", n_chunks=N_CHUNKS), device=dev)
    want_r = solo.parse(traffic)
    t1 = time.perf_counter()
    trees = want_r.count_trees()
    t2 = time.perf_counter()
    spans = [(g, want_r.matches(g)) for g in solo.groups]
    t3 = time.perf_counter()
    want = [f"  group {g} [{a}:{b}] {traffic[a:b].decode(errors='replace')!r}"
            for g, matches in spans for a, b in matches]
    t4 = time.perf_counter()
    got = [line for line in lines if line.startswith("  group ")]
    if got != want or trees != 1 or "1 parse tree(s)" not in out:
        raise AssertionError("regrep 8 MiB: the TRAFFIC group matches != a solo cuda parse's")
    regrep = {"bytes": len(traffic), "patterns": len(patterns), "seconds": secs,
              "mb_per_s": len(traffic) / secs / 1e6,
              "pattern_mb_per_s": len(patterns) * len(traffic) / secs / 1e6,
              "match_lines": len(got),
              "solo_traffic_parse_s": t1 - t0, "count_trees_s": t2 - t1,
              "matches_s": t3 - t2, "match_lines_s": t4 - t3}
    record("torch_regrep 8 MiB TRAFFIC", argv[:-3] + ["<8 MiB log>"] + argv[-2:], rc, out,
           secs, n, fleet=lines[0], matched=["p0"], group_matches_equal_solo_parse=True,
           **{k: v for k, v in regrep.items() if k != "seconds"})
    del traffic, solo, want_r, spans, want, got, out, lines
    torch.cuda.empty_cache()

    # sharded: two ranks sharing the card (one a card over NCCL on 2+ cards)
    rc, out, secs, _ = run_example("torch_sharded_parse", ["--device", "cuda", "--ranks", "2"])
    rank_launches = [json.loads(line.split(": ", 1)[1]) for line in out.splitlines()
                     if line.startswith("rank ")]
    if len(rank_launches) != 2:
        raise AssertionError(f"sharded: {out}")
    for r, n in enumerate(rank_launches):
        _need(f"torch_sharded_parse rank {r}", n, EXAMPLE_KERNELS["cuda"])
    bits = re.findall(r"bit-identical=(\w+)", out)
    if bits != ["True"] * 6:
        raise AssertionError(f"sharded: bit-identical flags {bits}")
    record("torch_sharded_parse", ["--ranks", "2"], rc, out, secs, {}, group=out.split()[3],
           rank_launches=rank_launches, bit_identical=len(bits))

    # constrained serving: the prompt goes step by step through decode_step
    # (plain tensor code), so no kernel launches; every output in L(e)
    rc, out, secs, n = run_example("torch_constrained_serve", ["--device", "cuda"])
    m = re.search(r"(\d+)/(\d+) outputs in L\(e\)", out)
    if not m or m.group(1) != m.group(2) or "fullmatch=False" in out:
        raise AssertionError(f"constrained_serve: {out}")
    record("torch_constrained_serve", [], rc, out, secs, n,
           in_language=f"{m.group(1)}/{m.group(2)}",
           outputs=re.findall(r"^  ('.*?') +fullmatch", out, re.M))

    # training at the reference's deliverable scale
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_lm_") as tmp:
        argv = ["--preset", "100m", "--device", "cuda", "--workdir", tmp]
        rc, out, secs, n = run_example("torch_train_lm", argv)
        history = [json.loads(line) for line in
                   (Path(tmp) / "metrics.jsonl").read_text().splitlines()]
    _need("torch_train_lm", n, ("flash_attention",))
    # metrics.jsonl: the first step and every third (log_every = 30 // 10);
    # every sixth step (checkpoint_every = 30 // 5) also writes a checkpoint
    final = float(re.search(r"final loss: (\S+)", out).group(1))
    if history[-1]["step"] != 30 or not all(math.isfinite(h["loss"]) for h in history):
        raise AssertionError(f"train_lm: {history}")
    plain = [h["dt"] for h in history if h["step"] > 1 and h["step"] % 6]
    saving = [h["dt"] for h in history if h["step"] % 6 == 0]
    train = {"steps": history[-1]["step"], "final_loss": history[-1]["loss"],
             "first_step_s": history[0]["dt"], "step_s": plain, "checkpoint_step_s": saving,
             "tokens_per_step": 64 * 8, "tokens_per_s": 64 * 8 / statistics.median(plain),
             "k6_launches_per_step": n["flash_attention"] / 30}
    record("torch_train_lm --preset 100m", argv[:2], rc, out, secs, n, printed_final_loss=final,
           logged={h["step"]: h["loss"] for h in history}, **train)
    emit("examples_total", runs=len(runs), seconds=time.perf_counter() - t_phase,
         regrep_8mib=regrep, train_lm_100m=train)


def gates_phase() -> None:
    """``scripts/torch_obs_smoke.py`` and ``scripts/torch_analyze_gate.py``
    through ``main(["--device", "cuda"])``, counted: each must return 0; the
    checks each passed are printed."""
    t_phase = time.perf_counter()
    for name in ("torch_obs_smoke", "torch_analyze_gate"):
        rc, text, secs, n = run_example(name, ["--device", "cuda"], folder="scripts")
        if rc != 0:
            raise AssertionError(f"gate {name}: exit code {rc}\n{text[-3000:]}")
        emit("gate", gate=name, seconds=secs, exit_code=rc,
             checks=[line[4:] for line in text.splitlines() if line.startswith("ok: ")],
             last=text.splitlines()[-1], launches=n)
    emit("gates_total", seconds=time.perf_counter() - t_phase)


if __name__ == "__main__":
    sys.exit(main())
