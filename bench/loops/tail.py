"""Open-loop tails: many live streams, each growing by pieces of its own log.

Set-up makes a pool of the mix's ``pool_pieces`` texts of ``piece_bytes`` each
from the seed, and the schedule of the window's appends at the cell's
``rate_appends_per_s`` (``textgen.poisson_schedule``): a due time, a session
and a pool piece each, the times and their sessions' pattern the same for
every seed (the mix's ``shape_seed``), the sessions relabelled and the pieces
drawn by the seed.  It opens ``sessions`` streams through
``Parser.open_stream()`` and warms the stream service up on other sessions
with one batched step of every power-of-two batch up to ``max_batch``.

The window (``drive``) enqueues each append when it is due and, whenever
appends are queued, runs one ``StreamService.step`` and waits for the device.
An append is done when its stream's length has reached its end; its latency
runs from when it was due to the end of the step that absorbed its last piece.
Appends still queued when the last one is due are drained in the window, and
their whole latency counts.  ``append_p95`` is the 95th percentile over all
of them (numpy's linear interpolation); an append the program refused counts
as failed, and it and any append never done count with the wait they had when
the window closed.

After the window, every session's acceptance state and, for sessions drawn
from the seed, the forest of its whole text, are held against the reference
run over the same concatenated text.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import List

import numpy as np

from .. import textgen
from ..counts import next_pow2
from ..devtrace import Window, annotate
from ..harness import Check
from ..reference import forest as ref
from . import build_parser, memory_peak, release, sync


@dataclass
class Drive:
    """One window's record."""

    latency: np.ndarray          # s, one an append (nan: never done, inf: refused)
    late: np.ndarray             # s an append was enqueued after it was due
    steps: list                  # (wall s, pieces, chars) a step
    failed: int
    window_s: float
    batches: int                 # the service's batches run in the window
    queue: list                  # (s from the window's start, appends queued) after each step


def setup(run):
    cell, dev = run.cell, run.device
    cfg, mix = cell.config, cell.traffic
    pool = textgen.texts(cfg["text"], int(mix["piece_bytes"]), int(mix["pool_pieces"]),
                         run.seed, purpose=2)
    parser = build_parser(cfg, dev)
    t = parser.engine.tables
    k = next_pow2(max(parser.engine.min_chunk_len, int(mix["piece_bytes"])))
    run.tables = {"ell": int(t.ell), "lp": int(t.ell_pad), "n_tables": int(t.N.shape[0]), "k": k}
    warm = [parser.open_stream() for _ in range(min(int(mix["sessions"]), parser.config.max_batch))]
    b = 1
    while b <= len(warm):
        for i, s in enumerate(warm[:b]):
            s.append(pool[(b + i) % len(pool)])
        while parser.stream_service.step():
            pass
        sync(dev)
        b *= 2
    for s in warm:
        s.close()
    return parser, pool


def drive(parser, streams, pool: List[bytes], due, who, piece, dev, traced: bool):
    svc = parser.stream_service
    S, N = len(streams), len(due)
    expected = [0] * S
    outstanding = [deque() for _ in range(S)]
    latency = np.full(N, np.nan)
    late = np.zeros(N)
    steps, queue = [], []
    failed = queued = 0
    batches0 = svc.stats["batches_run"]
    with Window(traced) as window:
        t0 = time.perf_counter()
        j = 0
        while True:
            now = time.perf_counter()
            if j < N and t0 + due[j] <= now:
                with annotate("bench.enqueue"):
                    while j < N and t0 + due[j] <= now:
                        s, text = who[j], pool[piece[j]]
                        try:
                            streams[s].append(text)
                        except Exception:                   # a refused append is counted
                            failed += 1
                            latency[j] = np.inf
                        else:
                            late[j] = time.perf_counter() - (t0 + due[j])
                            expected[s] += len(text)
                            outstanding[s].append((expected[s], j))
                            queued += 1
                        j += 1
            if queued:
                ts = time.perf_counter()
                with annotate("bench.step"):
                    busy = svc.step()
                with annotate("bench.sync"):
                    sync(dev)
                te = time.perf_counter()
                if not busy:
                    # nothing is queued in the service, yet appends are not in
                    # their streams: they were lost, and stay unserved
                    for q in outstanding:
                        q.clear()
                    queued = 0
                    continue
                pieces = chars = 0
                for s in range(S):
                    q = outstanding[s]
                    if q and q[0][0] <= streams[s].n:
                        n = streams[s].n
                        while q and q[0][0] <= n:
                            _, jj = q.popleft()
                            latency[jj] = te - (t0 + due[jj])
                            pieces += 1
                            chars += len(pool[piece[jj]])
                queued -= pieces
                steps.append((te - ts, pieces, chars))
                queue.append((te - t0, queued))
            elif j < N:
                wait = t0 + due[j] - time.perf_counter()
                if wait > 0:
                    with annotate("bench.wait"):
                        time.sleep(wait)
            else:
                break
        window_s = time.perf_counter() - t0
    run_trace = window.summary()
    return Drive(latency, late, steps, failed, window_s,
                 svc.stats["batches_run"] - batches0, queue), run_trace


def run(run) -> None:
    cell, dev = run.cell, run.device
    mix = cell.traffic
    parser, pool = setup(run)
    S = int(mix["sessions"])
    due, who, piece = textgen.poisson_schedule(float(cell.params["rate_appends_per_s"]), run.seconds,
                                               S, len(pool), run.seed, int(mix["shape_seed"]))
    streams = [parser.open_stream() for _ in range(S)]
    sync(dev)
    run.setup_done()

    d, run.trace = drive(parser, streams, pool, due, who, piece, dev, run.traced)
    run.window_closed()
    run.memory_peak_bytes = memory_peak(dev)
    run.attempted, run.failed = len(due), d.failed
    done = np.isfinite(d.latency)
    # an append never done, or refused, counts with the wait it had when the
    # window closed: finite, and above every append that was done
    lat = np.where(done, d.latency, d.window_s - due)
    run.e2e["append_p95"] = float(np.percentile(lat, 95)) * 1e3
    run.steps = d.steps
    run.appends = [(float(d.latency[j]), len(pool[piece[j]])) for j in np.flatnonzero(done)]
    run.counters = {"pieces": float(sum(p for _, p, _ in d.steps)), "batches_run": float(d.batches)}
    run.notes["generator_late_ms"] = {
        "p50": float(np.percentile(d.late, 50)) * 1e3, "p95": float(np.percentile(d.late, 95)) * 1e3,
        "max": float(d.late.max()) * 1e3, "appends": len(due), "window_s": d.window_s}

    # the program's answers, then the program freed
    sample = textgen.sessions_checked(run.seed, S, int(mix["check_sessions"]))
    marks = [time.perf_counter()]
    accepted = [st.accepted for st in streams]
    marks.append(time.perf_counter())
    columns = {s: streams[s].result().forest.columns for s in sample}
    marks.append(time.perf_counter())
    lengths = [st.n for st in streams]
    for st in streams:
        st.close()
    del parser, streams
    release(dev)

    marks.append(time.perf_counter())
    aut = ref.automaton(cell.config["pattern"])
    transfers = ref.piece_transfers(aut, pool, dev)
    marks.append(time.perf_counter())
    order = [[] for _ in range(S)]
    for j in range(len(due)):
        if not np.isinf(d.latency[j]):
            order[who[j]].append(int(piece[j]))
    wrong = sum(int(accepted[s] != ref.accepted_through(aut, [transfers[p] for p in order[s]]))
                for s in range(S))
    missing = sum(abs(lengths[s] - sum(len(pool[p]) for p in order[s])) for s in range(S))
    bits = 0
    for s in sample:
        want = ref.forest(aut, b"".join(pool[p] for p in order[s]), dev)
        bits += ref.differing_bits(columns.pop(s), want)
        del want
    marks.append(time.perf_counter())
    run.notes["check_s"] = dict(zip(("accepted", "result", "free", "transfers", "forests"),
                                    np.diff(marks).round(3).tolist()))
    run.checks["columns_differing"] = Check(bits, 0)
    run.checks["verdicts_wrong"] = Check(wrong, 0)
    run.checks["chars_missing"] = Check(missing, 0)
    run.checks["appends_unserved"] = Check(int(np.isnan(d.latency).sum()), 0)
    run.checks["appends_failed"] = Check(d.failed, 0)
