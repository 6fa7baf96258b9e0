"""Closed-loop scans: one caller parses whole texts back to back.

Set-up makes the mix's ``texts`` distinct texts of the cell's ``text_bytes``
from the seed and warms the program up with one parse.  The window parses the
texts in turn through ``Parser.parse`` until a parse ends ``--seconds`` or
more after the first began; the window is that span, and
``parse_throughput`` is the bytes of every parse in it over its seconds.
Nothing else runs on the host in the window.

Every parse's verdict is kept; so is the whole result of the first parse of
each text and of a uniform sample of the others, the mix's ``check_sample`` of
them drawn from the seed over the whole window (a reservoir: the ``i``-th
parse takes a slot with chance ``check_sample / i``), the rest being dropped
as a caller would.  After the window each
kept result is held against the reference's clean forest of its text, every
column bit, and every verdict against the reference's.
The traced run builds the parser with the program's own tracing on, which
parses through its phase-split route with a span a phase, and reads those
spans from the program's JSONL span log.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

from .. import textgen
from ..devtrace import Window, annotate
from ..harness import Check
from ..reference import forest as ref
from . import build_parser, memory_peak, release, sync


def run(run) -> None:
    cell, dev = run.cell, run.device
    cfg = cell.config
    texts = textgen.texts(cfg["text"], int(cell.params["text_bytes"]), int(cell.traffic["texts"]),
                          run.seed, purpose=1)
    with tempfile.TemporaryDirectory() as tmp:
        obs = None
        span_log = os.path.join(tmp, "spans.jsonl")
        if run.traced:
            from repro_torch import ObsConfig

            obs = ObsConfig(enabled=True, span_log=span_log, profiler=True, max_spans=1 << 16)
        parser = build_parser(cfg, dev, obs)
        t = parser.engine.tables
        run.tables = {"ell": int(t.ell), "lp": int(t.ell_pad), "n_tables": int(t.N.shape[0])}
        parser.parse(texts[0])
        sync(dev)
        run.setup_done()

        size = int(cell.traffic["check_sample"])
        draws = textgen.rng(run.seed, 5).random(1 << 20)
        first, sample = [], []                      # kept results: (text, result)
        verdicts_seen = []
        failures = 0
        with Window(run.traced) as window:
            t0 = time.perf_counter()
            i, last = 0, t0
            while True:
                j = i % len(texts)
                try:
                    with annotate("bench.parse"):
                        r = parser.parse(texts[j])
                except Exception as e:                      # a parse that fails is counted
                    failures += 1
                    run.notes.setdefault("first_failure", repr(e))
                    r = None
                now = time.perf_counter()
                if r is not None:
                    run.parses.append((now - last, len(texts[j]), tuple(r.bucket)))
                    verdicts_seen.append((j, r.ok))
                    if i < len(texts):
                        first.append((j, r))
                    elif len(sample) < size:
                        sample.append((j, r))
                    else:
                        slot = int(draws[i % len(draws)] * (i - len(texts) + 1))
                        if slot < size:
                            sample[slot] = (j, r)
                del r
                last = now
                i += 1
                if now - t0 >= run.seconds:
                    break
        window_s = last - t0
        run.window_closed()
        run.trace = window.summary()
        run.attempted, run.failed = i, failures
        run.e2e["parse_throughput"] = sum(len(texts[j]) for j, _ in verdicts_seen) / window_s / 1e6
        run.memory_peak_bytes = memory_peak(dev)
        if run.traced:
            parser.obs.close()
            with open(span_log) as f:
                spans = [json.loads(line) for line in f]
            run.spans = [s for s in spans if t0 <= s["t_start_s"] <= last]
        del parser
        release(dev)

    aut = ref.automaton(cfg["pattern"])
    want = {j: ref.forest(aut, texts[j], dev) for j in sorted({j for j, _ in verdicts_seen})}
    kept = first + sample
    bits = sum(ref.differing_bits(r.forest.columns, want[j]) for j, r in kept)
    verdicts = sum(int(ok != ref.accepted(want[j])) for j, ok in verdicts_seen)
    run.checks["columns_differing"] = Check(bits, 0)
    run.checks["verdicts_wrong"] = Check(verdicts, 0)
    run.checks["parses_failed"] = Check(failures, 0)
    run.notes["scan"] = {"parses": i, "window_s": window_s, "texts": len(texts),
                         "compared": len(kept),
                         "bytes": [len(x) for x in texts],
                         "parse_ms": [round(w * 1e3, 3) for w, _, _ in run.parses]}

