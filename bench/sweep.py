#!/usr/bin/env python3
"""Find a tail cell's knee: its traffic at several fixed rates, one process.

    python3 bench/sweep.py --config e125 --traffic tail --seed <n> --seconds <s> --rates 500,1000

Set-up (pool, parser, warm-up) as in a run of a cell of that configuration and
tail mix; then, for each rate in turn, fresh sessions and one window of that
traffic at that rate.  One JSON line a rate: appends offered, p50 / p95 / max
latency, how long the queue took to drain after the last append was due, the
mean backlog in each quarter of the arrivals, the generator's lateness, steps
and pieces a step.  A rate the program sustains keeps its backlog flat; above
the knee the backlog, and the drain, grow through the window.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def sweep(cell, seed: int, seconds: float, rates, dev, t_process: float):
    """One record a rate (see the module's note), after one set-up."""
    import numpy as np
    import torch

    from bench import harness, textgen
    from bench.loops import release, sync, tail

    run = harness.Run(cell=cell, seed=seed, seconds=seconds, traced=False, device=dev,
                      t_process=t_process)
    parser, pool = tail.setup(run)
    S = int(cell.traffic["sessions"])
    yield {"setup_s": time.perf_counter() - t_process}
    for rate in rates:
        due, who, piece = textgen.poisson_schedule(rate, seconds, S, len(pool), seed,
                                                   int(cell.traffic["shape_seed"]))
        streams = [parser.open_stream() for _ in range(S)]
        sync(dev)
        d, _ = tail.drive(parser, streams, pool, due, who, piece, dev, False)
        lat = d.latency[np.isfinite(d.latency)]
        pieces = sum(p for _, p, _ in d.steps)
        # the mean backlog in each quarter of the arrivals: growing where the
        # rate is past what the program sustains
        q = np.array(d.queue) if d.queue else np.zeros((1, 2))
        edges = np.linspace(0, float(due[-1]), 5)
        quarters = [float(q[(q[:, 0] >= a) & (q[:, 0] < b), 1].mean())
                    if ((q[:, 0] >= a) & (q[:, 0] < b)).any() else 0.0
                    for a, b in zip(edges[:-1], edges[1:])]
        yield {
            "rate": rate, "appends": len(due), "done": int(lat.size), "failed": d.failed,
            "offered_mb_s": rate * len(pool[0]) / 1e6,
            "p50_ms": float(np.percentile(lat, 50)) * 1e3, "p95_ms": float(np.percentile(lat, 95)) * 1e3,
            "max_ms": float(lat.max()) * 1e3, "drain_s": d.window_s - float(due[-1]),
            "late_p95_ms": float(np.percentile(d.late, 95)) * 1e3,
            "steps": len(d.steps), "pieces_per_step": pieces / max(1, d.batches),
            "step_ms": 1e3 * float(np.mean([w for w, _, _ in d.steps])) if d.steps else 0.0,
            "backlog_by_quarter": quarters,
            "memory_peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0}
        for st in streams:
            st.close()
        del streams
        release(dev)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True, help="a configuration's file in bench/configs/")
    ap.add_argument("--traffic", required=True, help="a tail mix of bench/traffic/")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True, help="appends a second, comma-separated")
    args = ap.parse_args()
    import torch

    from bench import harness

    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.make_cell(manifest, f"{args.config}.{args.traffic}",
                             harness.BENCH / "configs" / f"{args.config}.json", args.traffic, 1, {})
    dev = torch.device("cuda", 0)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    for record in sweep(cell, args.seed, args.seconds, [float(r) for r in args.rates.split(",")],
                        dev, T_PROCESS):
        print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
    sys.exit(main())
