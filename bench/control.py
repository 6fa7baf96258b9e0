#!/usr/bin/env python3
"""The control's readings at a cell's own size: the reference with a guarantee broken.

    python3 bench/control.py --workload e125.scan --seeds 1,2,3 [--seconds 20]

The control is the reference's forward columns alone, in place of the
program's clean forest: the answer of a parser that skipped the backward half.
For each seed it makes the texts a run of the cell compares (a scan's
distinct texts; a tail's sampled sessions' whole texts, every append of the
window absorbed) and prints ``columns_differing`` of the control against the
clean reference, which a run compares with the limit 0.  The benchmark's own
runs never run this.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[0:1] = [str(ROOT)]


def control_texts(cell, seed: int, seconds: float):
    from bench import textgen

    spec, mix = cell.config["text"], cell.traffic
    if mix["kind"] == "scan":
        return textgen.texts(spec, int(cell.params["text_bytes"]), int(mix["texts"]), seed, purpose=1)
    pool = textgen.texts(spec, int(mix["piece_bytes"]), int(mix["pool_pieces"]), seed, purpose=2)
    S = int(mix["sessions"])
    _, who, piece = textgen.poisson_schedule(float(cell.params["rate_appends_per_s"]), seconds, S,
                                             len(pool), seed,
                                             int(mix["shape_seed"]))
    sample = textgen.sessions_checked(seed, S, int(mix["check_sessions"]))
    return [b"".join(pool[p] for w, p in zip(who, piece) if w == s) for s in sample]


def readings(cell, seed: int, seconds: float, device) -> dict:
    from bench.reference import forest as ref

    aut = ref.automaton(cell.config["pattern"])
    bits = 0
    for text in control_texts(cell, seed, seconds):
        want = ref.forest(aut, text, device)
        bits += ref.differing_bits(ref.forest(aut, text, device, clean=False).cpu().numpy(), want)
    return {"columns_differing": bits}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None, help="a tail's window (default run_seconds)")
    args = ap.parse_args()
    import torch

    from bench import harness

    cell = harness.load_cell(args.workload)
    seconds = args.seconds or json.loads((ROOT / "BENCHMARK.json").read_text())["run_seconds"]
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": cell.name, "seed": seed, "device": str(device),
                          **readings(cell, seed, seconds, device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
