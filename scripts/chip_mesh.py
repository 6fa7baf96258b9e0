#!/usr/bin/env python3
"""Run one of ``chip_smoke.py``'s multi-rank phases alone, on the cards of
this machine.

    python3 scripts/chip_mesh.py [--phase mesh|train] [--seed 0]

``--phase mesh`` (the default): the parser's mesh route.  On a machine with
two cards or more it runs one rank a card over NCCL (up to 4, a (2, 2)
('pod', 'data') mesh on four); on one card, two ranks share it in a gloo
group.

``--phase train``: zamba2-2.7b at full width and full depth (54 layers, 9
shared-block applications, bf16 params) trained for ``TRAIN_STEPS`` steps
of 4 x 2048 tokens by the ``Trainer`` on a (2, 2) ('data', 'model') mesh of
4 ranks (one a card over NCCL on four cards: dp 2, so accum 2 x microbatch
2), after the one-rank ``Trainer`` on card 0 with the same seed and batches
(accum 4 x microbatch 1); every rank also profiles one more step.  Prints
the ``train_mesh_full`` line: per rank the losses, step seconds, tokens/s,
peak memory, idle share and K6 / K7 launches, and each step's largest loss
gap to the one-rank run, gated at 2e-2 in bf16; then the same pair in f32
compute over the bf16 params, gated at 1e-4.  ``--unit-attention`` runs
both from the same weights with unit-scale attention logits (the shared
block's wq and wk scaled by sqrt(heads / d_model), ``chip_smoke.py``'s
``_unit_scale_attention``): the line is then ``train_mesh_full_unit``.

It builds the kernels first (one ``nvcc`` per source), then prints the
``nvidia-smi`` line of every card, the phase's line and the seconds it
took; it exits non-zero if any rank fails or hangs, or a gate fails.  The
timing and the checks are ``chip_smoke.py``'s own.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TRAIN_STEPS = 3
TRAIN_TIMEOUT_S = 900


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", choices=("mesh", "train"), default="mesh")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--unit-attention", action="store_true",
                    help="--phase train from weights with unit-scale attention logits")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_mesh: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke
    from repro_torch.kernels import ops

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    print(json.dumps({"phase": "env", "torch": torch.__version__, "cards": smi.splitlines()}),
          flush=True)
    t0 = time.perf_counter()
    ops.build()
    print(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0}), flush=True)
    t0 = time.perf_counter()
    if args.phase == "mesh":
        chip_smoke.mesh_phase(args)
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        spec = dict(depth=54, seq=2048, batch=4, steps=TRAIN_STEPS, opt="warmup",
                    profile=True, variants=("bfloat16", "float32"))
        label = "train_mesh_full"
        if args.unit_attention:
            spec["init"] = "unit_scale_attention"
            label += "_unit"
        chip_smoke.train_mesh_phase(torch.device("cuda", 0), args.seed, spec,
                                    label=label, timeout_s=TRAIN_TIMEOUT_S)
    print(json.dumps({"phase": f"{args.phase}_total", "seconds": time.perf_counter() - t0}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
