#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s ``mesh`` phase alone, on the cards of this machine.

    python3 scripts/chip_mesh.py [--seed 0]

On a machine with two cards or more it runs one rank a card over NCCL (up
to 4, a (2, 2) ('pod', 'data') mesh on four); on one card, two ranks share
it in a gloo group.  It builds the kernels first (one ``nvcc`` per source),
then prints the ``nvidia-smi`` line of every card, the phase's ``mesh``
line and the seconds it took; it exits non-zero if any rank fails or hangs.
The timing and the checks are ``chip_smoke.py``'s own.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
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
    chip_smoke.mesh_phase(args)
    print(json.dumps({"phase": "mesh_total", "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
