#!/usr/bin/env python3
"""Run one cell of the port's benchmark on this machine's CUDA device(s).

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  ``BENCHMARK.json`` names the cells; the program
under test is ``src/repro_torch``.  The last line of standard output is the
result (``bench/harness.py``).  Exits non-zero, with no result, where the cell's
device count is not there, the program is missing, or the process loaded JAX
or the JAX package.
"""

import time

T_PROCESS = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root (for ``bench``) and ``src`` (for ``repro_torch``), in
# place of this script's own folder, whose module names must not shadow others
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_PROCESS))
