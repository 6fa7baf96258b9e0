"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of the parser.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
from the root of a checkout; ``BENCHMARK.json`` at that root names the cells.
"""
