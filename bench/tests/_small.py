"""Cells cut to sizes the CPU can run in seconds, for the tests that drive the
harness on the CPU (the ``cuda`` backend's kernels run their plain versions)."""

import json

import _paths  # noqa: F401

from bench import harness

SMALL = {
    "scan": {"params": {"text_bytes": 4096}, "parser": {"n_chunks": 8}},
    "tail": {"params": {"rate_appends_per_s": 40.0},
             "traffic": {"piece_bytes": 1024, "sessions": 8, "pool_pieces": 4, "check_sessions": 2},
             "parser": {"first_seal_len": 1024, "max_seal_len": 1024, "max_batch": 8}},
}
SECONDS = 0.6
# the cells BENCHMARK.json declares
CELLS = tuple(w["name"] for w in json.loads((harness.ROOT / "BENCHMARK.json").read_text())["workloads"])


def small_cell(name: str) -> harness.Cell:
    """The declared cell ``name`` (its files and metrics) cut to CPU size."""
    cell = harness.load_cell(name)
    over = SMALL[cell.traffic["kind"]]
    cell.params.update(over.get("params", {}))
    cell.traffic.update(over.get("traffic", {}))
    cell.config["parser"].update(over.get("parser", {}))
    return cell


def run_on_cpu(name: str, seed: int = 12345, traced: bool = False) -> dict:
    import time

    import torch
    from repro_torch.core import backend

    saved = backend.CudaBackend.needs_cuda
    backend.CudaBackend.needs_cuda = False
    try:
        run = harness.run_cell(small_cell(name), seed, SECONDS, traced, torch.device("cpu"),
                               time.perf_counter())
    finally:
        backend.CudaBackend.needs_cuda = saved
    return harness.result_line(run, {"platform": "cpu", "kind": "cpu", "count": 1})

