"""The harness: one cell of ``BENCHMARK.json``, run and reported.

A cell is found by name in the manifest; everything that belongs to it sits in
files of its own, found by name:

  ``BENCHMARK.json``          the cell's configuration, traffic and chips; the
                              metrics, each with the cells it is read in;
  ``bench/cells/<cell>.json`` the cell's own parameters (text size, rate);
  ``<configuration file>``    the deployment: pattern, parser settings, grammar;
  ``bench/traffic/<mix>.json`` the traffic mix; its ``kind`` names the loop
                              (``bench/loops/<kind>.py``) that drives it;
  ``bench/grammars/<name>.py`` the text grammar a configuration names;
  ``bench/metrics/<metric>.py`` the reader of one per-layer metric (or of
                              every metric ``<metric>.<kind>``).

A loop makes its inputs from the seed, builds the program, warms it up, runs
the window, reads the device's memory peak, frees the program, and checks what
the window produced against the reference.  It fills a ``Run``; the harness
turns that into the result line.  With ``--trace 1`` the loop runs its window
under ``devtrace.Window`` and the line carries the cell's per-layer metrics,
``busy_s``, ``window_s`` and a ``breakdown``; with ``--trace 0`` its
end-to-end metrics.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, (``breakdown``), and last
``checks``: each number compared with its limit, also printed as the last
lines of standard error.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
# top-level modules that must not be loaded in the measured process: the JAX
# reference package and JAX itself (compared by whole top-level name, so
# ``repro_torch`` is not ``repro``)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


@dataclass
class Cell:
    name: str
    chips: int
    config: dict            # the configuration file's object
    traffic: dict           # the traffic mix's object
    params: dict            # bench/cells/<cell>.json
    e2e: List[dict]         # the manifest's end-to-end metrics this cell reports
    per_layer: List[dict]   # the manifest's per-layer metrics read in this cell


def load_cell(name: str, root: Path = ROOT) -> Cell:
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in manifest["workloads"]}
    if name not in work:
        raise SystemExit(f"bench: no workload {name!r} in BENCHMARK.json (have {sorted(work)})")
    w = work[name]
    params = json.loads((BENCH / "cells" / f"{name}.json").read_text())
    config_file = root / {c["name"]: c for c in manifest["configs"]}[w["config"]]["file"]
    return make_cell(manifest, name, config_file, w["traffic"], int(w["chips"]), params)


def make_cell(manifest: dict, name: str, config_file: Path, traffic: str, chips: int,
              params: dict) -> Cell:
    """A cell of the configuration in ``config_file`` under the mix ``traffic``;
    ``name`` selects the manifest's metrics whose ``workloads`` list it."""
    config_obj = json.loads(Path(config_file).read_text())
    mix = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())
    e2e = [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in moved else [])]
    return Cell(name, chips, config_obj, mix, params, e2e, per_layer)


@dataclass
class Check:
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Run:
    """What a loop hands back: its numbers, and what the readers read."""

    cell: Cell
    seed: int
    seconds: float
    traced: bool
    device: Any
    t_process: float                        # perf_counter at process start
    setup_s: Optional[float] = None
    attempted: int = 0
    failed: int = 0
    e2e: Dict[str, float] = field(default_factory=dict)
    checks: Dict[str, Check] = field(default_factory=dict)
    memory_peak_bytes: int = 0
    trace: Any = None                       # devtrace.Summary (traced runs)
    spans: List[dict] = field(default_factory=list)
    # what the readers of per-layer metrics take
    tables: Dict[str, int] = field(default_factory=dict)   # ell, lp, n_tables
    parses: List[Tuple[float, int, Tuple[int, int]]] = field(default_factory=list)  # (wall s, n, (C, k))
    steps: List[Tuple[float, int, int]] = field(default_factory=list)  # (wall s, pieces, chars)
    appends: List[Tuple[float, int]] = field(default_factory=list)     # (latency s, chars)
    counters: Dict[str, float] = field(default_factory=dict)
    notes: Dict[str, Any] = field(default_factory=dict)
    t_closed: Optional[float] = None

    def setup_done(self) -> None:
        """Set-up ends here: the first timed call follows."""
        self.setup_s = time.perf_counter() - self.t_process

    def window_closed(self) -> None:
        """The window has closed: what follows is the check."""
        self.t_closed = time.perf_counter()


def reader(metric: str) -> Callable[[Run], Optional[float]]:
    """``bench/metrics/<metric>.py``'s ``read``; where there is no such file, that
    of the metric's name up to its first dot (``device_idle`` reads
    ``device_idle.scan`` and ``device_idle.tail``)."""
    path = BENCH / "metrics" / f"{metric}.py"
    if not path.exists():
        path = BENCH / "metrics" / f"{metric.split('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device, t_process: float) -> Run:
    run = Run(cell=cell, seed=seed, seconds=seconds, traced=traced, device=device,
              t_process=t_process)
    loop = importlib.import_module(f"bench.loops.{cell.traffic['kind']}")
    loop.run(run)
    if run.t_closed is not None:
        run.notes["seconds"] = {"setup": run.setup_s, "check": time.perf_counter() - run.t_closed}
    return run


def result_line(run: Run, device_info: dict) -> dict:
    cell = run.cell
    metrics: Dict[str, dict] = {}
    if run.traced:
        for m in cell.per_layer:
            value = reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(run.e2e, setup_s=run.setup_s)
        for m in cell.e2e:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    device = dict(device_info, memory_peak_bytes=int(run.memory_peak_bytes))
    line = {"correct": all(c.ok for c in run.checks.values()) and bool(run.checks),
            "attempted": run.attempted, "failed": run.failed, "metrics": metrics,
            "device": device}
    if run.traced and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        line["breakdown"] = {"device_ops": [list(x) for x in run.trace.device_ops],
                             "idle_gaps": [list(x) for x in run.trace.idle_gaps]}
    line["checks"] = {k: {"value": c.value, "limit": c.limit} for k, c in run.checks.items()}
    return line


def main(argv: List[str], t_process: float) -> int:
    ap = argparse.ArgumentParser(prog="bench/run.py", description="Run one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: {cell.name} needs {cell.chips} CUDA device(s), found {have}", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "__init__.py").exists():
        print("bench: src/repro_torch, the program under test, is not in this checkout",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips}
    run = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, t_process)
    found = forbidden_modules()
    if found:
        print(f"bench: the measured process loaded {found}", file=sys.stderr)
        return 3
    line = result_line(run, info)
    for key, value in run.notes.items():
        print(json.dumps({key: value}), flush=True)
    for name, c in run.checks.items():
        print(f"check {name} {c.value} limit {c.limit}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
