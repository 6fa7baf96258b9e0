"""The per-layer metrics read from the program's own spans: ``plan_ms`` and
``d2h_ms`` in the scans.

Each reader is the mean of one span's durations in the window, and nothing
where the program has no such span (the harness then leaves the metric out).
A traced run of each scan cell, cut to CPU size, carries its new metrics; an
untraced run of every cell carries its end-to-end metrics and nothing else.
"""

import json
from types import SimpleNamespace

import _small
import pytest

from bench import harness

READS = {"plan_ms": "parse.plan", "d2h_ms": "phase.d2h"}
CELL_METRICS = {"traffic.scan": {"plan_ms", "d2h_ms"}, "e125.scan": {"plan_ms", "d2h_ms"}}


@pytest.mark.parametrize("metric", sorted(READS))
def test_reader_is_the_mean_of_its_span(metric):
    read = harness.reader(metric)
    spans = [{"name": READS[metric], "duration_s": d} for d in (0.001, 0.003)]
    spans.append({"name": "parse.request", "duration_s": 1.0})
    assert read(SimpleNamespace(spans=spans)) == pytest.approx(2.0)
    assert read(SimpleNamespace(spans=spans[2:])) is None


def test_manifest_reads_each_new_metric_in_its_cells():
    manifest = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    per_layer = {m["name"]: m for m in manifest["per_layer"]}
    for name, cells in CELL_METRICS.items():
        for metric in cells:
            assert name in per_layer[metric]["workloads"]
            assert per_layer[metric]["source"] == "program_span"


@pytest.mark.parametrize("name", sorted(CELL_METRICS))
def test_traced_line_carries_the_span_metrics(name):
    line = _small.run_on_cpu(name, seed=2**33 + 7, traced=True)
    assert line["correct"], line["checks"]
    assert CELL_METRICS[name] <= set(line["metrics"]), line["metrics"]
    assert all(line["metrics"][m]["value"] > 0 for m in CELL_METRICS[name])


@pytest.mark.parametrize("name", _small.CELLS)
def test_untraced_line_carries_only_end_to_end_metrics(name):
    line = _small.run_on_cpu(name, seed=2**33 + 11)
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {m["name"] for m in harness.load_cell(name).e2e}
