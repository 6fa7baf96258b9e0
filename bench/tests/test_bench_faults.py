"""``correct`` on the CPU: true for the program as it is, false for the control
and for each fault a cell can have.

Each test drives the rest of a run (set-up, window, checks) of a cell cut to
CPU size, without the look for a card; the ``cuda`` backend's kernels run
their plain versions.  The faults are planted in the program for the test's
duration: the control in the program's place, a produced answer altered, a
step that leaves a stream's state unchanged, half of a step's batch left out.
"""

import _small
import pytest
import torch

from bench import control

CELLS = _small.CELLS


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    line = _small.run_on_cpu(name)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    e2e = "parse_throughput" if name.endswith("scan") else "append_p95"
    assert set(line["metrics"]) == {e2e, "setup_s"}


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_its_metrics(name):
    line = _small.run_on_cpu(name, seed=2**35 + 1, traced=True)
    assert line["correct"], line["checks"]
    # kernel shares need a device trace; the rest is read on the CPU too
    want = ({"host_build_ms", "reach_ms", "join_ms", "build_merge_ms", "device_idle.scan", "parse_mfu"}
            if name.endswith("scan") else
            {"stream_step_ms", "pieces_per_step", "device_idle.tail", "append_mfu"})
    assert want <= set(line["metrics"]), line["metrics"]
    assert line["device"]["window_s"] > 0 and "breakdown" in line


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    """The control (the reference's forward columns in the program's place)
    reads above the limit 0 on three seeds."""
    cell = _small.small_cell(name)
    for seed in (1, 2, 3):
        assert control.readings(cell, seed, _small.SECONDS, torch.device("cpu"))["columns_differing"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_control_in_the_programs_place_fails(name, monkeypatch):
    """A run whose program hands back the control (the reference's forward
    columns of the text each result is of, in place of its clean forest) is
    not correct: the harness's own checks catch it."""
    import dataclasses

    from repro_torch import Parser, ParserStream

    from bench.reference import forest as ref

    cell = _small.small_cell(name)
    aut = ref.automaton(cell.config["pattern"])
    byte_of = {}
    for b in range(256):
        byte_of.setdefault(int(aut.byte_to_class[b]), b)
    swapped = []

    def control(result):
        text = bytes(byte_of[int(c)] for c in result.forest.classes)
        assert (aut.classes(text) == result.forest.classes).all()
        cols = ref.forest(aut, text, torch.device("cpu"), clean=False).numpy()
        swapped.append(1)
        return dataclasses.replace(result, forest=dataclasses.replace(result.forest, columns=cols))

    if name.endswith("scan"):
        parse = Parser.parse
        monkeypatch.setattr(Parser, "parse", lambda self, text, **kw: control(parse(self, text, **kw)))
    else:
        result = ParserStream.result
        monkeypatch.setattr(ParserStream, "result", lambda self: control(result(self)))
    line = _small.run_on_cpu(name)
    assert swapped
    assert not line["correct"]
    assert line["checks"]["columns_differing"]["value"] > 0


def flip_one_bit(unpack):
    def flipped(packed, ell):
        cols = unpack(packed, ell)
        cols[len(cols) // 2, 0] ^= True
        return cols
    return flipped


@pytest.mark.parametrize("name", CELLS)
def test_altered_answer_fails(name, monkeypatch):
    import repro_torch.core.engine as engine
    import repro_torch.core.stream as stream

    mod = engine if name.endswith("scan") else stream
    monkeypatch.setattr(mod, "unpack_columns", flip_one_bit(mod.unpack_columns))
    line = _small.run_on_cpu(name)
    assert not line["correct"]
    assert line["checks"]["columns_differing"]["value"] > 0


@pytest.mark.parametrize("name", [c for c in CELLS if c.endswith(".tail")])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_stream_faults_fail(name, fault, monkeypatch):
    from repro_torch.core.stream import StreamingParser

    absorb = StreamingParser.absorb_product
    calls = []

    def faulty(self, piece, product):
        calls.append(1)
        if fault == "half_batch" and len(calls) % 2:
            return absorb(self, piece, product)
        return None                                  # the piece is dropped

    monkeypatch.setattr(StreamingParser, "absorb_product", faulty)
    line = _small.run_on_cpu(name)
    assert not line["correct"]
    assert line["checks"]["appends_unserved"]["value"] > 0


def test_sweep_reports_each_rate():
    import time

    from bench import sweep
    from repro_torch.core import backend

    cell = _small.small_cell("e125.tail")
    saved = backend.CudaBackend.needs_cuda
    backend.CudaBackend.needs_cuda = False
    try:
        records = list(sweep.sweep(cell, 5, 0.5, [20.0, 40.0], torch.device("cpu"), time.perf_counter()))
    finally:
        backend.CudaBackend.needs_cuda = saved
    assert "setup_s" in records[0] and [r["rate"] for r in records[1:]] == [20.0, 40.0]
    for r in records[1:]:
        assert r["done"] == r["appends"] and len(r["backlog_by_quarter"]) == 4
