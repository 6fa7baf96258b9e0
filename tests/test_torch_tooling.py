"""The port's tooling outside the package: the examples that are not parse
lines (sharded, constrained serving, training), the obs and analysis gates,
the CI script, and what every one of them may import.

* ``torch_sharded_parse`` runs 2 gloo ranks as a subprocess with a time
  limit of its own; every part must be bit-identical to the single-process
  parser, and a rank that fails ends the run with exit code 1.
* ``torch_constrained_serve``: every output in L(e).
* ``torch_train_lm --smoke``: 3 steps; a run crashed at step 2 and invoked
  again on its ``--workdir`` resumes, and its final loss is within
  ``RESUME_BOUND`` of an uninterrupted run's.
* ``torch_obs_smoke`` and ``torch_analyze_gate`` exit 0 on the CPU, and the
  analyze gate's seeded self-tests fire when the lint has rotted.
* no ``examples/torch_*.py`` and no ``scripts/torch_*.py`` imports ``jax``
  or ``repro``; each fails (exit 1, no fallback) with ``--device cuda`` and
  no card.
"""

import ast
import contextlib
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))
SCRIPTS = sorted((ROOT / "scripts").glob("torch_*.py"))
GATES = [ROOT / "scripts" / "torch_obs_smoke.py", ROOT / "scripts" / "torch_analyze_gate.py"]
RESUME_BOUND = 1e-4                      # chip_smoke.py's train_resume bound
SHARDED_TIMEOUT_S = 240


def load(path: Path):
    """A script as a module, by its file path (imported once)."""
    name = f"_tool_{path.parent.name}_{path.stem}"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


def run(path: Path, argv) -> tuple:
    """``main(argv)`` of a port script: (exit code, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = load(path).main(list(argv))
    return rc, out.getvalue(), err.getvalue()


def test_the_nine_examples_and_three_tools_exist():
    names = {p.stem for p in EXAMPLES}
    assert names == {f"torch_{n}" for n in (
        "quickstart", "batch_parse", "stream_parse", "edit_stream", "traced_parse",
        "regrep", "sharded_parse", "constrained_serve", "train_lm")}
    assert {p.name for p in SCRIPTS} >= {"torch_obs_smoke.py", "torch_analyze_gate.py"}
    assert os.access(ROOT / "scripts" / "torch_ci.sh", os.X_OK)


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", EXAMPLES + SCRIPTS, ids=lambda p: p.name)
def test_imports_neither_jax_nor_repro(path):
    roots = {name.split(".")[0] for name in _imports(path)}
    assert not roots & {"jax", "jaxlib", "repro"}, roots
    assert "repro_torch" in roots or path.name == "torch_kernel_times.py"


@pytest.mark.parametrize("path", EXAMPLES + GATES, ids=lambda p: p.name)
def test_no_card_means_exit_1_and_no_fallback(path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = run(path, ["--device", "cuda"])
    assert rc == 1 and out == ""
    assert "no CUDA device is available" in err


def test_ci_script_runs_the_port_and_no_benchmark():
    text = (ROOT / "scripts" / "torch_ci.sh").read_text()
    assert subprocess.run(["bash", "-n", str(ROOT / "scripts" / "torch_ci.sh")]).returncode == 0
    for needle in ("tests/test_torch_*.py", "examples/torch_*.py", "torch_obs_smoke.py",
                   "torch_analyze_gate.py", "error:repro_torch:DeprecationWarning",
                   '-m "not slow"', "-m cuda"):
        assert needle in text, needle
    commands = [line for line in text.splitlines() if not line.lstrip().startswith("#")]
    assert not any("benchmarks" in line or "bench_trend" in line for line in commands)


# ------------------------------------------------------------ the examples


def _sharded(*argv) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_sharded_parse.py"), *argv,
         "--timeout", str(SHARDED_TIMEOUT_S - 60)],
        capture_output=True, text=True, timeout=SHARDED_TIMEOUT_S, env=env, cwd=ROOT)


@pytest.mark.parametrize("backend", ["torch", "sparse"])
def test_sharded_parse_on_two_ranks_equals_one_process(backend):
    proc = _sharded("--device", "cpu", "--ranks", "2", "--backend", backend)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert lines[0] == "2 ranks over gloo, every rank bit-identical to the single-process parser"
    assert lines[1] == "RE '(a|b|ab)+' on mesh {'pod': 2, 'data': 1}"
    flags = re.findall(r"bit-identical=(\w+)", proc.stdout)
    assert flags == ["True"] * 6
    assert "single long text n=8000: ok=True" in proc.stdout
    assert "ok=[True, False, True, True, True, True, False, True]" in proc.stdout
    ranks = [json.loads(line.split(": ", 1)[1]) for line in lines if line.startswith("rank ")]
    assert ranks == [{}, {}]                  # the plain versions: no kernel on the CPU


def test_sharded_parse_ends_when_a_rank_fails():
    proc = _sharded("--device", "cpu", "--ranks", "2", "--backend", "cuda")
    assert proc.returncode == 1
    assert "rank 0" in proc.stderr and proc.stdout == ""


@pytest.mark.parametrize("argv", [[], ["--smoke"], ["--seed", "3", "--batch", "3"]])
def test_constrained_outputs_fullmatch(argv):
    rc, out, _ = run(ROOT / "examples" / "torch_constrained_serve.py", ["--device", "cpu", *argv])
    batch = 2 if "--smoke" in argv else int(argv[argv.index("--batch") + 1]) if argv else 4
    assert rc == 0
    assert out.count("fullmatch=True") == batch and "fullmatch=False" not in out
    assert f"{batch}/{batch} outputs in L(e)" in out


def _final_loss(workdir: Path) -> float:
    return json.loads((workdir / "metrics.jsonl").read_text().splitlines()[-1])["loss"]


def test_train_lm_resumes_within_bound(tmp_path, monkeypatch):
    path = ROOT / "examples" / "torch_train_lm.py"
    smoke = ["--smoke", "--device", "cpu"]
    rc, out, _ = run(path, [*smoke, "--workdir", str(tmp_path / "whole")])
    assert rc == 0 and "for 3 steps" in out
    assert [int(s) for s in re.findall(r"step +(\d+) loss", out)] == [1, 2, 3]
    # the interrupted run: its trainer crashes at step 2, after that checkpoint
    module = load(path)
    config = module.TrainerConfig
    with monkeypatch.context() as m:
        m.setattr(module, "TrainerConfig", lambda **kw: config(**kw, fail_at_step=2))
        with pytest.raises(RuntimeError, match="injected failure at step 2"):
            run(path, [*smoke, "--workdir", str(tmp_path / "cut")])
    rc, out, _ = run(path, [*smoke, "--workdir", str(tmp_path / "cut")])
    assert rc == 0 and re.findall(r"step +(\d+) loss", out) == ["3"]
    whole, resumed = _final_loss(tmp_path / "whole"), _final_loss(tmp_path / "cut")
    assert abs(whole - resumed) <= RESUME_BOUND
    assert f"final loss: {resumed:.4f}" in out


def test_train_lm_presets_equal_reference():
    port = load(ROOT / "examples" / "torch_train_lm.py")
    ref = load(ROOT / "examples" / "train_lm.py")
    assert port.preset_100m().__dict__ == ref.preset_100m().__dict__
    assert 90e6 < port.preset_100m().n_params < 130e6


# --------------------------------------------------------------- the gates


def test_obs_smoke_gate_passes_on_cpu():
    rc, out, err = run(ROOT / "scripts" / "torch_obs_smoke.py", ["--device", "cpu"])
    assert rc == 0, err
    assert out.splitlines()[-1] == "obs smoke gate: all checks passed"
    for check in ("ok: torch ", "ok: packed ", "ok: sparse ", "ok: edit ", "ok: fleet ",
                  "ok: analyze "):
        assert check in out


def test_analyze_gate_passes_on_cpu():
    rc, out, err = run(ROOT / "scripts" / "torch_analyze_gate.py", ["--device", "cpu"])
    assert rc == 0, err
    assert out.splitlines()[-1] == "analyze gate: all checks passed"
    assert out.count("ok: selftest") == 3


@pytest.mark.parametrize("rule,what", [("f64", "f64 promotion"), ("host-sync", ".item()"),
                                       ("dynamic-shape", "chunk length")])
def test_analyze_gate_self_tests_fire_when_the_lint_rots(rule, what, monkeypatch):
    from repro_torch.analyze import program

    gate = load(ROOT / "scripts" / "torch_analyze_gate.py")
    trace, engine = program.lint_trace, gate.lint_engine
    monkeypatch.setattr(program, "lint_trace",
                        lambda ops, name: [f for f in trace(ops, name) if f.rule != rule])
    monkeypatch.setattr(gate, "lint_engine",
                        lambda *a, **k: [f for f in engine(*a, **k) if f.rule != rule])
    rc, out, err = run(ROOT / "scripts" / "torch_analyze_gate.py", ["--device", "cpu"])
    assert rc == 1
    assert "FAILED" in err and what in err and "the lint has rotted" in err


# ------------------------- the forest walks behind regrep's lines, at length

LOG_RE = r"((GET|POST|PUT) /([a-z0-9]|/)* ([0-9]{3}) (ok|err|-)\n)+"


def _log(n_lines: int) -> bytes:
    import numpy as np

    rng = np.random.default_rng(0)
    return b"".join(b"%s /%s %03d %s\n" % (
        (b"GET", b"POST", b"PUT")[rng.integers(3)], b"ab/c9"[: rng.integers(6)],
        rng.integers(1000), (b"ok", b"err", b"-")[rng.integers(3)]) for _ in range(n_lines))


@pytest.mark.parametrize("pattern,text", [
    (LOG_RE, _log(600)),                        # one parse: every column one segment
    (LOG_RE, _log(40) + b"GET /x 20 ok\n"),     # rejected
    ("(a|b|ab)+", b"ab" * 12),                  # 2**12 parses
    ("(a|ab|b)*(b|ba)*", b"ab" * 40 + b"a"),
])
def test_forest_walks_equal_reference(pattern, text):
    """``count_trees``, ``trees`` and every group's ``matches`` of the port's
    forest equal the reference's on the same columns; a forest with one
    segment a column takes the port's O(n) route, the others its depth-first
    walk (regrep's lines over a log of megabytes)."""
    import numpy as np

    import repro.core.segments as ref_segments
    import repro.core.slpf as ref_slpf
    from repro_torch import Parser, ParserConfig

    p = Parser(ParserConfig(regex=pattern, backend="torch", n_chunks=4), device="cpu")
    got = p.parse(text).forest
    want = ref_slpf.SLPF(ref_segments.compute_segments(pattern), got.columns.copy(),
                         got.classes.copy())
    assert got.count_trees() == want.count_trees()
    assert list(got.iter_trees(limit=50)) == list(want.iter_trees(limit=50))
    for g in p.groups:
        assert got.get_matches(g, limit=50) == want.get_matches(g, limit=50)
    one = bool((got.columns.sum(axis=1) == 1).all())
    assert one == (pattern == LOG_RE and got.accepted)
    if one:                       # the same columns with a broken arc: no tree
        broken = got.columns.copy()
        r = got.n // 2
        q = int(broken[r].argmax())
        broken[r, q], broken[r, (q + 1) % broken.shape[1]] = False, True
        port_b = type(got)(got.table, broken, got.classes)
        ref_b = ref_slpf.SLPF(want.table, broken, got.classes.copy())
        assert port_b.count_trees() == ref_b.count_trees() == 0
        assert list(port_b.iter_trees()) == list(ref_b.iter_trees()) == []
        np.testing.assert_array_equal(got.columns.sum(axis=1), 1)
