"""The port's six parse examples (``examples/torch_*.py``) against the reference's.

The same flags go through the reference example (``examples/<name>.py``, on
its default ``jnp`` backend) and its port (``--device cpu``, on ``torch``,
then on ``packed`` and ``sparse``), both run in-process with stdout
captured.  Every line that carries a parse result must be equal, with no
tolerance: tree counts and LSTs, group spans and clean columns, ``ok`` flags
and bit-identity booleans, regrep's match lines and its exit code.  The line
parts that differ between the packages by design are named in
``chip_smoke.EXAMPLE_DESIGNED`` (which also holds the card's lines to the
CPU's) and replaced by a placeholder on both sides before the comparison;
no line is dropped.
"""

import contextlib
import importlib.util
import io
import re
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
PORT_BACKENDS = ("torch", "packed", "sparse")

sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (stdlib only at import)


def load(path: Path):
    """A script as a module, by its file path (imported once)."""
    name = f"_example_{path.parent.name}_{path.stem}"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


def run_port(name: str, argv) -> tuple:
    """``examples/torch_<name>.py``'s ``main(argv)``: (exit code, stdout)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = load(EXAMPLES / f"torch_{name}.py").main(list(argv))
    return rc, out.getvalue()


_reference: dict = {}


def run_reference(name: str, flags, cwd: Path) -> tuple:
    """``examples/<name>.py``'s ``main()`` with ``flags`` as its command line,
    in ``cwd`` (traced_parse writes its span log there): (exit code,
    stdout), memoized by (name, flags)."""
    key = (name, tuple(flags))
    if key not in _reference:
        module = load(EXAMPLES / f"{name}.py")
        out = io.StringIO()
        argv, sys.argv = sys.argv, [f"{name}.py", *flags]
        rc = 0
        try:
            with contextlib.redirect_stdout(out), contextlib.chdir(cwd):
                module.main()
        except SystemExit as e:          # regrep exits with its code
            rc = e.code or 0
        finally:
            sys.argv = argv
        _reference[key] = (rc, out.getvalue())
    return _reference[key]


def assert_same(name: str, flags, backend: str, tmp_path, extra=()):
    ref_rc, ref_out = run_reference(name, flags, tmp_path)
    rc, out = run_port(name, [*flags, "--device", "cpu", "--backend", backend, *extra])
    assert rc == ref_rc
    want, got = chip_smoke.example_lines(ref_out), chip_smoke.example_lines(out)
    assert len(got) == len(want), (got, want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"line {i}: {g!r} != reference {w!r}"
    return out


CASES = [
    ("quickstart", []),
    ("batch_parse", []),
    ("stream_parse", []),
    ("edit_stream", []),
    ("edit_stream", ["--smoke"]),
    ("traced_parse", []),
    ("regrep", ["--demo"]),
]


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("name,flags", CASES, ids=[f"{n}{''.join(f)}" for n, f in CASES])
def test_example_lines_equal_reference(name, flags, backend, tmp_path):
    out = assert_same(name, flags, backend, tmp_path)
    assert f"backend={backend}" in out or name == "regrep"


def test_quickstart_shows_the_papers_four_trees(tmp_path):
    out = assert_same("quickstart", [], "torch", tmp_path)
    assert "4 syntax trees (paper Fig. 9: 4)" in out
    assert out.count("  LST: ") == 4
    assert "config round-trip: True" in out


def test_stream_examples_are_bit_identical_to_cold_parses():
    for name in ("stream_parse", "edit_stream"):
        rc, out = run_port(name, ["--device", "cpu"])
        flags = re.findall(r"bit-identical=(\w+)", out)
        assert rc == 0 and flags and set(flags) == {"True"}, out


REGREP_TEXT = b"GET /a 200 ok\nPOST /b/c 404 err\nPUT / 500 -\n"
REGREP_PATTERNS = [
    r"((GET|POST|PUT) /([a-z0-9]|/)* ([0-9]{3}) (ok|err|-)\n)+",   # matches
    "(a|b)*a(a|b){5}",                                             # cannot match
]


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("group", [None, 4])
def test_regrep_on_a_file_equals_reference(backend, group, tmp_path):
    path = tmp_path / "log.txt"
    path.write_bytes(REGREP_TEXT)
    flags = [a for p in REGREP_PATTERNS for a in ("-e", p)]
    flags += ([] if group is None else ["--group", str(group)]) + [str(path)]
    out = assert_same("regrep", flags, backend, tmp_path)
    assert "[p1] " in out and "text does not match" in out
    assert "group 4 [" in out


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_regrep_exits_1_when_no_pattern_matches(backend, tmp_path):
    path = tmp_path / "log.txt"
    path.write_bytes(REGREP_TEXT)
    assert_same("regrep", ["-e", REGREP_PATTERNS[1], str(path)], backend, tmp_path)
    rc, out = run_port("regrep", ["-e", REGREP_PATTERNS[1], str(path), "--device", "cpu"])
    assert rc == 1 and "text does not match" in out
