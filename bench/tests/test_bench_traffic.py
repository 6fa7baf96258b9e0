"""The traffic generator: grammars, seeds and the open-loop schedule."""

import json

import _paths  # noqa: F401
import numpy as np
import pytest
import torch

from bench import harness, textgen
from bench.reference import forest as ref

CONFIGS = {name: json.loads((harness.BENCH / "configs" / f"{name}.json").read_text())
           for name in ("traffic", "e125")}


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("n_bytes", [129, 1000, 4096])
def test_texts_are_valid_and_exact(name, n_bytes):
    cfg = CONFIGS[name]
    aut = ref.automaton(cfg["pattern"])
    for text in textgen.texts(cfg["text"], n_bytes, 3, 2**31 + 17, purpose=1):
        assert len(text) == n_bytes
        assert ref.accepted(ref.forest(aut, text, torch.device("cpu"), chunk=64))
    # concatenations (a stream's prefix) are valid too
    pieces = textgen.texts(cfg["text"], 256, 3, 5, purpose=2)
    assert ref.accepted(ref.forest(aut, b"".join(pieces), torch.device("cpu"), chunk=64))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_seeds(name):
    spec = CONFIGS[name]["text"]
    a = textgen.texts(spec, 2048, 2, 1, purpose=1)
    assert a == textgen.texts(spec, 2048, 2, 1, purpose=1)
    assert a != textgen.texts(spec, 2048, 2, 2, purpose=1)
    assert a[0] != a[1]


def test_log_fields_follow_the_grammar():
    spec = CONFIGS["traffic"]["text"]
    text = textgen.texts(spec, 1 << 16, 1, 9, purpose=1)[0]
    lines = text.split(b"\n")[:-2]                  # the last line fills the text
    methods, paths, outcomes = set(), [], set()
    for line in lines:
        m, path, status, outcome = line.split(b" ")
        methods.add(m.decode())
        paths.append(path)
        outcomes.add(outcome.decode())
        assert len(status) == 3 and status.isdigit()
        assert path.startswith(b"/") and len(path) - 1 <= spec["path_len_max"]
    assert methods == set(spec["methods"]) and outcomes == set(spec["outcomes"])
    lens = np.array([len(p) - 1 for p in paths])
    assert lens.min() == 0 and lens.max() == spec["path_len_max"]
    assert abs(lens.mean() - spec["path_len_max"] / 2) < 0.5


def test_schedule_is_the_same_work_in_another_order():
    """Every seed offers the same arrival times and per-session pattern, with
    the sessions relabelled and other pieces; a Poisson stream of the rate."""
    a = textgen.poisson_schedule(300.0, 10.0, 64, 16, seed=1, shape_seed=0)
    b = textgen.poisson_schedule(300.0, 10.0, 64, 16, seed=2**40 + 3, shape_seed=0)
    assert len(a[0]) == len(b[0]) == 3000 and abs(a[0][-1] - 10.0) < 0.1
    assert np.array_equal(a[0], b[0])
    assert not np.array_equal(a[1], b[1]) and not np.array_equal(a[2], b[2])
    for who in (a[1], b[1]):
        counts = np.bincount(who, minlength=64)
        assert counts.max() - counts.min() <= 1
    # relabelling: the same sessions' patterns, under other names
    assert sorted(np.bincount(a[1]).tolist()) == sorted(np.bincount(b[1]).tolist())
    gaps = np.diff(np.concatenate([[0], a[0]]))
    assert abs(gaps.mean() * 300.0 - 1.0) < 0.01 and abs(gaps.std() * 300.0 - 1.0) < 0.05
    c = textgen.poisson_schedule(300.0, 10.0, 64, 16, seed=1, shape_seed=1)
    assert not np.array_equal(a[0], c[0])
