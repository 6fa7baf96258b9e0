"""repro_torch's serving stack on the CPU against the reference's: the token
DFA (bit for bit), greedy generation (token for token at f32), grammar-
constrained sampling, the dead-end rule, and continuous batching.

Parameters are the reference's, carried over by ``params_from_jax``.  Sampled
tokens come from a ``torch.Generator`` and differ from the reference's
``jax.random`` draws by design; the checks on them are the grammar's.
"""

import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.core.reference import ParallelArtifacts  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.serve import engine as ref_engine  # noqa: E402
from repro.serve import scheduler as ref_scheduler  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core.matrices import build_matrices  # noqa: E402
from repro_torch.core.segments import compute_segments  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.serve.engine import ServeEngine, TokenDFA, byte_vocab  # noqa: E402
from repro_torch.serve.scheduler import ContinuousBatcher, Request  # noqa: E402

F32 = dict(dtype="float32", param_dtype="float32", attn_p_dtype="float32")
PATTERN = "(ab|a)*c"


def _models(arch):
    rcfg = dataclasses.replace(ref_get_smoke(arch), **F32)
    pcfg = dataclasses.replace(get_smoke(arch), **F32)
    rparams = jax.jit(lambda k: ref_model.init_params(rcfg, k))(jax.random.PRNGKey(0))
    pparams = model.params_from_jax(jax.tree.map(np.asarray, rparams), pcfg, device="cpu")
    return rcfg, rparams, pcfg, pparams


@pytest.fixture(scope="module")
def tiny():
    return _models("tinyllama-1.1b")


@pytest.fixture(scope="module")
def zamba():
    return _models("zamba2-2.7b")


def _token_dfa(pattern, vocab):
    return TokenDFA.from_matrices(build_matrices(compute_segments(pattern)), vocab)


@pytest.mark.parametrize("pattern", [PATTERN, "ab", "(a|b)*a(a|b){3}", "x(yz|y)*z?",
                                     "[0-9]+(\\.[0-9]+)?"])
def test_token_dfa_equals_reference(pattern):
    vocab = byte_vocab(300) + [b"ab", b"", b"abc", b"zz"]
    got = _token_dfa(pattern, vocab)
    want = ref_engine.TokenDFA.from_matrices(ParallelArtifacts.generate(pattern).matrices, vocab)
    assert got.initial == want.initial
    assert got.delta.dtype == want.delta.dtype and np.array_equal(got.delta, want.delta)
    assert np.array_equal(got.final, want.final)


def test_token_dfa_semantics():
    tdfa = _token_dfa(PATTERN, byte_vocab(128))
    s = tdfa.initial
    assert tdfa.delta[s, ord("a")] >= 0 and tdfa.delta[s, ord("b")] == -1
    s2 = tdfa.delta[tdfa.delta[s, ord("a")], ord("b")]
    assert tdfa.delta[s2, ord("a")] >= 0 and tdfa.delta[s2, ord("c")] >= 0
    assert tdfa.final[tdfa.delta[s2, ord("c")]] and not tdfa.final[s2]


@pytest.mark.parametrize("which", ["tiny", "zamba"])
@pytest.mark.parametrize("constrained", [False, True])
def test_greedy_generation_equals_reference(request, which, constrained):
    rcfg, rparams, pcfg, pparams = request.getfixturevalue(which)
    prompts = np.array([[ord("a"), 3, 7], [ord("a"), 9, 1]], np.int32)
    kw = {}
    pkw = {}
    if constrained:
        kw["constraint"] = ref_engine.TokenDFA.from_matrices(
            ParallelArtifacts.generate(PATTERN).matrices, ref_engine.byte_vocab(rcfg.vocab_size))
        pkw["constraint"] = _token_dfa(PATTERN, byte_vocab(pcfg.vocab_size))
    want = ref_engine.ServeEngine(rcfg, rparams, max_seq=32, batch=2, eos_id=0).generate(
        prompts, max_new=8, temperature=0.0, **kw)
    got = ServeEngine(pcfg, pparams, max_seq=32, batch=2, eos_id=0, device="cpu").generate(
        prompts, max_new=8, temperature=0.0, **pkw)
    assert np.array_equal(got.tokens, want.tokens)
    if constrained:
        assert np.array_equal(got.accepted, want.accepted)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_constrained_sampling_always_matches(tiny, seed):
    _, _, cfg, params = tiny
    tdfa = _token_dfa(PATTERN, byte_vocab(cfg.vocab_size))
    eng = ServeEngine(cfg, params, max_seq=64, batch=2, eos_id=0, device="cpu")
    res = eng.generate(np.array([[ord("a")], [ord("a")]], np.int32), max_new=10,
                       temperature=1.0, seed=seed, constraint=tdfa)
    for row, ok in zip(res.tokens.tolist(), res.accepted):
        if 0 in row:                              # finished: EOS only in final states
            text = "".join(chr(c) for c in row[: row.index(0)])
            assert re.fullmatch(PATTERN, text) and ok, text
        else:                                     # cut at max_new: a live prefix
            state = tdfa.initial
            for c in row:
                state = tdfa.delta[state, c]
                assert state >= 0


def test_sampling_is_seeded(tiny):
    _, _, cfg, params = tiny
    eng = ServeEngine(cfg, params, max_seq=32, batch=2, device="cpu")
    prompts = np.array([[1, 2], [3, 4]], np.int32)
    a = eng.generate(prompts, max_new=6, temperature=1.0, seed=5).tokens
    assert np.array_equal(a, eng.generate(prompts, max_new=6, temperature=1.0, seed=5).tokens)


def test_dead_end_emits_eos_not_token_zero(tiny):
    _, _, cfg, params = tiny
    vocab = [b"\xff\xff"] * cfg.vocab_size
    vocab[1] = b"a"
    tdfa = _token_dfa("ab", vocab)                # no token for 'b': stuck after 'a'
    eng = ServeEngine(cfg, params, max_seq=16, batch=2, eos_id=5, device="cpu")
    res = eng.generate(np.array([[1], [1]], np.int32), max_new=4, temperature=0.0,
                       constraint=tdfa)
    assert res.tokens.shape == (2, 2)
    assert np.all(res.tokens[:, 0] == 1) and np.all(res.tokens[:, 1] == 5)
    assert not res.accepted.any()


def test_engine_defaults_to_the_card(tiny):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    _, _, cfg, params = tiny
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatcher(cfg, params)


def _isolated_greedy(cfg, params, prompt, max_new, eos=0):
    eng = ServeEngine(cfg, params, max_seq=64, batch=1, eos_id=eos, device="cpu")
    toks = []
    for t in eng.generate(prompt[None, :], max_new=max_new, temperature=0.0).tokens[0]:
        if t == eos:
            break
        toks.append(int(t))
    return np.asarray(toks, np.int32)


@pytest.mark.parametrize("which", ["tiny", "zamba"])
def test_more_requests_than_slots(request, which):
    """6 requests through 2 slots: every output equals isolated generation
    and the reference batcher's (slot reuse leaks nothing)."""
    rcfg, rparams, cfg, params = request.getfixturevalue(which)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=L).astype(np.int32) for L in [3, 5, 2, 4, 3, 6]]
    batcher = ContinuousBatcher(cfg, params, batch=2, max_seq=64, eos_id=0, device="cpu")
    ref = ref_scheduler.ContinuousBatcher(rcfg, rparams, batch=2, max_seq=64, eos_id=0)
    for i, p in enumerate(prompts):
        batcher.submit(Request(rid=i, prompt=p, max_new=5))
        ref.submit(ref_scheduler.Request(rid=i, prompt=p, max_new=5))
    done = batcher.run()
    want = {r.rid: r.output for r in ref.run()}
    assert sorted(r.rid for r in done) == list(range(6))
    for r in done:
        np.testing.assert_array_equal(r.output, want[r.rid])
        np.testing.assert_array_equal(r.output, _isolated_greedy(cfg, params, r.prompt, r.max_new))


def test_constrained_requests_in_batch(tiny):
    _, _, cfg, params = tiny
    tdfa = _token_dfa(PATTERN, byte_vocab(cfg.vocab_size))
    batcher = ContinuousBatcher(cfg, params, batch=2, max_seq=64, eos_id=0, seed=7, device="cpu")
    for i in range(4):
        batcher.submit(Request(rid=i, prompt=np.array([ord("a")], np.int32), max_new=8,
                               temperature=1.0, constraint=tdfa))
    done = batcher.run()
    assert len(done) == 4
    for r in done:
        state = tdfa.initial
        for tok in [ord("a")] + [int(t) for t in r.output]:
            state = int(tdfa.delta[state, tok])
            assert state >= 0
        if r.output.size < r.max_new:
            assert re.fullmatch(PATTERN, "a" + "".join(chr(c) for c in r.output))
