"""Structured-output serving with the PyTorch port: RE-constrained decoding with batched requests.

    PYTHONPATH=src python examples/torch_constrained_serve.py [--device cuda|cpu]
    PYTHONPATH=src python examples/torch_constrained_serve.py --pattern '(GET|POST) /[a-z]+'

The paper's parser automaton as a serving feature: the DFA built for parsing
is lifted to the token vocabulary and masks the logits each step, so every
generated sequence is guaranteed to lie in L(e) — even from an untrained
model (which is the demo here: tinyllama's smoke config with random weights
from ``--seed``, valid outputs).  ``ServeEngine.generate`` feeds the prompt
step by step through the decode path.

``--device cuda`` (the default) runs on the card and fails when there is
none; ``--device cpu`` runs on the CPU.  Sampling draws from a
``torch.Generator``, so the sampled strings differ from the JAX package's;
the guarantee does not.
"""

import argparse
import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parents[1] / "src"))

import numpy as np

import repro_torch
from repro_torch.configs import get_smoke
from repro_torch.core.engine import resolve_device
from repro_torch.models.model import init_params
from repro_torch.serve.engine import ServeEngine, TokenDFA, byte_vocab


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pattern", default="(ab|a)*c")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true", help="tiny CI run")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"torch_constrained_serve: {e}", file=sys.stderr)
        return 1
    if args.smoke:
        args.batch, args.max_new = 2, 6

    cfg = get_smoke("tinyllama-1.1b")
    params = init_params(cfg, seed=args.seed, device=device)
    print(f"model: {cfg.name} (random weights) — constraint: {args.pattern!r}")

    # the public parser facade owns generation; its matrices feed the
    # token-DFA logit mask
    parser = repro_torch.Parser(repro_torch.ParserConfig(
        regex=args.pattern, backend="cuda" if device.type == "cuda" else "torch"), device=device)
    tdfa = TokenDFA.from_matrices(parser.matrices, byte_vocab(cfg.vocab_size))
    print(f"token DFA: {tdfa.delta.shape[0]} states over vocab {tdfa.delta.shape[1]}")

    engine = ServeEngine(cfg, params, max_seq=args.max_new + 8,
                         batch=args.batch, eos_id=0, device=device)
    prompts = np.zeros((args.batch, 1), np.int32)  # BOS-ish dummy prompt
    res = engine.generate(prompts, max_new=args.max_new, temperature=1.0,
                          seed=args.seed, constraint=tdfa)
    ok = 0
    for row in res.tokens:
        s = ""
        for c in row:
            if c == 0:
                break
            s += chr(int(c)) if 32 <= int(c) < 127 else "?"
        match = re.fullmatch(args.pattern, s) is not None
        ok += match
        print(f"  {s!r:24s} fullmatch={match}")
    print(f"{ok}/{args.batch} outputs in L(e) — guaranteed by construction")
    return 0


if __name__ == "__main__":
    sys.exit(main())
