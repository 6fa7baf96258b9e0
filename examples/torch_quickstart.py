"""Quickstart: the public API of the PyTorch port — one Parser, one config, one result type.

    PYTHONPATH=src python examples/torch_quickstart.py [--smoke] [--device cuda|cpu]
        [--backend cuda|torch|packed|sparse] [--kernel]

Walks the paper's complete pipeline on the running example e3 = (a|b|ab)+
through the supported surface of ``repro_torch`` (``repro_torch.Parser`` /
``repro_torch.ParserConfig``): parser generation (segments → NFA → DFA/ME-DFA
→ matrices), chunked parallel parsing, and SLPF inspection via
``ParseResult`` (ok / count / enumerate / render / group matches).

``--device cuda`` (the default) parses on the card through the hand-written
kernels and fails when there is none; ``--device cpu`` runs the ``torch``
backend (or ``packed`` / ``sparse`` without ``--kernel``) on the CPU.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parents[1] / "src"))

import numpy as np

import repro_torch
from repro_torch.core.engine import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="tiny CI run (default sizes already are)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backend", default=None, choices=repro_torch.list_backends(),
                    help="default: cuda on the card, torch on the CPU")
    ap.add_argument("--kernel", action="store_true",
                    help="packed / sparse through their kernels (the card only)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"torch_quickstart: {e}", file=sys.stderr)
        return 1
    backend = args.backend or ("cuda" if device.type == "cuda" else "torch")

    pattern = "(a|b|ab)+"
    text = "abab"

    print(f"RE e = {pattern!r}")
    parser = repro_torch.Parser(repro_torch.ParserConfig(
        regex=pattern, n_chunks=2, backend=backend, kernel=args.kernel), device=device)
    art = parser.artifacts                 # NFA/DFA/ME-DFA introspection
    t = parser.table
    print(f"parser generated: {t.n} segments, "
          f"DFA {art.dfa.n_states} states, ME-DFA {art.medfa.n_states} states "
          f"({len(art.medfa.initial)} entries — one per segment)")
    print("segments:")
    for i in range(t.n):
        flags = ("I" if t.initial[i] else " ") + ("F" if t.final[i] else " ")
        print(f"  {i + 1:3d} {flags}  {t.display(i)}")

    result = parser.parse(text)
    print(f"\nparse {text!r}: ok={result.ok}, "
          f"{result.count_trees()} syntax trees (paper Fig. 9: 4), "
          f"backend={result.backend}, bucket={result.bucket}")
    for tree in result.trees():
        print("  LST:", tree)
    print("group spans: " + ", ".join(
        f"g{g}={result.matches(g)}" for g in parser.groups))

    print("\nclean SLPF columns (segment ids, 1-based):")
    for r, col in enumerate(result.forest.columns):
        print(f"  C_{r}: {sorted((np.flatnonzero(col) + 1).tolist())}")

    # the same config as a plain dict — declarative, file-able, exact
    print(f"\nconfig round-trip: "
          f"{repro_torch.ParserConfig.from_dict(parser.config.to_dict()) == parser.config}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
