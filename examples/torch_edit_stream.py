"""Mid-text edits via the facade of the PyTorch port: splice a live stream in O(log n).

    PYTHONPATH=src python examples/torch_edit_stream.py [--device cuda|cpu]
        [--backend cuda|torch|packed|sparse] [--kernel]

Demonstrates the editing surface of ``repro_torch.Parser`` streams:

  1. ``ParserStream.edit(lo, hi, replacement)`` — replace ``text[lo:hi]``
     in-place; the product segment tree re-reaches only the spliced leaves
     and re-composes one leaf-to-root path, so the cost is O(cap + log n)
     instead of a full re-parse, and every post-edit state is bit-identical
     to a cold parse of the edited text;
  2. ``delete`` / ``insert`` sugar — zero-width and pure-delete splices;
  3. an editor session — repeated random splices against a cold-parse
     referee, with the ``stream_edits_total`` counter and recompose-depth
     histogram from the metrics snapshot as the wrap-up.

``--device cuda`` (the default) runs on the card and fails when there is
none; ``--device cpu`` runs ``torch`` (or ``packed`` / ``sparse`` without
``--kernel``) on the CPU.
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
    ap.add_argument("--backend", default=None, choices=repro_torch.list_backends(),
                    help="default: cuda on the card, torch on the CPU")
    ap.add_argument("--kernel", action="store_true",
                    help="packed / sparse through their kernels (the card only)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny CI run (default sizes already are)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"torch_edit_stream: {e}", file=sys.stderr)
        return 1
    backend = args.backend or ("cuda" if device.type == "cuda" else "torch")

    pattern = "(a|b|ab)+"
    parser = repro_torch.Parser(repro_torch.ParserConfig(
        regex=pattern, backend=backend, kernel=args.kernel, first_seal_len=4,
        max_seal_len=16, obs={"enabled": True},
    ), device=device)
    cold = repro_torch.Parser(repro_torch.ParserConfig(
        regex=pattern, backend=backend, kernel=args.kernel), device=device)

    def check(stream, text, what):
        res = stream.result()
        ref = cold.parse(text)
        same = np.array_equal(res.forest.pack(), ref.forest.pack())
        print(f"  {what:24s} n={res.forest.n:3d}  ok={res.ok!s:5} "
              f"trees={res.count_trees():4d}  bit-identical={same}")
        assert same

    # 1. one stream, spliced every which way --------------------------------
    print(f"RE {pattern!r}, backend={backend}: mid-text edits")
    text = "ab" * 12
    with parser.open_stream() as stream:
        stream.append(text)
        check(stream, text, f"append {len(text)} chars")

        text = text[:6] + "ba" + text[10:]          # replace, shrinking
        stream.edit(6, 10, "ba")
        check(stream, text, "edit [6:10) -> 'ba'")

        text = text[:0] + text[2:]                  # pure delete at the front
        stream.delete(0, 2)
        check(stream, text, "delete [0:2)")

        text = text[:8] + "abab" + text[8:]         # zero-width insert
        stream.insert(8, "abab")
        check(stream, text, "insert 'abab' @8")

    # 2. an editor session: random splices vs the cold referee --------------
    rng = np.random.Generator(np.random.Philox(7))
    text = "ab" * 20
    with parser.open_stream() as stream:
        stream.append(text)
        n_edits = 4 if args.smoke else 10
        for _ in range(n_edits):
            lo = int(rng.integers(0, len(text)))
            hi = int(rng.integers(lo, min(len(text), lo + 6) + 1))
            repl = "".join(rng.choice(list("ab"), rng.integers(0, 5)))
            text = text[:lo] + repl + text[hi:]
            stream.edit(lo, hi, repl)
            check(stream, text, f"splice [{lo}:{hi}) -> {repl!r}")

    snap = parser.stats()["metrics"]
    edits = snap["stream_edits_total"][0]["value"]
    depth = snap["stream_edit_recompose_depth"][0]["value"]
    print(f"{int(edits)} splices, recompose-depth histogram: "
          f"count={depth['count']} sum={depth['sum']:.0f} "
          f"(mean {depth['sum'] / max(depth['count'], 1):.1f} "
          f"internal products per edit)")
    parser.close()
    cold.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
