"""Batched parsing via the facade of the PyTorch port: many mixed-length texts, few programs.

    PYTHONPATH=src python examples/torch_batch_parse.py [--device cuda|cpu]
        [--backend cuda|torch|packed|sparse] [--kernel]

Demonstrates the serving stack behind ``repro_torch.Parser``:

  1. backend switch    — ``ParserConfig(backend=...)``: the same reach / join /
     build&merge program runs as plain tensor code (``torch``), through the
     hand-written CUDA kernels (``cuda``), or on bit-packed uint32 words
     (``packed`` / ``sparse``, with ``--kernel`` through their kernels) —
     bit-identical outputs;
  2. shape bucketing   — mixed text lengths collapse onto a handful of static
     (c, k) chunk shapes (``compile_count`` counts the distinct shapes run);
  3. ticketed serving  — ``submit`` returns a ``ParseTicket`` past
     deadline-aware admission; ``parse_batch`` drives the bucket-batched
     service and returns results in order.

``--device cuda`` (the default) runs on the card and fails when there is
none; ``--device cpu`` runs ``torch`` (or ``packed`` / ``sparse`` without
``--kernel``) on the CPU.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parents[1] / "src"))

import repro_torch
from repro_torch.core.engine import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default=None, choices=repro_torch.list_backends(),
                    help="default: cuda on the card, torch on the CPU")
    ap.add_argument("--kernel", action="store_true",
                    help="packed / sparse through their kernels (the card only)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--smoke", action="store_true", help="tiny CI run (default sizes already are)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"torch_batch_parse: {e}", file=sys.stderr)
        return 1
    backend = args.backend or ("cuda" if device.type == "cuda" else "torch")

    pattern = "(a|b|ab)+"
    parser = repro_torch.Parser(repro_torch.ParserConfig(
        regex=pattern, backend=backend, kernel=args.kernel, max_batch=8, n_chunks=4,
        slo=repro_torch.SLOTargets(p99_s=5.0),
    ), device=device)

    texts = ["ab", "", "abab", "ba" * 3, "a" * 23, "b", "ab" * 40, "aabb" * 5]
    print(f"RE {pattern!r}, backend={backend}: "
          f"submitting {len(texts)} texts, lengths {[len(t) for t in texts]}")
    results = parser.parse_batch(texts, deadline_s=30.0)

    for text, res in zip(texts, results):
        print(f"  len={len(text):3d}  ok={res.ok!s:5}  trees={res.count_trees()}  "
              f"bucket={res.bucket}")
    st = parser.stats()
    print(f"{st['parse']['batches_run']} device batches, "
          f"{st['compile_count']} compiled programs "
          f"(buckets, not per-length re-jits); "
          f"p99 targets met: "
          f"{all(g.get('p99_ok', True) for g in st['slo']['parse_buckets'].values())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
