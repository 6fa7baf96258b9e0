"""Streaming incremental parse via the facade of the PyTorch port: append, re-pay only the tail.

    PYTHONPATH=src python examples/torch_stream_parse.py [--device cuda|cpu]
        [--backend cuda|torch|packed|sparse] [--kernel]

Demonstrates the streaming surface of ``repro_torch.Parser``:

  1. ``open_stream``   — each stream owns a persistent chunk-product prefix
     cache; ``append`` re-runs only the appended piece's reach + an O(log n)
     join, and every state is bit-identical to a cold parse of the prefix;
  2. deadline-aware appends — the same typed admission as ``submit``;
  3. many sessions     — concurrent streams batch their tail pieces into one
     device reach over ONE engine, under a bytes-budget eviction policy
     (``ParserConfig.cache_budget_bytes``).

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
    ap.add_argument("--smoke", action="store_true", help="tiny CI run (default sizes already are)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"torch_stream_parse: {e}", file=sys.stderr)
        return 1
    backend = args.backend or ("cuda" if device.type == "cuda" else "torch")

    pattern = "(a|b|ab)+"
    parser = repro_torch.Parser(repro_torch.ParserConfig(
        regex=pattern, backend=backend, kernel=args.kernel, first_seal_len=4,
        cache_budget_bytes=256 * 1024,
    ), device=device)
    cold = repro_torch.Parser(repro_torch.ParserConfig(
        regex=pattern, backend=backend, kernel=args.kernel), device=device)

    # 1. one live stream, incremental states vs cold re-parse ---------------
    print(f"RE {pattern!r}, backend={backend}: streaming appends")
    with parser.open_stream() as stream:
        prefix = ""
        for piece in ["ab", "ab", "x", "", "abab"]:
            stream.append(piece, deadline_s=30.0)
            prefix += piece
            res = stream.result()
            ref = cold.parse(prefix)
            print(f"  +{piece!r:8} n={res.forest.n:3d}  ok={res.ok!s:5} "
                  f"trees={res.count_trees():4d}  "
                  f"bit-identical={np.array_equal(res.forest.pack(), ref.forest.pack())}")

    # 2. many sessions, one engine ------------------------------------------
    streams = [parser.open_stream() for _ in range(4)]
    feeds = ["ab" * 8, "abab" * 5, "b" + "ab" * 6, "ba" * 4]
    for rnd in range(4):                # interleaved round-robin appends
        for stream, feed in zip(streams, feeds):
            q = len(feed) // 4
            stream.append(feed[rnd * q : (rnd + 1) * q])
    parser.stream_service.drain()       # batched absorption across sessions
    for stream, feed in zip(streams, feeds):
        res = stream.result()
        print(f"  session {stream.sid}: n={res.forest.n:3d} trees={res.count_trees()}")
        stream.close()
    st = parser.stats()["stream"]
    print(f"{st['batches_run']} reach batches for "
          f"{sum(v['served'] for v in st['buckets'].values())} appends, "
          f"{st['bytes_cached']} bytes cached, {st['evictions']} evictions, "
          f"{st['compile_count']} compiled programs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
