"""regrep — the paper's proof-of-concept query utility (Sect. 1), on the PyTorch port.

    PYTHONPATH=src python examples/torch_regrep.py -e '<pattern>' [-e ...] <file>
    PYTHONPATH=src python examples/torch_regrep.py --demo [--device cuda|cpu]
        [--backend cuda|torch|packed|sparse] [--kernel]

Parses the WHOLE file against each RE and extracts group matches from the
``ParseResult`` — no false positives from free-text regions, unlike a grep
for the delimiter (the paper's e-mail example).

Multiple ``-e`` patterns run as tenants of ONE ``repro_torch.ParserFleet``:
patterns whose padded automata share a (backend, ℓp) bucket are served by a
single tenant-batched dispatch (on the card, one kernel launch a phase for
the whole bucket), so querying a file with a stack of REs costs one program
per bucket — not one per pattern.  Exits 1 when no pattern matches.

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


DEMO_TEXT = b"F:ab;T:a,ba,C:ab;,b.F:b;T:ab,C:."
DEMO_PATTERNS = [
    # the paper's e-mail example: the full multi-record query
    r"(F:(a|b)+;T:((a|b)+,)+C:(a|b|;|,)*\.)+",
    # a single-record query: does NOT match the two-record demo text
    r"F:(a|b)+;T:((a|b)+,)+C:(a|b|;|,)*\.",
    # an unambiguous catch-all over the demo alphabet: always matches
    r"(F|T|C|a|b|;|,|:|\.)*",
]


def regrep(
    patterns: list[str], data: bytes, group: int | None, n_chunks: int = 8,
    *, backend: str = "cuda", kernel: bool = False, device=None,
) -> int:
    with repro_torch.ParserFleet(
        {
            f"p{i}": repro_torch.ParserConfig(
                regex=pat, n_chunks=n_chunks, backend=backend, kernel=kernel)
            for i, pat in enumerate(patterns)
        },
        device=device,
    ) as fleet:
        results = fleet.parse_batch(
            [(f"p{i}", data) for i in range(len(patterns))]
        )
        st = fleet.stats()["fleet"]
        print(
            f"# fleet: {st['n_tenants']} pattern(s) -> "
            f"{st['n_buckets']} automaton bucket(s), "
            f"{fleet.compile_count} compiled program(s)"
        )
        any_ok = False
        for i, (pat, result) in enumerate(zip(patterns, results)):
            if not result.ok:
                print(f"[p{i}] {pat!r}: text does not match")
                continue
            any_ok = True
            groups = fleet.groups_of(f"p{i}")
            targets = [group] if group is not None else groups
            print(
                f"[p{i}] {pat!r}: {result.count_trees()} parse tree(s); "
                f"groups: {groups}"
            )
            for g in targets:
                for a, b in result.matches(g):
                    print(
                        f"  group {g} [{a}:{b}] "
                        f"{data[a:b].decode(errors='replace')!r}"
                    )
    return 0 if any_ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("pattern", nargs="?",
                    help="single query RE (or use -e, repeatable)")
    ap.add_argument("file", nargs="?")
    ap.add_argument("-e", "--regexp", action="append", default=[],
                    help="add a query pattern (fleet tenant); repeatable")
    ap.add_argument("--group", type=int, default=None)
    ap.add_argument("--chunks", type=int, default=8)
    ap.add_argument("--demo", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny CI run (implies --demo)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backend", default=None, choices=repro_torch.list_backends(),
                    help="every tenant's backend; default: cuda on the card, torch on the CPU")
    ap.add_argument("--kernel", action="store_true",
                    help="packed / sparse through their kernels (the card only)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"torch_regrep: {e}", file=sys.stderr)
        return 1
    run = dict(backend=args.backend or ("cuda" if device.type == "cuda" else "torch"),
               kernel=args.kernel, device=device)
    patterns = list(args.regexp)
    if args.pattern is not None:
        # with -e present the positional slot is actually the file
        if patterns and args.file is None:
            args.file = args.pattern
        else:
            patterns.insert(0, args.pattern)
    if args.demo or args.smoke or not patterns:
        print(f"demo: text = {DEMO_TEXT!r}")
        return regrep(DEMO_PATTERNS, DEMO_TEXT, None, args.chunks, **run)
    data = Path(args.file).read_bytes()
    return regrep(patterns, data, args.group, args.chunks, **run)


if __name__ == "__main__":
    sys.exit(main())
