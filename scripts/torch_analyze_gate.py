"""Static-analysis gate for the PyTorch port: lint every phase program,
prove the lint can still catch violations, and hold the analyzer's public
promises.

    PYTHONPATH=src python scripts/torch_analyze_gate.py [--device cuda|cpu]

The counterpart of ``scripts/analyze_gate.py``.  Four checks:

  1. phase-program lint (``repro_torch.analyze.program``) over every
     backend the device runs — on ``cpu`` ``torch``, ``packed`` and
     ``sparse``; on ``cuda`` also the kernel paths (``cuda``, and ``packed``
     / ``sparse`` with ``kernel=True``) — at two (c, k) buckets: no f64 /
     c128 tensor, no host sync inside a phase, no shape outside the bucket
     set.  Any finding fails the gate with the offending program named.
  2. seeded-violation self-tests — a program with an injected f64
     promotion, one with an injected ``.item()`` host sync (the port's
     counterpart of the reference's ``pure_callback``) and an engine linted
     at a chunk length that is not a power of two MUST each be flagged; if
     one slips through, the lint itself has rotted and the gate fails.
  3. fleet compile economy: tenants over few automaton buckets run
     O(#buckets) programs, never O(#tenants).
  4. ``backend="auto"`` resolution is sound: the analyzer picks a registered
     backend and the auto parser's forest is bit-identical to the same
     config with the chosen backend (and kernel path) named explicitly.

Exits non-zero on the first violated invariant, printing which one.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parents[1] / "src"))

import numpy as np
import torch

import repro_torch
from repro_torch.analyze import lint_engine, lint_program, lint_report
from repro_torch.core.engine import resolve_device

GATE_PATTERN = "(a|b|ab)+"
GATE_BUCKETS = ((4, 32), (8, 32))


def device_backends(device) -> list:
    """(backend, kernel) pairs the device runs: every registered backend
    that runs there, and on the card the kernel paths of packed / sparse."""
    if device.type == "cuda":
        return [("cuda", False), ("torch", False), ("packed", False), ("packed", True),
                ("sparse", False), ("sparse", True)]
    return [(name, False) for name in repro_torch.list_backends() if name != "cuda"]


def check_backends(device) -> None:
    for backend, kernel in device_backends(device):
        label = backend + ("+kernel" if kernel else "")
        p = repro_torch.Parser(repro_torch.ParserConfig(
            regex=GATE_PATTERN, backend=backend, kernel=kernel), device=device)
        findings = lint_engine(p.engine, buckets=GATE_BUCKETS, label=label)
        assert not findings, (
            f"{label}: phase programs violate lint invariants:\n"
            + lint_report(findings)
        )
        n = len(GATE_BUCKETS) * 3
        print(f"ok: {label:14s} — {n} phase programs clean at "
              f"{'/'.join(f'{c}x{k}' for c, k in GATE_BUCKETS)}")


def check_seeded_violations(device) -> None:
    x = torch.ones(8, 8, device=device)

    # f64 promotion
    findings = lint_program(lambda a: a.to(torch.float64) * 2.0, (x,), "selftest:f64")
    assert "f64" in {f.rule for f in findings}, (
        "seeded f64 promotion was NOT caught — the lint has rotted "
        f"(findings: {lint_report(findings) or 'none'})"
    )
    print(f"ok: selftest       — seeded f64 promotion caught "
          f"({len(findings)} findings)")

    # host sync: a value read back inside the program
    findings = lint_program(lambda a: a.sum().item(), (x,), "selftest:item")
    assert "host-sync" in {f.rule for f in findings}, (
        "seeded .item() host sync was NOT caught — the lint has rotted "
        f"(findings: {lint_report(findings) or 'none'})"
    )
    print(f"ok: selftest       — seeded .item() host sync caught "
          f"({len(findings)} findings)")

    # a chunk length outside the bucket set (not a power of two)
    p = repro_torch.Parser(repro_torch.ParserConfig(
        regex=GATE_PATTERN, backend=device_backends(device)[0][0]), device=device)
    findings = lint_engine(p.engine, buckets=((4, 12),), label="selftest")
    assert "dynamic-shape" in {f.rule for f in findings}, (
        "seeded non-power-of-two chunk length was NOT caught — the lint has "
        f"rotted (findings: {lint_report(findings) or 'none'})"
    )
    print(f"ok: selftest       — seeded chunk length 12 caught "
          f"({len(findings)} findings)")


def check_fleet_compile_economy(device) -> None:
    from repro_torch.core.fleet import clear_table_cache

    dense = device_backends(device)[0][0]
    clear_table_cache()
    tenants = {
        f"t{i}": repro_torch.ParserConfig(regex="(a|b)*abb", backend=dense, n_chunks=4)
        for i in range(5)
    }
    tenants["sp"] = repro_torch.ParserConfig(
        regex="(a|b)*abb", backend="sparse", kernel=device.type == "cuda", n_chunks=4
    )
    with repro_torch.ParserFleet(tenants, device=device) as fleet:
        fleet.parse_batch([(tid, "ababb") for tid in tenants])
        n_buckets = fleet.engine.n_buckets
        assert fleet.compile_count == n_buckets, (
            f"fleet ran {fleet.compile_count} programs for {n_buckets} "
            f"buckets over {len(tenants)} tenants — the program count must be "
            "O(#buckets), not O(#tenants)"
        )
    print(f"ok: fleet          — {len(tenants)} tenants -> {n_buckets} buckets -> "
          f"{n_buckets} programs")


def check_auto_backend(device) -> None:
    auto = repro_torch.Parser(
        repro_torch.ParserConfig(regex=GATE_PATTERN, backend="auto"), device=device)
    chosen = auto.backend_name
    kernel = getattr(auto.engine.backend, "kernel", False)     # packed / sparse
    assert chosen in repro_torch.list_backends(), (
        f'backend="auto" resolved to unregistered backend {chosen!r}'
    )
    explicit = repro_torch.Parser(repro_torch.ParserConfig(
        regex=GATE_PATTERN, backend=chosen, kernel=kernel),
        device=device)
    for text in ("abab" * 8, "ba" * 7, "a", "abba" * 5):
        fa = auto.parse(text).forest
        fe = explicit.parse(text).forest
        assert np.array_equal(fa.columns, fe.columns) and np.array_equal(
            fa.classes, fe.classes
        ), f'backend="auto" forest diverged from {chosen!r} on {text!r}'
    label = chosen + ("+kernel" if kernel else "")
    print(f"ok: auto           — resolves to {label!r}, bit-identical forests")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"torch_analyze_gate: {e}", file=sys.stderr)
        return 1
    try:
        check_backends(device)
        check_seeded_violations(device)
        check_fleet_compile_economy(device)
        check_auto_backend(device)
    except AssertionError as e:
        print(f"torch_analyze_gate: FAILED: {e}", file=sys.stderr)
        return 1
    print("analyze gate: all checks passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
