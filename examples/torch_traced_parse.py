"""Traced parsing with the PyTorch port: where does a parse spend its time?

    PYTHONPATH=src python examples/torch_traced_parse.py [--smoke] [--device cuda|cpu]
        [--backend cuda|torch|packed|sparse] [--kernel]

The paper's cost model attributes parallel parse time to phases — chunk
reach, the associative join, build&merge — and the serving stack adds two
more buckets: queue wait and batched device compute.  This example turns on
the observability layer (``repro_torch.obs``) and shows all of it through
the supported surface only:

  * ``ParserConfig(obs=ObsConfig(enabled=True, span_log=...))`` — tracing
    on, spans mirrored to a JSONL file;
  * a direct ``parse`` and a ``submit`` → ticket round trip, both carrying
    a ``trace_id`` on the result.  Both run the same route as untraced
    calls — the parse service, the engine's fused core — with a span at
    each layer boundary; on the card the core's phases and the copy back
    are timed by CUDA events, with no synchronize;
  * the span trees, validated from the JSONL log: for the direct parse the
    paper's phases (reach / join / build&merge / host build), for the
    ticket its queue wait and batch compute (the log also holds the
    finer spans: planning, admission, the batch grid, the copy back);
  * ``Parser.stats()`` as a metrics view: cataloged counters/gauges, the
    per-bucket queue/compute p50/p99 split, and the static modeled cost of
    each phase program (``stats()["hlo"]``, from the engine's
    ``phase_static_cost``: the phases traced on meta tensors);
  * the Prometheus rendering of the same registry.

``--device cuda`` (the default) runs on the card and fails when there is
none; ``--device cpu`` runs ``torch`` (or ``packed`` / ``sparse`` without
``--kernel``) on the CPU.  The span log lives in a temporary directory.
"""

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parents[1] / "src"))

import repro_torch
from repro_torch.core.engine import resolve_device
from repro_torch.obs import prometheus_text, read_spans_jsonl, validate_span_tree


PHASES = ("phase.reach", "phase.join", "phase.build_merge", "phase.host_build")
QUEUE_VS_COMPUTE = ("parse.queue_wait", "parse.batch_compute")


def print_tree(spans, trace_id, names):
    """The trace's root and its spans named in ``names``, by start."""
    tree = validate_span_tree(spans, trace_id)
    root = tree["root"]
    print(f"  trace {trace_id}  root={root['name']}  "
          f"{root['duration_s'] * 1e3:8.2f} ms  attrs={root['attrs']}")
    for c in sorted(tree["children"], key=lambda s: s["t_start_s"]):
        if c["name"] in names:
            print(f"    └─ {c['name']:<24s} {c['duration_s'] * 1e3:8.2f} ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="tiny CI run (default sizes already are)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backend", default=None, choices=repro_torch.list_backends(),
                    help="default: cuda on the card, torch on the CPU")
    ap.add_argument("--kernel", action="store_true",
                    help="packed / sparse through their kernels (the card only)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"torch_traced_parse: {e}", file=sys.stderr)
        return 1
    backend = args.backend or ("cuda" if device.type == "cuda" else "torch")

    with tempfile.TemporaryDirectory() as tmp:
        span_log = Path(tmp) / "spans.jsonl"
        cfg = repro_torch.ParserConfig(
            regex="(a|b|ab)+",
            backend=backend,
            kernel=args.kernel,
            n_chunks=4,
            obs=repro_torch.ObsConfig(enabled=True, span_log=str(span_log)),
        )
        with repro_torch.Parser(cfg, device=device) as parser:
            trace(parser, span_log)
    return 0


def trace(parser, span_log: Path) -> None:
    # direct route: phase attribution
    direct = parser.parse("abab" * 64)
    print(f"parse ok={direct.ok} backend={direct.backend} "
          f"bucket={direct.bucket} trace_id={direct.trace_id}")

    # service route: queue-wait vs batch-compute attribution
    tickets = [parser.submit("ab" * n) for n in (8, 16, 24)]
    served = [t.result() for t in tickets]
    print(f"served {len(served)} tickets "
          f"(trace_ids {[r.trace_id for r in served]})")

    spans = read_spans_jsonl(span_log)
    print(f"\nspan log: {len(spans)} spans in {span_log.name}")
    print("\ndirect route (phase attribution):")
    print_tree(spans, direct.trace_id, PHASES)
    print("\nticket route (queue vs compute):")
    print_tree(spans, served[0].trace_id, QUEUE_VS_COMPUTE)

    stats = parser.stats()
    print("\nper-bucket latency split (queue wait vs device compute):")
    for bucket, d in stats["parse"]["buckets"].items():
        print(f"  bucket {bucket}: served={d['served']} "
              f"p99_queue={d['p99_queue_s'] * 1e3:.2f} ms "
              f"p99_compute={d['p99_compute_s'] * 1e3:.2f} ms")

    print("\nstatic modeled cost per bucket (flops / bytes):")
    for bucket, phases in (stats["hlo"] or {}).items():
        t = phases["total"]
        print(f"  bucket {bucket}: {t['flops']:.3g} flops, "
              f"{t['bytes']:.3g} bytes "
              f"(reach {phases['reach']['flops']:.3g}, "
              f"join {phases['join']['flops']:.3g}, "
              f"build&merge {phases['build_merge']['flops']:.3g})")

    print("\nprometheus exposition (first 12 lines):")
    for line in prometheus_text(stats["metrics"]).splitlines()[:12]:
        print(f"  {line}")


if __name__ == "__main__":
    sys.exit(main())
