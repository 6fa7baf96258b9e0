"""``repro_torch.analyze``: the port's static-analysis layer.

Three modules, as in ``repro.analyze``:

  ``pattern``    RE / automaton diagnostics on the host: feasible-start
                 width bounds, ambiguity verdicts, product density, the
                 per-backend cost model behind ``backend="auto"`` and the
                 ``analyze=`` admission knob.
  ``program``    the phase-program lint: no f64, no host sync inside a
                 phase, no shape outside the bucket set, over the ATen ops
                 each phase runs.
  ``roofline``   the H100's machine constants and the ``Roofline`` terms.

The reference's HLO readers have their counterparts over the port's traced
programs (``launch/op_stats.py``): ``collective_bytes`` and
``analyze_compiled`` read an ``OpStats``, and
``lint_trace`` over recorded ATen ops takes the place of both
``lint_jaxpr`` and ``lint_hlo_text``; ``NVLINK_BW`` takes that of
``ICI_BW``.
"""

from __future__ import annotations

from .pattern import (  # noqa: F401
    AnalysisReport,
    analyze_matrices,
    analyze_pattern,
    backend_cost_model,
    cached_report,
    choose_backend,
    density_profile,
    feasible_width_bounds,
    nfa_ambiguous,
    resolve_auto_backend,
    resolve_backend,
    sparse_width_bucket,
)
from .program import (  # noqa: F401
    LintFinding,
    lint_engine,
    lint_program,
    lint_report,
    lint_trace,
    trace_ops,
)
from .roofline import (  # noqa: F401
    HBM_BW,
    NVLINK_BW,
    PEAK_FLOPS,
    Roofline,
    analyze_compiled,
    collective_bytes,
)

__all__ = [
    "AnalysisReport",
    "HBM_BW",
    "LintFinding",
    "NVLINK_BW",
    "PEAK_FLOPS",
    "Roofline",
    "analyze_compiled",
    "analyze_matrices",
    "analyze_pattern",
    "backend_cost_model",
    "cached_report",
    "choose_backend",
    "collective_bytes",
    "density_profile",
    "feasible_width_bounds",
    "lint_engine",
    "lint_program",
    "lint_report",
    "lint_trace",
    "nfa_ambiguous",
    "resolve_auto_backend",
    "resolve_backend",
    "sparse_width_bucket",
    "trace_ops",
]
