"""Phase-program lint: invariants every phase program of the engine must hold.

The port's counterpart of ``repro/analyze/program.py``.  The reference lints
jitted programs (their jaxprs and compiled HLO); the port runs eagerly, so a
phase program is what one call of an engine's phase (``core/engine.py``
``PhasePrograms``: reach, join, build&merge) sends to ATen, and the lint
records those ops with a ``TorchDispatchMode`` while the phase runs at a
bucket shape.  A fleet shares each phase over every tenant of a bucket, so
one rotted phase slows them all.  Three rules:

  f64          a float64 / complex128 tensor among an op's inputs or
               outputs doubles the bytes it moves and leaves the tensor
               cores;
  host-sync    an op that makes the host wait for the card inside a phase:
               ``aten::_local_scalar_dense`` (``.item()``, ``int()``,
               ``bool()`` of a tensor), an op whose output shape depends on
               the data (``nonzero``, ``masked_select``, ``unique``), or a
               copy from the card to the CPU; the phases enqueue work and
               return, so one of these stalls every launch behind it;
  dynamic-shape  a symbolic dimension in any op, or a phase run at a chunk
               length outside the engine's bucket set (a power of two, at
               least ``min_chunk_len``): shapes come from the bucket policy,
               one set a bucket.

A kernel launch itself is a ctypes call, not an ATen op: the lint sees what
the launchers do around it (their table preparation, their checks).

``lint_trace`` is also the counterpart of the reference's HLO scan
(``lint_hlo_text``: f64 / complex128 that survives into the compiled
program, and a host callback): the dry-run's recorder
(``launch/op_stats.OpRecorder``) keeps the ops of a traced step in the same
``TracedOp`` form, so ``lint_trace(recorder.ops, name)`` applies the same
rules to a whole train or serve step on the production mesh, where a host
read of a value (``.item()``, ``int()`` of a tensor) is recorded and not
run.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, List, Sequence, Tuple

import numpy as np
import torch

from ..launch.op_stats import OpRecorder, TracedOp  # noqa: F401  (TracedOp: what the lint reads)

_BAD_DTYPES = (torch.float64, torch.complex128)

#: ops that return to the host with a value, or whose output size is the data's
_SYNC_OPS = ("aten::_local_scalar_dense", "aten::nonzero", "aten::masked_select",
             "aten::_unique", "aten::_unique2", "aten::unique_dim",
             "aten::unique_consecutive")


@dataclasses.dataclass(frozen=True)
class LintFinding:
    """One violated invariant in one phase program."""

    rule: str      # "host-sync" | "f64" | "dynamic-shape"
    program: str   # e.g. "packed:reach@4x32"
    detail: str

    def __str__(self) -> str:
        return f"[{self.rule}] {self.program}: {self.detail}"


def trace_ops(fn: Callable, args: Sequence) -> List[TracedOp]:
    """Run ``fn(*args)`` once and return the ATen ops it ran, in order:
    the dry-run's recorder (``launch/op_stats.OpRecorder``) over every op,
    storage or none."""
    rec = OpRecorder(meta_only=False)
    with rec:
        fn(*args)
    return rec.ops


def lint_trace(ops: Iterable[TracedOp], program: str) -> List[LintFinding]:
    """Lint one recorded program (``trace_ops``) against the three rules."""
    findings: List[LintFinding] = []
    for op in ops:
        for where, metas in (("input", op.inputs), ("output", op.outputs)):
            for dtype, shape, _ in metas:
                if dtype in _BAD_DTYPES:
                    findings.append(LintFinding(
                        "f64", program, f"'{op.name}' {where} has dtype {dtype}"))
                if any(not isinstance(d, int) for d in shape):
                    findings.append(LintFinding(
                        "dynamic-shape", program, f"'{op.name}' {where} has shape {shape}"))
        if op.name in _SYNC_OPS:
            findings.append(LintFinding(
                "host-sync", program, f"'{op.name}' waits for the device inside the phase"))
        elif op.to_device == "cpu" and any(dev != "cpu" for _, _, dev in op.inputs):
            findings.append(LintFinding(
                "host-sync", program, f"'{op.name}' copies a device tensor to the CPU"))
    return findings


def lint_program(fn: Callable, args: Sequence, program: str) -> List[LintFinding]:
    """Run ``fn(*args)`` once under the recorder and lint what it ran."""
    return lint_trace(trace_ops(fn, args), program)


def _phase_programs(engine, c: int, k: int, seed: int = 0):
    """The engine's phase programs with concrete arguments at bucket (c, k):
    chunks of real classes drawn from ``seed``, then the products and
    entries the earlier phases give for them."""
    t = engine.tables
    rng = np.random.default_rng(seed)
    grid = rng.integers(0, max(t.pad_class, 1), size=(c, k)).astype(np.int32)
    chunks = engine.chunks_tensor(grid)
    phases = engine.phases
    P = phases.reach(t.N, chunks)
    Jf, Jb, _ = phases.join(P, t.I, t.F)
    return {
        "reach": (phases.reach, (t.N, chunks)),
        "join": (phases.join, (P, t.I, t.F)),
        "build_merge": (phases.build_merge, (t.N, chunks, Jf, Jb)),
    }


def lint_engine(
    engine,
    buckets: Sequence[Tuple[int, int]] = ((4, 32),),
    label: str = "",
) -> List[LintFinding]:
    """Lint every phase program of one engine at the given (c, k) buckets.

    Programs are named ``<label>:<phase>@<c>x<k>``.  A bucket whose chunk
    length k is not in the engine's bucket set (a power of two, at least
    ``min_chunk_len``) is a ``dynamic-shape`` finding of each phase.
    """
    findings: List[LintFinding] = []
    for c, k in buckets:
        c, k = int(c), int(k)
        for phase, (prog, args) in _phase_programs(engine, c, k).items():
            name = f"{label}:{phase}@{c}x{k}"
            if k & (k - 1) or k < engine.min_chunk_len:
                findings.append(LintFinding(
                    "dynamic-shape", name,
                    f"chunk length {k} is outside the engine's bucket set "
                    f"(powers of two from {engine.min_chunk_len})"))
            findings += lint_program(prog, args, name)
    return findings


def lint_report(findings: Iterable[LintFinding]) -> str:
    """Human-readable multi-line summary (empty string when clean)."""
    return "\n".join(str(f) for f in findings)
