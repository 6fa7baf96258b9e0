"""repro_torch — the parallel regular-expression parser in PyTorch and CUDA.

The port of ``repro`` (JAX) to an NVIDIA H100.  The dense parse path runs
through three hand-written CUDA kernels (``kernels/``); the ``torch``
backend runs the same phases as plain tensor code on either device.

    import repro_torch

    p = repro_torch.Parser("(a|b|ab)+")                     # on the card
    r = p.parse("abab")                                     # ParseResult
    r.ok, r.count_trees(), r.matches(1), r.trees(limit=4)

    cpu = repro_torch.Parser(
        repro_torch.ParserConfig(regex="(a|b|ab)+", backend="torch"), device="cpu"
    )
"""

from .api import ParseResult, Parser, ParserConfig
from .core.engine import ParserEngine

__all__ = ["ParseResult", "Parser", "ParserConfig", "ParserEngine"]
