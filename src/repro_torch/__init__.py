"""repro_torch — the parallel regular-expression parser in PyTorch and CUDA.

The port of ``repro`` (JAX) to an NVIDIA H100, with seven hand-written CUDA
kernels (``kernels/``).  The parse paths run through K1–K5: the dense
``cuda`` backend through K1 reach, K2 build&merge and K3 Boolean matmul, the
``packed`` and ``sparse`` backends with ``kernel=True`` through K4 / K5 and
K2; the
``torch`` backend runs the same phases as plain tensor code on either device.
The LM serving path (``models``, ``configs``, ``serve``) runs prefill through
K6 flash attention and K7 SSD chunk; decode and the RE-constrained
``ServeEngine`` / ``ContinuousBatcher`` run plain tensor code.  Training
(``train``, ``optim``, ``data``) runs ``forward_train`` through K6 and K7 as
autograd Functions (backward: a recompute of their plain versions), on one
rank.  Like the reference's, the package's top level exports the parser; the
LM and training entry points are imported from their modules.

    import repro_torch

    p = repro_torch.Parser("(a|b|ab)+")                     # on the card
    r = p.parse("abab")                                     # ParseResult
    r.ok, r.count_trees(), r.matches(1), r.trees(limit=4)
    t = p.submit("ab", deadline_s=0.5)                      # ParseTicket
    with p.open_stream() as s:                              # ParserStream
        s.append("ab"); s.edit(0, 1, "b"); s.result()
    p.stats()                                               # services, metrics, SLO
    p.analysis                                              # static AnalysisReport

    fleet = repro_torch.ParserFleet({"a": "(a|b)*abb", "b": "GET /[a-z]+"})
    fleet.parse_batch([("a", "ababb"), ("b", "GET /x")])    # one dispatch a bucket

    cpu = repro_torch.Parser(
        repro_torch.ParserConfig(regex="(a|b|ab)+", backend="torch"), device="cpu"
    )

    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params, prefill
    cfg = get_config("zamba2-2.7b")
    logits, _ = prefill(init_params(cfg, seed=0), tokens, cfg)   # K6, K7

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.config import ShapeSpec
    from repro_torch.train.loop import Trainer, TrainerConfig
    Trainer(cfg, ShapeSpec("t", 2048, 2, "train"), make_host_mesh(), "run",
            TrainerConfig(total_steps=3, checkpoint_every=0)).run()  # on the card
"""

from . import analyze, api, errors, obs
from .api import (
    ParseResult, ParseTicket, Parser, ParserConfig, ParserFleet, ParserStream, SLOTargets,
)
from .core.backend import ParserBackend, get_backend, list_backends, register_backend
from .core.engine import ParserEngine
from .core.slpf import SLPF, compress
from .obs import ObsConfig
from .errors import (
    AdmissionError,
    BudgetExceeded,
    ParseError,
    PathologicalPatternError,
    SessionNotFound,
)

# the reference's exports (``repro/__init__.py``), and the engine
__all__ = sorted([
    "AdmissionError", "BudgetExceeded", "ObsConfig", "ParseError", "ParseResult",
    "ParseTicket", "Parser", "ParserBackend", "ParserConfig", "ParserEngine", "ParserFleet",
    "ParserStream", "PathologicalPatternError", "SLOTargets", "SLPF", "SessionNotFound",
    "compress", "get_backend", "list_backends", "register_backend",
]) + ["analyze", "api", "errors", "obs"]
