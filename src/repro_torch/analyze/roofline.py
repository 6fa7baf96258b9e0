"""The card's machine constants and the ``Roofline`` terms built on them.

The port's copy of ``repro/analyze/roofline.py`` with an NVIDIA H100 SXM's
published figures in place of the TPU's (NVIDIA's data sheet, dense rates,
at the card's full power limit of 700 W):

    PEAK_FLOPS   989e12 bf16 FLOP/s on the tensor cores
    INT8_OPS     1979e12 int8 OP/s on the tensor cores (exact on {0, 1})
    HBM_BW       3.35e12 bytes/s of device memory
    NVLINK_BW    450e9 bytes/s each way: NVLink's 900 GB/s a card, to the
                 other cards of its host, counts both directions together
                 over all 18 links; 450 GB/s is one direction, all links

Three terms per (arch × shape × mesh), in seconds:

    compute    = flops       / (cards · PEAK_FLOPS)
    memory     = bytes       / (cards · HBM_BW)
    collective = coll_bytes  / (cards · NVLINK_BW)

The reference fills these from XLA's compiled, partitioned HLO
(``hlo_stats.py``); the port from one traced call of the eager program,
per rank (``launch/op_stats.py``): ``analyze_compiled`` turns its
``OpStats`` into a ``Roofline`` and
``collective_bytes`` reads its collectives by kind.  Its bytes are an eager
model (every ATen op reads its operands and writes its outputs: nothing is
fused) and its collectives are the ones DTensor chooses, not XLA's
partitioner's.  The dataclass, its terms and the model-FLOP helpers are
ported as they are.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Dict, Optional

from ..kernels.cost import BF16_FLOPS, F32_FLOPS, HBM_BW, INT8_OPS  # noqa: F401  (the card's rates)

PEAK_FLOPS = BF16_FLOPS      # bf16, tensor cores, dense, per card
NVLINK_BW = 450e9            # bytes/s per card, one direction over all its links


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    coll_detail: Dict[str, int] = field(default_factory=dict)
    model_flops: float = 0.0
    memory_per_device: Optional[float] = None

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / (self.chips * NVLINK_BW)

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        """model_flops / counted FLOPs: the share of the computed work that
        is the model's own (padding and recompute lower it)."""
        if self.hlo_flops <= 0:
            return 0.0
        return self.model_flops / self.hlo_flops

    @property
    def roofline_fraction(self) -> float:
        """Useful-FLOPs utilization if the dominant term were the runtime:
        (model_flops / cards / PEAK) / max(term)."""
        t = max(self.t_compute, self.t_memory, self.t_collective)
        if t <= 0:
            return 0.0
        return (self.model_flops / (self.chips * PEAK_FLOPS)) / t

    def to_dict(self) -> Dict:
        d = asdict(self)
        d.update(
            t_compute=self.t_compute,
            t_memory=self.t_memory,
            t_collective=self.t_collective,
            bottleneck=self.bottleneck,
            useful_ratio=self.useful_ratio,
            roofline_fraction=self.roofline_fraction,
        )
        return d


def model_train_flops(n_params_active: int, n_tokens: int) -> float:
    """6·N·D (fwd 2ND + bwd 4ND)."""
    return 6.0 * n_params_active * n_tokens


def model_forward_flops(n_params_active: int, n_tokens: int) -> float:
    return 2.0 * n_params_active * n_tokens


def model_attn_flops(cfg, seq_len: int, n_tokens: int, *, train: bool, decode: bool = False) -> float:
    """Quadratic attention term (not in 6·N·D; dominates at 32k+ context):
    4·T_ctx·(h·hd) per token per attention layer forward (QKᵀ + AV), ×3 for
    training (fwd+bwd).  Sliding windows cap the context; SSM layers have no
    quadratic term (their state math is inside the param count)."""
    kinds = cfg.layer_kinds
    n_attn = sum(1 for k in kinds if k in ("attn", "moe"))
    if cfg.shared_attn_every:
        n_attn += len(kinds) // cfg.shared_attn_every
    if n_attn == 0:
        return 0.0
    d_attn = cfg.n_heads * cfg.resolved_head_dim
    ctx = seq_len if cfg.sliding_window is None else min(seq_len, cfg.sliding_window)
    eff_ctx = ctx if decode else ctx / 2.0  # causal averaging over positions
    per_token = 4.0 * eff_ctx * d_attn * n_attn
    return per_token * n_tokens * (3.0 if train else 1.0)


def collective_bytes(stats) -> Dict[str, object]:
    """Output bytes of a traced program's collectives by kind, per rank, and
    their counts by kind under ``"_counts"`` (the reference's return shape,
    read from an ``OpStats`` in place of HLO text)."""
    out: Dict[str, object] = dict(stats.coll)
    out["_counts"] = dict(stats.coll_counts)
    return out


def analyze_compiled(
    stats, *, arch: str, shape: str, mesh_name: str, chips: int, model_flops: float
) -> Roofline:
    """The ``Roofline`` of one traced program (``launch/op_stats.OpStats``
    of one rank): flops, bytes and collective bytes are the rank's totals ×
    ``chips`` (DTensor programs are SPMD: every rank runs rank 0's);
    ``coll_detail`` holds the collective bytes by kind (× chips), the
    collectives a rank issues (``coll_ops_per_device``) and the modeled
    kernel launches a rank makes by kernel (``kernel_launches``, in place of
    the reference's trip-count and XLA cost keys), with their bounds'
    seconds by kernel (``kernel_bound_s``); ``memory_per_device`` is the trace's
    ``peak_bytes``."""
    return Roofline(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        chips=chips,
        hlo_flops=stats.flops * chips,
        hlo_bytes=stats.bytes * chips,
        coll_bytes=stats.coll_bytes * chips,
        coll_detail={
            **{k: v * chips for k, v in stats.coll.items()},
            "coll_ops_per_device": stats.coll_count,
            "kernel_launches": dict(stats.kernel_launches),
            "kernel_bound_s": dict(stats.kernel_bound_s),
            "dot_flops_per_device": stats.dot_flops,
        },
        model_flops=model_flops,
        memory_per_device=float(stats.peak_bytes),
    )

