"""Compatibility re-export, as ``repro/launch/analysis.py``: the roofline
layer lives in ``repro_torch.analyze.roofline`` (the card's constants, the
``Roofline`` dataclass and the terms of a traced program); the launch
tools' imports keep working through this module."""

from __future__ import annotations

from ..analyze.roofline import (  # noqa: F401
    HBM_BW,
    NVLINK_BW,
    PEAK_FLOPS,
    Roofline,
    analyze_compiled,
    collective_bytes,
    model_attn_flops,
    model_forward_flops,
    model_train_flops,
)

__all__ = [
    "HBM_BW",
    "NVLINK_BW",
    "PEAK_FLOPS",
    "Roofline",
    "analyze_compiled",
    "collective_bytes",
    "model_attn_flops",
    "model_forward_flops",
    "model_train_flops",
]
