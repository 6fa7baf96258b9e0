"""The loops that drive a traffic mix, one module a ``kind`` (``scan``, ``tail``)."""

from __future__ import annotations

import gc

import torch


def build_parser(config: dict, device, obs=None):
    """The program under test as the configuration states it: a
    ``repro_torch.Parser`` on ``device``."""
    from repro_torch import Parser, ParserConfig

    return Parser(ParserConfig(regex=config["pattern"], obs=obs, **config["parser"]), device=device)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def release(device) -> None:
    """Return what the freed program held to the device."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
