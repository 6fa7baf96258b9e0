"""h2o-danube-3-4b [dense] — 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000 — llama+mistral mix with sliding-window attention
[arXiv:2401.16818; unverified].  SWA window 4096 (mistral default).

long_500k RUNS: sliding-window attention is sub-quadratic — decode keeps a
window-sized ring-buffer cache (DESIGN §5).
"""

from ..models.config import ModelConfig


def build() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b",
        n_layers=24,
        d_model=3840,
        n_heads=32,
        n_kv_heads=8,
        d_ff=10240,
        vocab_size=32000,
        sliding_window=4096,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_ff=160,
        vocab_size=128,
        sliding_window=16,
    )
