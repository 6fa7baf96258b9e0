"""tinyllama-1.1b [dense] — 22L d_model=2048 32H (GQA kv=4) d_ff=5632
vocab=32000 — llama2-arch small [arXiv:2401.02385; hf].
long_500k skipped: pure full attention (DESIGN §5).
"""

from ..models.config import ModelConfig


def build() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b",
        n_layers=22,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        d_ff=5632,
        vocab_size=32000,
        skip_shapes=(
            ("long_500k", "pure full attention; 500k-token decode requires sub-quadratic attention"),
        ),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=1,
        d_ff=176,
        vocab_size=128,
    )
