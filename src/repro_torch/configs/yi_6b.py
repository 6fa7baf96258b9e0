"""yi-6b [dense] — 32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000
— llama-arch GQA [arXiv:2403.04652; hf].  RoPE theta 5e6 per the model card.
long_500k skipped: pure full attention (DESIGN §5).
"""

from ..models.config import ModelConfig


def build() -> ModelConfig:
    return ModelConfig(
        name="yi-6b",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=4,
        d_ff=11008,
        vocab_size=64000,
        rope_theta=5_000_000.0,
        skip_shapes=(
            ("long_500k", "pure full attention; 500k-token decode requires sub-quadratic attention"),
        ),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="yi-6b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=1,   # same 8:1 GQA grouping
        d_ff=176,
        vocab_size=128,
        rope_theta=5_000_000.0,
    )
