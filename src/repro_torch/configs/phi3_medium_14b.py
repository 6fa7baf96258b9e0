"""phi3-medium-14b [dense] — 40L d_model=5120 40H (GQA kv=10) d_ff=17920
vocab=100352 — RoPE SwiGLU GQA [arXiv:2404.14219; unverified].

Note: phi-3-medium-128k uses LongRoPE scaling; we use plain RoPE (theta=1e4)
— positional-embedding scaling does not change shapes/FLOPs (DESIGN §8).
long_500k skipped: pure full attention (DESIGN §5).
"""

from ..models.config import ModelConfig


def build() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b",
        n_layers=40,
        d_model=5120,
        n_heads=40,
        n_kv_heads=10,
        d_ff=17920,
        vocab_size=100352,
        rope_theta=10_000.0,
        skip_shapes=(
            ("long_500k", "pure full attention; 500k-token decode requires sub-quadratic attention"),
        ),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,   # same GQA family (4:1 grouping)
        d_ff=224,
        vocab_size=128,
    )
