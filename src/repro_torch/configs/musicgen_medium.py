"""musicgen-medium [audio] — 48L d_model=1536 24H (kv=24 → MHA) d_ff=6144
vocab=2048 — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

The EnCodec/T5 conditioning frontend is a STUB per the assignment:
``input_specs`` provides 64 precomputed conditioning frame embeddings
prepended to the EnCodec token sequence.  The published model interleaves 4
codebooks with a delay pattern; shape-wise that is a plain token stream over
vocab 2048, which is what we model (DESIGN §8).
long_500k skipped: pure full attention (DESIGN §5).
"""

from ..models.config import FrontendConfig, ModelConfig


def build() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        n_layers=48,
        d_model=1536,
        n_heads=24,
        n_kv_heads=24,
        d_ff=6144,
        vocab_size=2048,
        frontend=FrontendConfig(kind="audio", n_extra_tokens=64, feature_dim=768),
        skip_shapes=(
            ("long_500k", "pure full attention; 500k-token decode requires sub-quadratic attention"),
        ),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=160,
        vocab_size=128,
        frontend=FrontendConfig(kind="audio", n_extra_tokens=4, feature_dim=32),
    )
