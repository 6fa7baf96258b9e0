"""internvl2-1b [vlm] — 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655
— InternViT + InternLM2(Qwen2-0.5B) backbone [arXiv:2404.16821; hf].

The InternViT vision frontend is a STUB per the assignment: ``input_specs``
provides 256 precomputed patch embeddings (1024-d InternViT features) that are
projected and prepended to the text sequence.
long_500k skipped: pure full attention (DESIGN §5).
"""

from ..models.config import FrontendConfig, ModelConfig


def build() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b",
        n_layers=24,
        d_model=896,
        n_heads=14,
        n_kv_heads=2,
        d_ff=4864,
        vocab_size=151655,
        rope_theta=1_000_000.0,
        frontend=FrontendConfig(kind="vision", n_extra_tokens=256, feature_dim=1024),
        skip_shapes=(
            ("long_500k", "pure full attention; 500k-token decode requires sub-quadratic attention"),
        ),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=7,      # same 7:1 grouping family as 14H/kv2
        n_kv_heads=1,
        d_ff=152,
        vocab_size=128,
        head_dim=16,
        frontend=FrontendConfig(kind="vision", n_extra_tokens=8, feature_dim=32),
    )
