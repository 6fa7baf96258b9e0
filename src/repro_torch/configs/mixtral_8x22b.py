"""mixtral-8x22b [moe] — 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, SWA [arXiv:2401.04088; hf].

Expert-FFN tensor parallelism (8 experts do not divide TP=16 → experts
replicate; each expert's hidden dim shards over 'model'; DESIGN §6).
long_500k RUNS: sliding-window attention is sub-quadratic (DESIGN §5).
"""

from ..models.config import ModelConfig, MoEConfig


def build() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b",
        n_layers=56,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=16384,
        vocab_size=32768,
        sliding_window=4096,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=16384),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_ff=128,
        vocab_size=128,
        sliding_window=16,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128),
    )
