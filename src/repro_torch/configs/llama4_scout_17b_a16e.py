"""llama4-scout-17b-a16e [moe] — 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 + shared expert, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

16 experts divide TP=16 → expert parallelism over 'model' (DESIGN §6).
"Early fusion" multimodality is a frontend concern; the backbone here is the
text decoder (the assignment stubs modality frontends).
long_500k skipped: the spec'd global-attention layers make it full attention.
"""

from ..models.config import ModelConfig, MoEConfig


def build() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=202048,
        moe=MoEConfig(n_experts=16, top_k=1, d_ff_expert=8192, shared_expert=True),
        skip_shapes=(
            ("long_500k", "global-attention layers; 500k-token decode requires sub-quadratic attention"),
        ),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_ff=128,
        vocab_size=128,
        moe=MoEConfig(n_experts=4, top_k=1, d_ff_expert=128, shared_expert=True),
    )
