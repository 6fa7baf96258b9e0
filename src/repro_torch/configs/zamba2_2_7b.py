"""zamba2-2.7b [hybrid] — 54L d_model=2560 32H (GQA kv=32 → MHA shared block)
d_ff=10240 vocab=32000, ssm_state=64 — Mamba2 backbone + shared attention
blocks [arXiv:2411.15242; hf].

Simplification recorded in DESIGN §8: the published model concatenates the
original embedding into the shared block input and applies per-invocation
LoRA; we apply one weight-shared attention+MLP block every 6 Mamba2 layers
(9 applications) on the hidden stream — same compute/communication shape.

long_500k RUNS: the backbone is SSM (constant-size state); the shared
attention block uses the sequence-sharded cache (DESIGN §5).
"""

from ..models.config import ModelConfig, SSMConfig


def build() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        n_layers=54,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_ff=10240,
        vocab_size=32000,
        ssm=SSMConfig(d_state=64),
        layout=("ssm",) * 54,
        shared_attn_every=6,
        shared_attn_heads=32,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b-smoke",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=160,
        vocab_size=128,
        ssm=SSMConfig(d_state=16, head_dim=16, chunk=8),
        layout=("ssm",) * 4,
        shared_attn_every=2,
        shared_attn_heads=4,
    )
