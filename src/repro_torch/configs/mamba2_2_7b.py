"""mamba2-2.7b [ssm] — 64L d_model=2560 (attention-free) d_ff=0 vocab=50280,
ssm_state=128 — SSD state-space duality [arXiv:2405.21060; unverified].

The SSD layer runs on the paper's chunked reach/join/build runtime
(``core/scan.py``; DESIGN §4) — the honest integration point between the
paper's parallel-FA technique and the assigned architectures.
long_500k RUNS: constant-size recurrent state (DESIGN §5).
"""

from ..models.config import ModelConfig, SSMConfig


def build() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b",
        n_layers=64,
        d_model=2560,
        n_heads=1,       # no attention layers; placeholder for config plumbing
        n_kv_heads=1,
        d_ff=0,
        vocab_size=50280,
        ssm=SSMConfig(d_state=128),
        layout=("ssm",) * 64,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=1,
        n_kv_heads=1,
        d_ff=0,
        vocab_size=128,
        ssm=SSMConfig(d_state=16, head_dim=16, chunk=8),
        layout=("ssm",) * 2,
        tie_embeddings=True,
    )
