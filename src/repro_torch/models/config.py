"""Model configuration covering all ten assigned architectures.

One ``ModelConfig`` describes a decoder LM backbone; variants are expressed by
optional sub-configs:  ``moe`` (mixtral / llama4-scout), ``ssm`` (mamba2 and the
zamba2 hybrid), ``frontend`` (internvl2 vision stub, musicgen audio stub), and
``sliding_window`` (h2o-danube3, mixtral SWA).  The per-layer ``layout`` string
list drives hybrid stacking (zamba2's shared attention block).

``ShapeSpec`` encodes the assigned input shapes.

The same dataclasses as ``repro.models.config`` (a copy: the port imports
nothing of ``repro``), so a config from either package describes one model.
The port's model runs every layer kind (``attn``, ``ssm``, ``moe``), the
zamba2 shared block, the ``frontend`` stubs and the attention logit softcap,
for serving and for training (``train/``) on one rank.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Literal, Optional, Tuple

LayerKind = Literal["attn", "ssm", "moe"]


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    shared_expert: bool = False         # llama4-style always-on shared expert
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2


@dataclass(frozen=True)
class SSMConfig:
    d_state: int
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    n_groups: int = 1
    chunk: int = 256                    # SSD chunk length (the paper's k)
    dt_min: float = 1e-3
    dt_max: float = 1e-1


@dataclass(frozen=True)
class FrontendConfig:
    kind: Literal["vision", "audio"]
    n_extra_tokens: int                 # stub embeddings prepended to the text
    feature_dim: int                    # raw stub feature dim (projected to d_model)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None      # default d_model // n_heads
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-5
    sliding_window: Optional[int] = None
    attn_logit_softcap: Optional[float] = None
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    frontend: Optional[FrontendConfig] = None
    # layout: per-layer kinds; "shared_attn_every" inserts ONE weight-shared
    # attention block after every k core layers (zamba2).
    layout: Optional[Tuple[str, ...]] = None
    shared_attn_every: Optional[int] = None
    shared_attn_heads: Optional[int] = None
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    attn_p_dtype: str = "bfloat16"   # attention probability buffers (§Perf H3)
    remat: bool = True
    # which shapes this arch skips, with the reason (recorded per DESIGN §5)
    skip_shapes: Tuple[Tuple[str, str], ...] = ()

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        if self.layout is not None:
            return self.layout
        if self.ssm is not None and self.moe is None and self.shared_attn_every is None:
            return ("ssm",) * self.n_layers
        if self.moe is not None:
            return ("moe",) * self.n_layers
        return ("attn",) * self.n_layers

    @property
    def is_attention_free(self) -> bool:
        return all(k == "ssm" for k in self.layer_kinds) and self.shared_attn_every is None

    @property
    def n_params(self) -> int:
        """Approximate parameter count (for 6·N·D roofline accounting)."""
        d, hd = self.d_model, self.resolved_head_dim
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        per_mlp = 3 * d * self.d_ff if self.d_ff else 0
        per_moe = 0
        if self.moe is not None:
            per_moe = (
                self.moe.n_experts * 3 * d * self.moe.d_ff_expert
                + d * self.moe.n_experts
                + (3 * d * self.moe.d_ff_expert if self.moe.shared_expert else 0)
            )
        per_ssm = 0
        if self.ssm is not None:
            di = self.ssm.expand * d
            nh = di // self.ssm.head_dim
            per_ssm = (
                d * (2 * di + 2 * self.ssm.n_groups * self.ssm.d_state + nh)
                + di * d + di * self.ssm.d_conv + 3 * nh
            )
        total = n
        for kind in self.layer_kinds:
            if kind == "attn":
                total += per_attn + per_mlp + 2 * d
            elif kind == "moe":
                total += per_attn + per_moe + 2 * d
            elif kind == "ssm":
                total += per_ssm + d
        if self.shared_attn_every:
            sh = self.shared_attn_heads or self.n_heads
            sd = sh * hd
            total += 2 * d * sd + 2 * d * sd + d  # q,k,v,o of the shared block
        return total

    def active_params(self) -> int:
        """Active parameters per token (MoE: routed top-k only)."""
        if self.moe is None:
            return self.n_params
        full = self.n_params
        d = self.d_model
        routed_all = self.moe.n_experts * 3 * d * self.moe.d_ff_expert
        routed_active = self.moe.top_k * 3 * d * self.moe.d_ff_expert
        n_moe = sum(1 for k in self.layer_kinds if k == "moe")
        return full - n_moe * (routed_all - routed_active)


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned (arch × shape) cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]
    microbatch: Optional[int] = None    # per-device microbatch for grad accum


SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4_096, 256, "train"),
    ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    ShapeSpec("decode_32k", 32_768, 128, "decode"),
    ShapeSpec("long_500k", 524_288, 1, "decode"),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}
