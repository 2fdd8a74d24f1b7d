"""Config system: architecture configs, input-shape registry, arch registry.

Every assigned architecture is a `ModelConfig` registered under its public id
(``--arch <id>``).  Each arch also exposes a ``smoke()`` reduced variant of the
same family (same structural features, tiny dims) used by CPU tests.

Input shapes are the four assigned cells (train_4k / prefill_32k / decode_32k /
long_500k); each arch advertises which cells apply to it (`shape_skips`).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List

# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    """One assigned (seq_len, global_batch) cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_train(self) -> bool:
        return self.kind == "train"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 0
    d_expert: int = 0  # per-expert FFN hidden size
    router_aux_coef: float = 0.01
    # per-expert token capacity = capacity_factor * T * top_k / E; overflow
    # tokens are dropped (GShard semantics).  Set to num_experts for no drops.
    capacity_factor: float = 1.25
    # beyond-paper: FairKV-style expert balancing (replicate hot experts)
    balance_experts: bool = False


@dataclass(frozen=True)
class SSMConfig:
    state_size: int = 0  # N (SSD state dim)
    num_heads: int = 0  # SSD heads
    head_dim: int = 0  # P (channels per head)
    n_groups: int = 1  # B/C groups (Mamba2 default: 1, shared across heads)
    chunk_size: int = 256
    conv_width: int = 4
    expand: int = 2

    @property
    def d_inner(self) -> int:
        return self.num_heads * self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    """Architecture config.  Field names follow the assignment table."""

    name: str
    family: str  # dense | moe | vlm | hybrid | ssm | audio
    n_layers: int
    d_model: int
    n_heads: int  # query heads (0 for attn-free)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # attention features
    qkv_bias: bool = False
    logit_softcap: float = 0.0  # gemma2 final-logit softcap
    attn_softcap: float = 0.0  # gemma2 attention softcap
    sliding_window: int = 0  # >0: local attention window
    local_global_alternate: bool = False  # gemma2: even layers local, odd global
    rope_theta: float = 10_000.0

    # norm / act
    rms_eps: float = 1e-6
    tie_embeddings: bool = False

    # mixture-of-experts (family == "moe")
    moe: MoEConfig = field(default_factory=MoEConfig)

    # state-space (family in {"ssm", "hybrid"})
    ssm: SSMConfig = field(default_factory=SSMConfig)

    # enc-dec (family == "audio")
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq_len: int = 0  # stub-frontend frame count

    # vlm (family == "vlm")
    is_vlm: bool = False
    num_image_tokens: int = 0  # stub-frontend patch-embedding count

    # which shape cells are skipped, with reasons (DESIGN.md §4)
    shape_skips: Dict[str, str] = field(default_factory=dict)

    source: str = ""  # public provenance

    # ---- derived -----------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Embedding/head rows padded to a multiple of 128 so the vocab dim
        shards on any mesh axis (MaxText-style).  Logits over pad ids are
        ignored by the loss (labels < vocab_size) and sliced off at serving
        argmax."""
        return -(-self.vocab_size // 128) * 128

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def attention_free(self) -> bool:
        return self.n_heads == 0

    def layer_is_local(self, layer_idx: int) -> bool:
        """gemma2-style alternation: even layers sliding-window, odd global."""
        if self.sliding_window <= 0:
            return False
        if self.local_global_alternate:
            return layer_idx % 2 == 0
        return True

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once if tied)."""
        d, L = self.d_model, self.n_layers
        n = 0
        # embeddings (+ untied head)
        n += self.vocab_size * d
        if not self.tie_embeddings:
            n += self.vocab_size * d
        per_layer = 0
        if not self.attention_free:
            qkv = d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
            if self.qkv_bias:
                qkv += (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
            per_layer += qkv + self.n_heads * self.head_dim * d
        if self.moe.num_experts > 0:
            per_layer += self.moe.num_experts * 3 * d * self.moe.d_expert
            per_layer += d * self.moe.num_experts  # router
        elif self.d_ff > 0:
            per_layer += 3 * d * self.d_ff  # SwiGLU
        if self.ssm.state_size > 0:
            s = self.ssm
            # in_proj (z, x, B, C, dt) + out_proj + conv + A/D
            per_layer += d * (2 * s.d_inner + 2 * s.n_groups * s.state_size + s.num_heads)
            per_layer += s.d_inner * d
            per_layer += s.conv_width * (s.d_inner + 2 * s.n_groups * s.state_size)
            per_layer += 2 * s.num_heads
        per_layer += 2 * d  # 2 RMSNorm scales
        n += L * per_layer
        if self.is_encoder_decoder:
            # encoder layers: self-attn + FFN; decoder already counted above,
            # add cross-attention for decoder layers
            enc_layer = (
                d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
                + self.n_heads * self.head_dim * d
                + 3 * d * self.d_ff
                + 2 * d
            )
            n += self.n_encoder_layers * enc_layer
            n += L * (d * (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
                      + self.n_heads * self.head_dim * d + d)
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k experts instead of all)."""
        if self.moe.num_experts == 0:
            return self.param_count()
        full = self.param_count()
        unused = (self.moe.num_experts - self.moe.top_k) * 3 * self.d_model * self.moe.d_expert
        return full - self.n_layers * unused

    def applicable_shapes(self) -> List[InputShape]:
        return [s for k, s in SHAPES.items() if k not in self.shape_skips]

    def with_overrides(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}
_SMOKE: Dict[str, Callable[[], ModelConfig]] = {}


def register(arch_id: str, full: Callable[[], ModelConfig],
             smoke: Callable[[], ModelConfig]) -> None:
    _REGISTRY[arch_id] = full
    _SMOKE[arch_id] = smoke


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]()


def get_smoke_config(arch_id: str) -> ModelConfig:
    if arch_id not in _SMOKE:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_SMOKE)}")
    return _SMOKE[arch_id]()


def list_archs() -> List[str]:
    return sorted(_REGISTRY)


FULL_ATTENTION_SKIP = (
    "long_500k needs sub-quadratic attention; this arch is pure full attention "
    "(see DESIGN.md §4)"
)
