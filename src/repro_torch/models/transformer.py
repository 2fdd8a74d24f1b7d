"""Dense decoder: parameter init + the block functions serving reuses.

The port's counterpart of ``repro.models.transformer`` for the dense GQA
family (with qkv bias, and gemma2's scaled embedding) and the MoE family
(``models.moe``); SSM / hybrid and encoder-decoder / VLM follow in later
slices.  Parameters are a plain dict tree in the reference's original
(head-unpermuted) layout, so trees carry across through
`repro_torch.interop` unchanged.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.moe import init_moe_params, moe_block

GLOBAL_WINDOW = 0  # sentinel: no sliding window
FAMILIES = ("dense", "moe")  # the families the port implements


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _normal(shape, std: float, gen: torch.Generator, dtype, device) -> torch.Tensor:
    # drawn directly in the target dtype: a full-width model's fp32 staging
    # copy would double peak memory during init
    return torch.randn(shape, generator=gen, dtype=dtype, device=device).mul_(std)


def _layer_params(cfg: ModelConfig, gen, dtype, device) -> dict:
    D, Hq, Hkv, Dh, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                         cfg.head_dim, cfg.d_ff)
    s = 1.0 / math.sqrt(D)
    p = {
        "ln1": torch.zeros((D,), dtype=dtype, device=device),
        "ln2": torch.zeros((D,), dtype=dtype, device=device),
        "wq": _normal((D, Hq, Dh), s, gen, dtype, device),
        "wk": _normal((D, Hkv, Dh), s, gen, dtype, device),
        "wv": _normal((D, Hkv, Dh), s, gen, dtype, device),
        "wo": _normal((Hq, Dh, D), 1.0 / math.sqrt(Hq * Dh), gen, dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((Hq, Dh), dtype=dtype, device=device)
        p["bk"] = torch.zeros((Hkv, Dh), dtype=dtype, device=device)
        p["bv"] = torch.zeros((Hkv, Dh), dtype=dtype, device=device)
    if cfg.moe.num_experts > 0:
        p.update(init_moe_params(cfg, gen, dtype, device))
    else:
        p["w1"] = _normal((D, F), s, gen, dtype, device)
        p["w3"] = _normal((D, F), s, gen, dtype, device)
        p["w2"] = _normal((F, D), 1.0 / math.sqrt(F), gen, dtype, device)
    return p


def init_params(cfg: ModelConfig, seed: int, dtype=torch.bfloat16,
                device="cuda") -> dict:
    """Original-layout parameters (heads unpermuted), drawn on ``device``
    from a ``torch.Generator`` seeded with ``seed``.  Same shapes and
    scales as the reference; not the same numbers (carry those across with
    `repro_torch.interop`)."""
    if cfg.family not in FAMILIES or cfg.attention_free:
        raise NotImplementedError(
            f"the port implements the dense and moe families only, "
            f"got {cfg.family!r} ({cfg.name})")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    D = cfg.d_model
    params: dict = {
        "embed": _normal((cfg.padded_vocab, D), 0.02, gen, dtype, device),
        "final_norm": torch.zeros((D,), dtype=dtype, device=device),
        "layers": [_layer_params(cfg, gen, dtype, device)
                   for _ in range(cfg.n_layers)],
    }
    if not cfg.tie_embeddings:
        params["head"] = _normal((cfg.padded_vocab, D), 0.02, gen, dtype, device)
    return params


def draft_view(params: dict, n_layers: int) -> dict:
    """Layer-truncated draft model for self-speculative decoding: the
    target's first ``n_layers`` blocks followed by its own final norm and
    unembedding.  The returned dict shares every tensor with ``params`` (no
    copies), so it works on original-layout and slot-layout params alike,
    and its cache writes are real target KV for those layers."""
    if not 0 < n_layers <= len(params["layers"]):
        raise ValueError(
            f"draft n_layers must be in [1, {len(params['layers'])}], "
            f"got {n_layers}")
    out = dict(params)
    out["layers"] = list(params["layers"])[:n_layers]
    return out


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def layer_window(cfg: ModelConfig, layer_idx: int) -> int:
    return cfg.sliding_window if cfg.layer_is_local(layer_idx) else GLOBAL_WINDOW


def mlp_block(pl: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The FFN: SwiGLU, or the MoE block for MoE configs (serving drops
    its aux loss)."""
    if cfg.moe.num_experts > 0:
        return moe_block(pl, h, cfg)[0]
    return L.swiglu(h, pl["w1"], pl["w3"], pl["w2"])


def embed_tokens(tokens: torch.Tensor, params: dict, cfg: ModelConfig) -> torch.Tensor:
    """Token embedding, scaled by sqrt(d_model) for gemma2 (the reference's
    rule, on the config name).  The scalar is cast to the activation dtype
    before the multiply, as the reference does: in bf16 the factor itself
    rounds (on the host: a captured step makes no host-to-device copy).
    Every path that embeds tokens goes through here."""
    h = L.embed(tokens, params["embed"])
    if cfg.name.startswith("gemma2"):
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype).item()
    return h


def embed_inputs(params: dict, batch: Dict[str, torch.Tensor],
                 cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token embedding.  Returns (h (B,T,D), positions (B,T) int32)."""
    h = embed_tokens(batch["tokens"], params, cfg)
    B, T = h.shape[:2]
    positions = torch.arange(T, dtype=torch.int32, device=h.device).expand(B, T)
    return h, positions
