"""Model zoo: parameter init, the block functions serving reuses, and the
training forward.

The port of ``repro.models.transformer`` for every family the reference
serves: dense GQA (with qkv bias, and gemma2's scaled embedding), MoE
(``models.moe``), the Mamba-2 SSD branch (``models.ssm``) of the SSM and
hybrid families, and the encoder, cross-attention and stub frontends of
the encoder-decoder and VLM families.  Parameters are a plain dict tree in
the reference's original (head-unpermuted) layout, with its keys and
shapes, so trees carry across through `repro_torch.interop` unchanged.
Every product that reads a weight takes it through
`repro_torch.serving.quant.operands`, so int8 serve trees run too.
`forward_train` is the reference's full-sequence causal-LM forward
(``apply_layer_full`` per layer, each under ``torch.utils.checkpoint``
with ``remat``), differentiable by ``torch.autograd``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.moe import init_moe_params, moe_block
from repro_torch.serving.quant import operands

GLOBAL_WINDOW = 0  # sentinel: no sliding window
# the families the port implements (every one the reference serves)
FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _normal(shape, std: float, gen: torch.Generator, dtype, device) -> torch.Tensor:
    # drawn directly in the target dtype: a full-width model's fp32 staging
    # copy would double peak memory during init
    return torch.randn(shape, generator=gen, dtype=dtype, device=device).mul_(std)


def _attn_params(cfg: ModelConfig, gen, dtype, device, prefix: str = "") -> dict:
    D, Hq, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = 1.0 / math.sqrt(D)
    p = {
        "wq": _normal((D, Hq, Dh), s, gen, dtype, device),
        "wk": _normal((D, Hkv, Dh), s, gen, dtype, device),
        "wv": _normal((D, Hkv, Dh), s, gen, dtype, device),
        "wo": _normal((Hq, Dh, D), 1.0 / math.sqrt(Hq * Dh), gen, dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((Hq, Dh), dtype=dtype, device=device)
        p["bk"] = torch.zeros((Hkv, Dh), dtype=dtype, device=device)
        p["bv"] = torch.zeros((Hkv, Dh), dtype=dtype, device=device)
    return {prefix + k: v for k, v in p.items()}


def _ssm_params(cfg: ModelConfig, gen, dtype, device) -> dict:
    """The SSD branch: in_proj to (z, x, B, C, dt), the depthwise conv, the
    decay / skip / dt-bias vectors (fp32, zero / one as the reference
    initialises them), the gated norm and out_proj."""
    s, D = cfg.ssm, cfg.d_model
    d_in = s.d_inner
    proj = 2 * d_in + 2 * s.n_groups * s.state_size + s.num_heads
    conv_dim = d_in + 2 * s.n_groups * s.state_size
    H = s.num_heads
    return {
        "in_proj": _normal((D, proj), 1.0 / math.sqrt(D), gen, dtype, device),
        "conv_w": _normal((s.conv_width, conv_dim), 0.1, gen, dtype, device),
        "A_log": torch.zeros((H,), dtype=torch.float32, device=device),
        "ssm_D": torch.ones((H,), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=device),
        "ssm_norm": torch.zeros((d_in,), dtype=dtype, device=device),
        "out_proj": _normal((d_in, D), 1.0 / math.sqrt(d_in), gen, dtype, device),
    }


def _layer_params(cfg: ModelConfig, gen, dtype, device, cross_attn: bool = False) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    s = 1.0 / math.sqrt(D)
    p = {
        "ln1": torch.zeros((D,), dtype=dtype, device=device),
        "ln2": torch.zeros((D,), dtype=dtype, device=device),
    }
    if not cfg.attention_free:
        p.update(_attn_params(cfg, gen, dtype, device))
    if cfg.family in ("ssm", "hybrid"):
        p.update(_ssm_params(cfg, gen, dtype, device))
    if cfg.family == "hybrid":
        # per-branch output norms; the reference reads only attn_out_norm
        p["attn_out_norm"] = torch.zeros((cfg.n_heads * cfg.head_dim,), dtype=dtype,
                                         device=device)
        p["ssm_out_norm"] = torch.zeros((cfg.ssm.d_inner,), dtype=dtype, device=device)
    if cfg.moe.num_experts > 0:
        p.update(init_moe_params(cfg, gen, dtype, device))
    elif F > 0:
        p["w1"] = _normal((D, F), s, gen, dtype, device)
        p["w3"] = _normal((D, F), s, gen, dtype, device)
        p["w2"] = _normal((F, D), 1.0 / math.sqrt(F), gen, dtype, device)
    if cross_attn:
        p.update(_attn_params(cfg, gen, dtype, device, prefix="c_"))
        p["ln_cross"] = torch.zeros((D,), dtype=dtype, device=device)
    return p


def init_params(cfg: ModelConfig, seed: int, dtype=torch.bfloat16,
                device="cuda", max_seq_len: int = 4096) -> dict:
    """Original-layout parameters (heads unpermuted), drawn on ``device``
    from a ``torch.Generator`` seeded with ``seed``.  Same keys, shapes and
    scales as the reference (``max_seq_len`` sizes an encoder-decoder's
    ``dec_pos``); not the same numbers (carry those across with
    `repro_torch.interop`)."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"unknown family {cfg.family!r} ({cfg.name})")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    D = cfg.d_model
    params: dict = {
        "embed": _normal((cfg.padded_vocab, D), 0.02, gen, dtype, device),
        "final_norm": torch.zeros((D,), dtype=dtype, device=device),
        "layers": [_layer_params(cfg, gen, dtype, device, cross_attn=cfg.is_encoder_decoder)
                   for _ in range(cfg.n_layers)],
    }
    if not cfg.tie_embeddings:
        params["head"] = _normal((cfg.padded_vocab, D), 0.02, gen, dtype, device)
    if cfg.is_encoder_decoder:
        params["enc_layers"] = [_layer_params(cfg, gen, dtype, device)
                                for _ in range(cfg.n_encoder_layers)]
        params["enc_final_norm"] = torch.zeros((D,), dtype=dtype, device=device)
        params["enc_pos"] = _normal((cfg.encoder_seq_len, D), 0.02, gen, dtype, device)
        params["dec_pos"] = _normal((max_seq_len, D), 0.02, gen, dtype, device)
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


def mlp_block(pl: dict, h: torch.Tensor, cfg: ModelConfig, shards=None) -> torch.Tensor:
    """The FFN: SwiGLU, or the MoE block for MoE configs (serving drops
    its aux loss).  ``shards``: a rank's shard of either (`L.swiglu` over
    ``ff``, `moe_block`'s expert parallelism over ``expert``)."""
    if cfg.moe.num_experts > 0:
        return moe_block(pl, h, cfg, shards)[0]
    return L.swiglu(h, pl["w1"], pl["w3"], pl["w2"], shards)


def embed_tokens(tokens: torch.Tensor, params: dict, cfg: ModelConfig,
                 shards=None) -> torch.Tensor:
    """Token embedding, scaled by sqrt(d_model) for gemma2 (the reference's
    rule, on the config name).  The scalar is cast to the activation dtype
    before the multiply, as the reference does: in bf16 the factor itself
    rounds (on the host: a captured step makes no host-to-device copy).
    Every path that embeds tokens goes through here; ``shards``: over a
    rank's vocab shard (`L.embed`)."""
    h = L.embed(tokens, params["embed"], shards)
    if cfg.name.startswith("gemma2"):
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype).item()
    return h


def embed_inputs(params: dict, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                 shards=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token embedding, after a VLM's ``image_embeds`` prefix (B, I, D),
    plus an encoder-decoder's learned ``dec_pos``.  Returns (h (B, T, D),
    positions (B, T) int32).  ``shards``: `embed_tokens`'."""
    h = embed_tokens(batch["tokens"], params, cfg, shards)
    if cfg.is_vlm:
        h = torch.cat([batch["image_embeds"].to(h.dtype), h], dim=1)
    if cfg.is_encoder_decoder:
        h = h + params["dec_pos"][None, :h.shape[1]]
    B, T = h.shape[:2]
    positions = torch.arange(T, dtype=torch.int32, device=h.device).expand(B, T)
    return h, positions


# ---------------------------------------------------------------------------
# SSD branch (SSM / hybrid)
# ---------------------------------------------------------------------------


def ssm_split(pl: dict, h: torch.Tensor, cfg: ModelConfig):
    """in_proj → (z, xBC (the conv input), dt (B, T, H) fp32 post-softplus)."""
    s = cfg.ssm
    d_in, G, N = s.d_inner, s.n_groups, s.state_size
    x, w = operands(h, pl["in_proj"])
    proj = x @ w  # (B, T, 2 d_in + 2 G N + H)
    z, xBC, dt_raw = torch.split(proj, [d_in, d_in + 2 * G * N, s.num_heads], dim=-1)
    dt = torch.nn.functional.softplus(dt_raw.float() + pl["dt_bias"])
    return z, xBC, dt


def ssm_out(pl: dict, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The gated norm and out_proj: rms_norm(y · silu(z)) @ out_proj."""
    y, w = operands(L.rms_norm(y * torch.nn.functional.silu(z), pl["ssm_norm"]),
                    pl["out_proj"])
    return y @ w


def ssm_block_full(pl: dict, h: torch.Tensor, cfg: ModelConfig,
                   conv_state: Optional[torch.Tensor] = None,
                   init_state: Optional[torch.Tensor] = None):
    """Full-sequence SSD branch.  Returns (out (B, T, D), (conv_state
    (B, W-1, conv_dim), ssm_state (B, H, P, N) fp32))."""
    s = cfg.ssm
    d_in, G, N, H, P = s.d_inner, s.n_groups, s.state_size, s.num_heads, s.head_dim
    B, T, _ = h.shape
    z, xBC, dt = ssm_split(pl, h, cfg)
    xBC, conv_out = S.conv1d_causal(xBC, pl["conv_w"], conv_state)
    xBC = torch.nn.functional.silu(xBC)
    x, B_, C_ = torch.split(xBC, [d_in, G * N, G * N], dim=-1)
    y, state = S.ssd_chunked(x.reshape(B, T, H, P), dt, pl["A_log"],
                             B_.reshape(B, T, G, N), C_.reshape(B, T, G, N), pl["ssm_D"],
                             chunk=s.chunk_size, init_state=init_state)
    return ssm_out(pl, y.reshape(B, T, d_in), z), (conv_out, state)


# ---------------------------------------------------------------------------
# Encoder and cross-attention (encoder-decoder)
# ---------------------------------------------------------------------------


def qkv_proj(pl: dict, h: torch.Tensor, cfg: ModelConfig, prefix: str = ""):
    """(B, T, D) → q (B, T, Hq, Dh), k / v (B, T, Hkv, Dh), pre-RoPE."""
    q = torch.einsum("btd,dhx->bthx", *operands(h, pl[prefix + "wq"]))
    k = torch.einsum("btd,dhx->bthx", *operands(h, pl[prefix + "wk"]))
    v = torch.einsum("btd,dhx->bthx", *operands(h, pl[prefix + "wv"]))
    if cfg.qkv_bias and (prefix + "bq") in pl:
        q, k, v = q + pl[prefix + "bq"], k + pl[prefix + "bk"], v + pl[prefix + "bv"]
    return q, k, v


def o_proj(pl: dict, attn_flat: torch.Tensor, cfg: ModelConfig, prefix: str = "") -> torch.Tensor:
    x, wo = operands(attn_flat, pl[prefix + "wo"])
    return torch.einsum("bte,ed->btd", x, wo.reshape(cfg.n_heads * cfg.head_dim, cfg.d_model))


def cross_attn_block(pl: dict, h: torch.Tensor, enc_kv: Tuple[torch.Tensor, torch.Tensor],
                     cfg: ModelConfig) -> torch.Tensor:
    """Decoder cross-attention onto precomputed encoder K/V (no RoPE, no
    mask)."""
    B, T, _ = h.shape
    q = torch.einsum("btd,dhx->bthx", *operands(h, pl["c_wq"]))
    k, v = enc_kv
    pos_q = torch.zeros((B, T), dtype=torch.int32, device=h.device)
    pos_k = torch.zeros((B, k.shape[1]), dtype=torch.int32, device=h.device)
    out = L.attention(q, k, v, pos_q, pos_k, causal=False)
    return o_proj(pl, out.reshape(B, T, cfg.n_heads * cfg.head_dim), cfg, prefix="c_")


def encode(params: dict, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The encoder over stub-frontend frame embeddings (B, T_enc, D)."""
    h = frames.to(params["enc_pos"].dtype) + params["enc_pos"][None, :frames.shape[1]]
    B, T = h.shape[:2]
    positions = torch.arange(T, dtype=torch.int32, device=h.device).expand(B, T)
    for pl in params["enc_layers"]:
        hn = L.rms_norm(h, pl["ln1"], cfg.rms_eps)
        q, k, v = qkv_proj(pl, hn, cfg)
        out = L.attention(q, k, v, positions, positions, causal=False)
        h = h + o_proj(pl, out.reshape(B, T, -1), cfg)
        hn2 = L.rms_norm(h, pl["ln2"], cfg.rms_eps)
        h = h + L.swiglu(hn2, pl["w1"], pl["w3"], pl["w2"])
    return L.rms_norm(h, params["enc_final_norm"], cfg.rms_eps)


def encoder_cross_kv(params: dict, enc_out: torch.Tensor, cfg: ModelConfig):
    """Per decoder layer, the cross K / V (B, T_enc, Hkv, Dh) of the
    encoder output."""
    kvs = []
    for pl in params["layers"]:
        k = torch.einsum("btd,dhx->bthx", *operands(enc_out, pl["c_wk"]))
        v = torch.einsum("btd,dhx->bthx", *operands(enc_out, pl["c_wv"]))
        if cfg.qkv_bias and "c_bk" in pl:
            k, v = k + pl["c_bk"], v + pl["c_bv"]
        kvs.append((k, v))
    return kvs


# ---------------------------------------------------------------------------
# Training forward (full sequence, original layout)
# ---------------------------------------------------------------------------


def attn_block_full(pl: dict, h: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
                    layer_idx: int, kv_mask: Optional[torch.Tensor] = None,
                    return_kv: bool = False):
    """Full-sequence causal attention over a normed (B, T, D) input.
    Returns (attn_out_flat (B, T, Hq·Dh), (k_rot, v) if ``return_kv``)."""
    q, k, v = qkv_proj(pl, h, cfg)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    out = L.attention(q, k, v, positions, positions, window=layer_window(cfg, layer_idx),
                      attn_cap=cfg.attn_softcap, kv_mask=kv_mask, causal=True)
    B, T = h.shape[:2]
    out = out.reshape(B, T, cfg.n_heads * cfg.head_dim)
    return out, ((k, v) if return_kv else None)


def apply_layer_full(pl: dict, h: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
                     layer_idx: int, enc_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                     kv_mask: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer over the full sequence.  Returns (h, aux loss):
    MoE's Switch load-balancing loss, 0 for the other families."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    hn = L.rms_norm(h, pl["ln1"], cfg.rms_eps)
    if cfg.family == "hybrid":
        attn_flat, _ = attn_block_full(pl, hn, positions, cfg, layer_idx, kv_mask)
        attn_out = o_proj(pl, L.rms_norm(attn_flat, pl["attn_out_norm"], cfg.rms_eps), cfg)
        ssm_out, _ = ssm_block_full(pl, hn, cfg)
        h = h + 0.5 * (attn_out + ssm_out)
    elif cfg.family == "ssm":
        h = h + ssm_block_full(pl, hn, cfg)[0]
    elif not cfg.attention_free:
        attn_flat, _ = attn_block_full(pl, hn, positions, cfg, layer_idx, kv_mask)
        h = h + o_proj(pl, attn_flat, cfg)
    if enc_kv is not None:
        hc = L.rms_norm(h, pl["ln_cross"], cfg.rms_eps)
        h = h + cross_attn_block(pl, hc, enc_kv, cfg)
    if cfg.d_ff > 0 or cfg.moe.num_experts > 0:
        hn2 = L.rms_norm(h, pl["ln2"], cfg.rms_eps)
        if cfg.moe.num_experts > 0:
            mlp_out, aux = moe_block(pl, hn2, cfg)
        else:
            mlp_out = L.swiglu(hn2, pl["w1"], pl["w3"], pl["w2"])
        h = h + mlp_out
    return h, aux


def forward_train(params: dict, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                  remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal-LM (or encoder-decoder) logits.  Returns (logits (B, S, V)
    fp32, the summed aux loss).  A VLM's image positions are cut from the
    logits (they carry no next-token loss).  With ``remat`` each layer
    runs under ``torch.utils.checkpoint`` (non-reentrant): its activations
    are recomputed in the backward instead of stored."""
    h, positions = embed_inputs(params, batch, cfg)
    enc_kvs = None
    if cfg.is_encoder_decoder:
        enc_kvs = encoder_cross_kv(params, encode(params, batch["frames"], cfg), cfg)
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i, pl in enumerate(params["layers"]):
        enc_kv = enc_kvs[i] if enc_kvs is not None else None
        if remat:
            h, aux = checkpoint(apply_layer_full, pl, h, positions, cfg, i, enc_kv,
                                use_reentrant=False)
        else:
            h, aux = apply_layer_full(pl, h, positions, cfg, i, enc_kv)
        aux_total = aux_total + aux
    h = L.rms_norm(h, params["final_norm"], cfg.rms_eps)
    logits = L.unembed(h, params.get("head", params["embed"]), cfg.logit_softcap)
    if cfg.is_vlm:
        logits = logits[:, batch["image_embeds"].shape[1]:]
    return logits, aux_total
