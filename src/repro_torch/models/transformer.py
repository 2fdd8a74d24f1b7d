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

On a train step's shards (``shards``, a
`repro_torch.distributed.sharding.TrainShards`: the train cells' step
under ``train_rules``) the same functions run the reference's layout
explicitly.  The residual stream between layers is the rank's slice of the
sequence (B/data, T/model, D), written by the embedding's reduce-scatter
over ``model``; ``ln1`` / ``ln2`` run on the slice; attention is
sequence-parallel: ``q`` from the slice at its global positions, ``k`` /
``v`` from the normed input all-gathered over ``model``, the output over
the slice's queries, ``o_proj`` added to the slice with no collective; the
MLP reads the all-gathered ``hn2`` over its ``ff`` columns and its partial
output is reduce-scattered onto the slice.  Every weight is all-gathered
over ``data`` (FSDP) right before its product, inside the layer's remat
region, so the backward's recompute gathers it again and no layer's
gathered weights outlive it.  The logits are the rank's vocab columns of
the whole sequence (``final_norm`` on the slice, then gathered).  The
other families: the MoE block runs expert parallel on the gathered
``hn2`` (`repro_torch.models.moe`); the SSD branch scans the gathered
normed input on its own splits (the recurrence crosses the slices' edges;
the hybrid's attention reads the same gather) and ``out_proj``'s partial
product is reduce-scattered onto the slice; an encoder runs over the
rank's rows' whole frames, its MLP's partial sums all-reduced, and cross
attention reads its K / V from the decoder's slice; a VLM's image prefix
and text are cut into the slices together (`embed_inputs`).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import comm
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
    Every path that embeds tokens goes through here but a VLM's train
    step on a split sequence (`embed_inputs`); ``shards``: over a rank's
    vocab shard (`L.embed`)."""
    h = L.embed(tokens, params["embed"], shards)
    if cfg.name.startswith("gemma2"):
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype).item()
    return h


def embed_inputs(params: dict, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                 shards=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token embedding, after a VLM's ``image_embeds`` prefix (B, I, D),
    plus an encoder-decoder's learned ``dec_pos``.  Returns (h (B, T, D),
    positions (B, T) int32).  ``shards``: `embed_tokens`'; on a train
    step's shards h is the rank's slice of the sequence (a VLM's prefix ‖
    text: the image rows ride the first vocab rank's partial rows into the
    reduce-scatter that cuts the slice), ``dec_pos`` is read at the slice's
    global positions and the positions are those."""
    if cfg.is_vlm and shards is not None and shards.seq.group is not None:
        prefix = batch["image_embeds"].to(params["embed"].dtype)
        h = L.embed(batch["tokens"], params["embed"], shards, prefix=prefix)
    else:
        h = embed_tokens(batch["tokens"], params, cfg, shards)
        if cfg.is_vlm:
            h = torch.cat([batch["image_embeds"].to(h.dtype), h], dim=1)
    B, T = h.shape[:2]
    t0 = 0 if shards is None else shards.seq.offset(T)
    if cfg.is_encoder_decoder:
        h = h + params["dec_pos"][None, t0:t0 + T]
    positions = torch.arange(t0, t0 + T, dtype=torch.int32, device=h.device).expand(B, T)
    return h, positions


# ---------------------------------------------------------------------------
# SSD branch (SSM / hybrid)
# ---------------------------------------------------------------------------
#
# On a rank's shards (``shards``, a `repro_torch.distributed.sharding.
# StepShards`) each dim reads its own split: ``in_proj``'s columns
# (``ssm_proj``: the product's columns are all-gathered, whatever the z |
# xBC | dt boundaries they cut), the conv's channels (``ssm_conv``: the
# rank convolves its channels with its ``conv_w`` and conv-window shards,
# and the activated output is all-gathered), the SSD heads (``ssm_heads``:
# the scan runs over the rank's heads and their ``ssm_state`` shard) and
# ``out_proj``'s rows (``ssm_inner``: its partial product is all-reduced).
# The gated norm spans the whole d_inner: its Σ is all-reduced over the
# heads' group when y holds the rank's heads only; when the heads stay
# whole every rank updates the whole state alike and y is cut to the
# rank's ``out_proj`` rows.


def _w(pl: dict, key: str, shards, d_dim: int):
    """``pl[key]``, under ``weights_2d`` gathered whole along its d_model dim."""
    return pl[key] if shards is None else shards.weight(pl[key], d_dim)


def ssm_split(pl: dict, h: torch.Tensor, cfg: ModelConfig, shards=None):
    """in_proj → (z, xBC (the conv input), dt (B, T, H) fp32 post-softplus),
    whole on every rank."""
    s = cfg.ssm
    d_in, G, N = s.d_inner, s.n_groups, s.state_size
    x, w = operands(h, _w(pl, "in_proj", shards, 0))
    proj = x @ w  # (B, T, 2 d_in + 2 G N + H), or the rank's columns of it
    if shards is not None:
        proj = shards.gather(proj, shards.ssm_proj, -1)
    z, xBC, dt_raw = torch.split(proj, [d_in, d_in + 2 * G * N, s.num_heads], dim=-1)
    dt = torch.nn.functional.softplus(dt_raw.float() + pl["dt_bias"])
    return z, xBC, dt


def ssm_conv(pl: dict, xBC: torch.Tensor, conv_state: Optional[torch.Tensor] = None,
             shards=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The depthwise causal conv and its SiLU.  Returns (the activated conv
    output over every channel, the new conv window: the rank's channels
    under ``shards``)."""
    sp = None if shards is None else shards.ssm_conv
    if sp is None or sp.group is None:
        y, window = S.conv1d_causal(xBC, pl["conv_w"], conv_state)
        return torch.nn.functional.silu(y), window
    n = pl["conv_w"].shape[1]
    c0 = sp.offset(n)
    y, window = S.conv1d_causal(xBC[..., c0:c0 + n], pl["conv_w"], conv_state)
    return shards.gather(torch.nn.functional.silu(y), sp, -1), window


def ssd_inputs(pl: dict, xBC: torch.Tensor, dt: torch.Tensor, cfg: ModelConfig, shards=None):
    """The scan's operands of the rank's SSD heads from the activated conv
    output (..., conv_dim) and dt (..., H): (x (..., H_l, P), dt, A_log, B
    (..., G_l, N), C, D, the first head).  A split whose heads cut a B / C
    group raises."""
    s = cfg.ssm
    d_in, G, N, H, P = s.d_inner, s.n_groups, s.state_size, s.num_heads, s.head_dim
    lead = xBC.shape[:-1]
    x, B_, C_ = torch.split(xBC, [d_in, G * N, G * N], dim=-1)
    x, B_, C_ = x.reshape(*lead, H, P), B_.reshape(*lead, G, N), C_.reshape(*lead, G, N)
    sp = None if shards is None else shards.ssm_heads
    if sp is None or sp.group is None or sp.size == 1:
        return x, dt, pl["A_log"], B_, C_, pl["ssm_D"], 0
    n = H // sp.size
    h0, rep = sp.offset(n), H // G
    if n % rep and rep % n:
        raise ValueError(f"{n} SSD heads a rank cut the B / C groups of {rep} heads")
    g0, g1 = h0 // rep, -(-(h0 + n) // rep)
    hs = slice(h0, h0 + n)
    return (x[..., hs, :], dt[..., hs], pl["A_log"][hs], B_[..., g0:g1, :], C_[..., g0:g1, :],
            pl["ssm_D"][hs], h0)


def ssm_out(pl: dict, y: torch.Tensor, z: torch.Tensor, shards=None,
            c0: int = 0) -> torch.Tensor:
    """The gated norm and out_proj: rms_norm(y · silu(z)) @ out_proj.  ``y``
    holds d_inner channels [c0, c0 + n) (the rank's SSD heads), ``z`` all
    of them; ``shards``: the norm's Σ all-reduced over the heads' group
    when y is a slice, the rank's ``out_proj`` rows, their partial product
    all-reduced."""
    d_in, n = z.shape[-1], y.shape[-1]
    if n == d_in:
        g = L.rms_norm(y * torch.nn.functional.silu(z), pl["ssm_norm"])
    else:
        g = (y * torch.nn.functional.silu(z[..., c0:c0 + n])).float()
        ss = shards.psum((g * g).sum(dim=-1, keepdim=True), shards.ssm_heads)
        g = (g * torch.rsqrt(ss / d_in + 1e-6)
             * (1.0 + pl["ssm_norm"][c0:c0 + n].float())).to(y.dtype)
    sp = None if shards is None else shards.ssm_inner
    if sp is not None and sp.group is not None and g.shape[-1] == d_in:
        rows = d_in // sp.size
        g = g[..., sp.offset(rows):sp.offset(rows) + rows]
    x, w = operands(g, _w(pl, "out_proj", shards, 1))
    out = x @ w
    return out if sp is None else shards.sum_partial(out, sp)


def ssm_block_full(pl: dict, h: torch.Tensor, cfg: ModelConfig,
                   conv_state: Optional[torch.Tensor] = None,
                   init_state: Optional[torch.Tensor] = None, shards=None):
    """Full-sequence SSD branch.  Returns (out (B, T, D), (conv_state
    (B, W-1, conv_dim), ssm_state (B, H, P, N) fp32)): on ``shards`` the
    rank's conv channels and SSD heads of the two states."""
    s = cfg.ssm
    B, T, _ = h.shape
    z, xBC, dt = ssm_split(pl, h, cfg, shards)
    xBC, conv_out = ssm_conv(pl, xBC, conv_state, shards)
    x, dt, A_log, B_, C_, D_, h0 = ssd_inputs(pl, xBC, dt, cfg, shards)
    y, state = S.ssd_chunked(x, dt, A_log, B_, C_, D_, chunk=s.chunk_size,
                             init_state=init_state)
    return ssm_out(pl, y.reshape(B, T, -1), z, shards, h0 * s.head_dim), (conv_out, state)


# ---------------------------------------------------------------------------
# Encoder and cross-attention (encoder-decoder)
# ---------------------------------------------------------------------------
#
# On a rank's shards attention runs over the rank's query ``heads`` with
# its ``kv_heads``' K / V (where the query heads split and the K / V heads
# stay whole, the rank takes its query heads' K / V heads from the whole
# tensor), and the o-projection's partial product over its heads is
# all-reduced over their group.


def qkv_proj(pl: dict, h: torch.Tensor, cfg: ModelConfig, prefix: str = "", shards=None,
             h_kv: Optional[torch.Tensor] = None):
    """(B, T, D) → q (B, T, Hq, Dh), k / v (B, T, Hkv, Dh), pre-RoPE: the
    rank's heads of each under ``shards``.  ``h_kv``: the input of k and v
    when it is not ``h`` (sequence-parallel attention: the whole sequence
    beside the rank's slice)."""
    h_kv = h if h_kv is None else h_kv
    q = torch.einsum("btd,dhx->bthx", *operands(h, _w(pl, prefix + "wq", shards, 0)))
    k = torch.einsum("btd,dhx->bthx", *operands(h_kv, _w(pl, prefix + "wk", shards, 0)))
    v = torch.einsum("btd,dhx->bthx", *operands(h_kv, _w(pl, prefix + "wv", shards, 0)))
    if cfg.qkv_bias and (prefix + "bq") in pl:
        q, k, v = q + pl[prefix + "bq"], k + pl[prefix + "bk"], v + pl[prefix + "bv"]
    return q, k, v


def kv_for_heads(k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig, shards=None):
    """K / V (B, T, Hkv_l, Dh) for the rank's query heads: where the query
    heads split and the K / V heads stay whole, each query head's own K / V
    head from the whole tensor (one per query head); else as given."""
    if shards is None or shards.heads.group is None or shards.kv_heads.group is not None:
        return k, v
    n = cfg.n_heads // shards.heads.size
    q0 = shards.heads.offset(n)
    idx = torch.arange(q0, q0 + n, device=k.device) // cfg.q_per_kv
    return k[:, :, idx], v[:, :, idx]


def o_proj(pl: dict, attn_flat: torch.Tensor, cfg: ModelConfig, prefix: str = "",
           shards=None) -> torch.Tensor:
    """(B, T, Hq_l·Dh) → (B, T, D); on ``shards`` the partial product over
    the rank's heads, all-reduced over their group."""
    x, wo = operands(attn_flat, _w(pl, prefix + "wo", shards, 2))
    out = torch.einsum("bte,ed->btd", x, wo.reshape(-1, wo.shape[-1]))
    if shards is not None and shards.heads.group is not None:
        out = comm.all_reduce_sum(out, shards.heads.group)
    return out


def cross_attn_block(pl: dict, h: torch.Tensor, enc_kv: Tuple[torch.Tensor, torch.Tensor],
                     cfg: ModelConfig, shards=None) -> torch.Tensor:
    """Decoder cross-attention onto precomputed encoder K/V (no RoPE, no
    mask); on ``shards`` over the rank's heads, ``enc_kv`` its K / V heads."""
    B, T, _ = h.shape
    q = torch.einsum("btd,dhx->bthx", *operands(h, _w(pl, "c_wq", shards, 0)))
    k, v = kv_for_heads(*enc_kv, cfg, shards)
    pos_q = torch.zeros((B, T), dtype=torch.int32, device=h.device)
    pos_k = torch.zeros((B, k.shape[1]), dtype=torch.int32, device=h.device)
    out = L.attention(q, k, v, pos_q, pos_k, causal=False)
    return o_proj(pl, out.reshape(B, T, -1), cfg, "c_", shards)


def encode(params: dict, frames: torch.Tensor, cfg: ModelConfig, shards=None) -> torch.Tensor:
    """The encoder over stub-frontend frame embeddings (B, T_enc, D); on
    ``shards`` its attention over the rank's heads and its SwiGLU over the
    rank's ``ff`` shard, each summed over their group."""
    h = frames.to(params["enc_pos"].dtype) + params["enc_pos"][None, :frames.shape[1]]
    B, T = h.shape[:2]
    positions = torch.arange(T, dtype=torch.int32, device=h.device).expand(B, T)
    for pl in params["enc_layers"]:
        hn = L.rms_norm(h, pl["ln1"], cfg.rms_eps)
        q, k, v = qkv_proj(pl, hn, cfg, shards=shards)
        k, v = kv_for_heads(k, v, cfg, shards)
        out = L.attention(q, k, v, positions, positions, causal=False)
        h = h + o_proj(pl, out.reshape(B, T, -1), cfg, shards=shards)
        hn2 = L.rms_norm(h, pl["ln2"], cfg.rms_eps)
        h = h + L.swiglu(hn2, pl["w1"], pl["w3"], pl["w2"], shards)
    return L.rms_norm(h, params["enc_final_norm"], cfg.rms_eps)


def encoder_cross_kv(params: dict, enc_out: torch.Tensor, cfg: ModelConfig, shards=None):
    """Per decoder layer, the cross K / V (B, T_enc, Hkv, Dh) of the
    encoder output: the rank's ``kv_heads`` on ``shards``."""
    kvs = []
    for pl in params["layers"]:
        k = torch.einsum("btd,dhx->bthx", *operands(enc_out, _w(pl, "c_wk", shards, 0)))
        v = torch.einsum("btd,dhx->bthx", *operands(enc_out, _w(pl, "c_wv", shards, 0)))
        if cfg.qkv_bias and "c_bk" in pl:
            k, v = k + pl["c_bk"], v + pl["c_bv"]
        kvs.append((k, v))
    return kvs


# ---------------------------------------------------------------------------
# Training forward (full sequence, original layout)
# ---------------------------------------------------------------------------


def attn_block_full(pl: dict, h: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
                    layer_idx: int, kv_mask: Optional[torch.Tensor] = None,
                    return_kv: bool = False, shards=None, h_all: Optional[torch.Tensor] = None):
    """Full-sequence causal attention over a normed (B, T, D) input.
    Returns (attn_out_flat (B, T, Hq·Dh), (k_rot, v) if ``return_kv``).
    On a train step's shards ``h`` is the rank's slice at ``positions``:
    its queries attend to the whole sequence, gathered over ``model``
    (``h_all`` when the caller has gathered it), and the weights are
    FSDP-gathered (the module docstring)."""
    h_kv, k_pos = h, positions
    if shards is not None and shards.seq.group is not None:
        h_kv = shards.gather_seq(h) if h_all is None else h_all
        k_pos = torch.arange(h_kv.shape[1], dtype=positions.dtype,
                             device=h.device).expand(h.shape[0], -1)
    q, k, v = qkv_proj(pl, h, cfg, shards=shards, h_kv=h_kv)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, k_pos, cfg.rope_theta)
    out = L.attention(q, k, v, positions, k_pos, window=layer_window(cfg, layer_idx),
                      attn_cap=cfg.attn_softcap, kv_mask=kv_mask, causal=True)
    B, T = h.shape[:2]
    out = out.reshape(B, T, cfg.n_heads * cfg.head_dim)
    return out, ((k, v) if return_kv else None)


def apply_layer_full(pl: dict, h: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
                     layer_idx: int, enc_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                     kv_mask: Optional[torch.Tensor] = None, shards=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer over the full sequence.  Returns (h, aux loss):
    MoE's Switch load-balancing loss, 0 for the other families.  On a
    train step's shards ``h`` is the rank's slice of the residual stream,
    in and out (the module docstring)."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    hn = L.rms_norm(h, pl["ln1"], cfg.rms_eps)
    if cfg.family in ("ssm", "hybrid"):
        # the SSD recurrence crosses the sequence slices' edges: it scans
        # the whole sequence (the hybrid's attention reads the same gather)
        hn_all = hn if shards is None else shards.gather_seq(hn)
    if cfg.family == "hybrid":
        attn_flat, _ = attn_block_full(pl, hn, positions, cfg, layer_idx, kv_mask,
                                       shards=shards, h_all=hn_all)
        attn_out = o_proj(pl, L.rms_norm(attn_flat, pl["attn_out_norm"], cfg.rms_eps), cfg,
                          shards=shards)
        ssm_out, _ = ssm_block_full(pl, hn_all, cfg, shards=shards)
        h = h + 0.5 * (attn_out + ssm_out)
    elif cfg.family == "ssm":
        h = h + ssm_block_full(pl, hn_all, cfg, shards=shards)[0]
    elif not cfg.attention_free:
        attn_flat, _ = attn_block_full(pl, hn, positions, cfg, layer_idx, kv_mask,
                                       shards=shards)
        h = h + o_proj(pl, attn_flat, cfg, shards=shards)
    if enc_kv is not None:
        hc = L.rms_norm(h, pl["ln_cross"], cfg.rms_eps)
        h = h + cross_attn_block(pl, hc, enc_kv, cfg, shards)
    if cfg.d_ff > 0 or cfg.moe.num_experts > 0:
        hn2 = L.rms_norm(h, pl["ln2"], cfg.rms_eps)
        if shards is not None:
            hn2 = shards.gather_seq(hn2)
        if cfg.moe.num_experts > 0:
            mlp_out, aux = moe_block(pl, hn2, cfg, shards)
        else:
            mlp_out = L.swiglu(hn2, pl["w1"], pl["w3"], pl["w2"], shards)
        h = h + mlp_out
    return h, aux


def forward_train(params: dict, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                  remat: bool = True, shards=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal-LM (or encoder-decoder) logits.  Returns (logits (B, S, V)
    fp32, the summed aux loss).  A VLM's image positions are cut from the
    logits (they carry no next-token loss).  With ``remat`` each layer
    runs under ``torch.utils.checkpoint`` (non-reentrant): its activations
    are recomputed in the backward instead of stored.  On a train step's
    shards ``batch`` holds the rank's rows and the logits are its vocab
    columns of every position of them; an encoder runs over the rank's
    rows' whole frames (not split: `TrainShards.whole_seq`)."""
    h, positions = embed_inputs(params, batch, cfg, shards)
    enc_kvs = None
    if cfg.is_encoder_decoder:
        enc = encode(params, batch["frames"], cfg, None if shards is None else shards.whole_seq())
        enc_kvs = encoder_cross_kv(params, enc, cfg, shards)
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i, pl in enumerate(params["layers"]):
        enc_kv = enc_kvs[i] if enc_kvs is not None else None
        if remat:
            # no layer draws random numbers: the recompute needs no RNG state
            h, aux = checkpoint(apply_layer_full, pl, h, positions, cfg, i, enc_kv, None,
                                shards, use_reentrant=False, preserve_rng_state=False)
        else:
            h, aux = apply_layer_full(pl, h, positions, cfg, i, enc_kv, None, shards)
        aux_total = aux_total + aux
    h = L.rms_norm(h, params["final_norm"], cfg.rms_eps)
    if shards is not None:
        h = shards.gather_seq(h)
    logits = L.unembed(h, params.get("head", params["embed"]), cfg.logit_softcap, shards)
    if cfg.is_vlm:
        logits = logits[:, batch["image_embeds"].shape[1]:]
    return logits, aux_total
