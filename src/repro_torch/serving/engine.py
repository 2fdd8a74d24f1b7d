"""Serving engine: prefill (+compression) → slot-layout cache → decode.

The port of ``repro.serving.engine`` for dense and MoE decoder-only
models.  The FairKV plan enters the runtime in two places:

1. **Weight layout** — ``slotify_params`` permutes/replicates the attention
   projections into slot layout once at load time: per layer,
   ``wq: (S, D, G, Dh)``, ``wk/wv: (S, D, Dh)``, ``wo: (S, G, Dh, D)`` and,
   with qkv bias, ``bq: (S, G, Dh)``, ``bk/bv: (S, Dh)``, with slot s
   carrying kv-head ``slot_head[l, s]`` (zeros for empty slots).

2. **Cache ownership** — replicas split the batch by the strided owner rule;
   unowned (slot, row) pairs keep ``lengths == 0`` forever, so their decode
   output is exactly zero and the o-projection contraction over slots
   reassembles the full batch.

The decode step is the paper's measured quantity; its attention inner loop
is ``kernels.ops.fairkv_decode`` over the slot cache or
``kernels.ops.paged_fairkv_decode`` over a `PagedCache`, and the prefill
compression score is ``kernels.ops.snapkv_scores`` (hand-written CUDA on
the card, the plain PyTorch versions on the CPU).  The steps hold no host
sync, so the executor can capture them as CUDA graphs
(`repro_torch.exec.local`); callers wrap them in
``torch.inference_mode()``.  A step reads the ring-write phase from
``phase`` when given, a device scalar the executor refreshes before each
replay (the host keeps ``ServeState.decode_steps``).

Continuous batching adds row-level state ops: ``prefill(..., rows=)``
evaluates ownership at the global rows a request will occupy,
``decode_step(..., active=)`` appends and advances positions only on live
rows, and `splice_state` / `reset_state_rows` admit and retire rows of a
slot cache (a paged backend does its own cache work, then
`set_row_tokens`).

Chunked prefill: `prefill_chunk` runs one fixed-width chunk of a prompt
against the retained entries of the chunks before it and compresses at
the chunk boundary (``kernels.ops.snapkv_scores`` over the chunk's keys);
the scheduler drives it one chunk per tick and seeds it from a shared
prefix on a prefix-index hit.

Self-speculative decoding on a paged cache: `propose_step` drafts up to
``max_k`` tokens per row with the target's first layers, `verify_step`
checks the window in one multi-query pass
(``kernels.ops.paged_fairkv_decode`` with a 5-D q) and rolls the rejected
entries back.

On the multi-GPU executor's mesh each step runs on one rank with
``groups`` (a `repro_torch.launch.mesh.Mesh`, where the reference names
mesh axes): the rank's slots and rows, the owner rule at global row ids,
block ids made local to its pool partition, each layer's decode and
verify o-projection summed over the model group (the decode step's one
collective), and prefill's and the chunk step's slot weights (and the
chunk step's cache and plan arrays) all-gathered over it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.cache.slot_cache import (
    PlanArrays,
    Rows,
    SlotCache,
    append_selection,
    append_token,
    copy_fields_,
    fill_from_selection,
    init_cache,
    insert_rows,
    reset_rows,
    row_index,
    rows_to_mask,
)
from repro_torch.compression.base import CompressionConfig, pool_scores
from repro_torch.compression.policies import select as policy_select
from repro_torch.configs.base import ModelConfig
from repro_torch.core.placement import HeadPlacement
from repro_torch.core.planner import draft_plan
from repro_torch.distributed import comm
from repro_torch.kernels import ops as K
from repro_torch.models import layers as L
from repro_torch.models import transformer as M
from repro_torch.paging.paged_cache import PagedCache, paged_append_token


# ---------------------------------------------------------------------------
# Serve state
# ---------------------------------------------------------------------------


@dataclass
class ServeState:
    cache: Union[SlotCache, PagedCache]
    last_tokens: torch.Tensor  # (B,) int64
    decode_steps: int  # decode ticks since the state began (the ring phase)


def _check_dense(cfg: ModelConfig) -> None:
    if (cfg.family not in M.FAMILIES or cfg.attention_free
            or cfg.is_encoder_decoder or cfg.is_vlm):
        raise NotImplementedError(
            f"the port serves dense and moe decoder-only models, "
            f"got family={cfg.family!r} ({cfg.name})")


# ---------------------------------------------------------------------------
# Slot-layout weights
# ---------------------------------------------------------------------------


def slotify_layer(pl: dict, slot_head: np.ndarray, cfg: ModelConfig) -> dict:
    """Build slot-layout q/k/v/o weights (and q/k/v biases) for one layer.
    The original-layout attention weights are left out of the returned
    dict (the caller's tree keeps them)."""
    G, Dh, D = cfg.q_per_kv, cfg.head_dim, cfg.d_model
    dev = pl["wq"].device
    heads = torch.as_tensor(np.maximum(slot_head, 0), dtype=torch.long, device=dev)
    mask = torch.as_tensor(slot_head >= 0, device=dev).to(pl["wq"].dtype)
    wq = pl["wq"].reshape(D, cfg.n_kv_heads, G, Dh)
    wo = pl["wo"].reshape(cfg.n_kv_heads, G, Dh, D)
    out = {k: v for k, v in pl.items() if k not in ORIGINAL_ATTN}
    out["wq_s"] = (wq[:, heads].permute(1, 0, 2, 3) * mask[:, None, None, None]).contiguous()
    out["wk_s"] = (pl["wk"][:, heads].permute(1, 0, 2) * mask[:, None, None]).contiguous()
    out["wv_s"] = (pl["wv"][:, heads].permute(1, 0, 2) * mask[:, None, None]).contiguous()
    out["wo_s"] = (wo[heads] * mask[:, None, None, None]).contiguous()
    if cfg.qkv_bias and "bq" in pl:
        bq = pl["bq"].reshape(cfg.n_kv_heads, G, Dh)
        out["bq_s"] = (bq[heads] * mask[:, None, None]).contiguous()  # (S, G, Dh)
        out["bk_s"] = (pl["bk"][heads] * mask[:, None]).contiguous()  # (S, Dh)
        out["bv_s"] = (pl["bv"][heads] * mask[:, None]).contiguous()
    return out


ORIGINAL_ATTN = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
# every slot-layout leaf a replan rewrites (the biases where the model has them)
SLOT_WEIGHTS = ("wq_s", "wk_s", "wv_s", "wo_s", "bq_s", "bk_s", "bv_s")


def slotify_params(params: dict, plan: HeadPlacement, cfg: ModelConfig,
                   out: Optional[dict] = None, slots: Optional[slice] = None) -> dict:
    """Serve-layout params: attention weights per plan; everything else is
    shared with ``params`` (no copy).  With ``out`` (an earlier result for
    the same model and slot grid) the new slot weights are copied into its
    tensors and ``out`` is returned: a replan keeps every address a
    captured step reads.  ``slots`` keeps only those slots of the grid (a
    mesh rank's share of the slot dim)."""
    arrs = plan.as_arrays()["slot_head"]
    if slots is not None:
        arrs = arrs[:, slots]
    if out is None:
        out = dict(params)
        out["layers"] = [slotify_layer(pl, arrs[i], cfg)
                         for i, pl in enumerate(params["layers"])]
        return out
    for i, pl in enumerate(params["layers"]):
        new = slotify_layer(pl, arrs[i], cfg)
        for key in SLOT_WEIGHTS:
            if key in new:
                out["layers"][i][key].copy_(new[key])
    return out


def _full_slots(w: torch.Tensor, groups=None) -> torch.Tensor:
    """A slot-layout weight over the whole slot grid: on a mesh rank, its
    shard all-gathered over the model group."""
    return w if groups is None else comm.all_gather(w, groups.model_group, dim=0)


def first_weights(pl: dict, plan: PlanArrays, layer_idx: int, groups=None,
                  keys: Sequence[str] = ("wq", "wk", "wv", "wo")) -> dict:
    """Recover original-layout q/k/v/o weights from each head's replica-0
    slot (a gather — no second weight copy is stored): wq (Hkv, D, G, Dh),
    wk / wv (Hkv, D, Dh), wo (Hkv, G, Dh, D), and with qkv bias the biases
    of the q/k/v keys asked for: bq (Hkv, G, Dh), bk / bv (Hkv, Dh).
    ``first_slot`` holds global slot ids, so a mesh rank (``groups``)
    gathers the slot weights over the model group first."""
    fs = plan.first_slot[layer_idx]  # (Hkv,)
    bias = ["b" + k[1] for k in keys if k != "wo" and "b" + k[1] + "_s" in pl]
    return {k: _full_slots(pl[k + "_s"], groups)[fs] for k in list(keys) + bias}


def _add_bias(q, k, v, b: dict):
    """q/k/v plus their biases when ``b`` (a `first_weights` dict) holds
    them, each broadcast from the right."""
    if "bq" in b:
        return q + b["bq"], k + b["bk"], v + b["bv"]
    return q, k, v


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def prefill(
    serve_params: dict,
    batch: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    plan: PlanArrays,
    ccfg: CompressionConfig,
    rows: Optional[torch.Tensor] = None,
    head_importance: Optional[torch.Tensor] = None,
    groups=None,
) -> Tuple[ServeState, torch.Tensor, torch.Tensor]:
    """Run the full prompt, compress each layer's KV into the slot cache.

    Prefill attention runs in *original head layout*; q/k/v are recovered
    from the slot weights of the replica-0 slots, so the result does not
    depend on the plan.  ``rows`` ((B,) int) are the global batch rows this
    sub-batch will occupy in a live cache: ownership is evaluated there, so
    the sub-cache can be spliced in (`splice_state`).  Default arange(B).
    ``head_importance`` ((L, Hkv), optional) feeds the ``headkv`` policy
    its per-layer head weights; other policies ignore it.  ``groups`` (a
    `repro_torch.launch.mesh.Mesh`) runs it on a mesh rank: ``plan`` and
    the slot weights hold the rank's slots (``first_slot`` stays global),
    each layer's slot weights are all-gathered over the model group, and
    the rank fills only its slots of the cache.

    Returns (state, last_logits (B, V) fp32, lengths (L, Hkv, B) — the
    realized per-head retained lengths, the paper's workload observable).
    """
    _check_dense(cfg)
    h, positions = M.embed_inputs(serve_params, batch, cfg)
    B, T, D = h.shape
    if rows is not None:
        rows = row_index(rows, h.device)
    cache = init_cache(cfg.n_layers, plan.slot_head.shape[1], B,
                       ccfg.static_capacity(), cfg.head_dim, dtype=h.dtype,
                       device=h.device)
    lengths_all = []
    W = min(ccfg.obs_window, T)
    for i, pl in enumerate(serve_params["layers"]):
        hn = L.rms_norm(h, pl["ln1"], cfg.rms_eps)
        attn_flat, lens = _prefill_attention(pl, hn, positions, cfg, i, cache,
                                             plan, ccfg, W, rows, head_importance, groups)
        h = h + _slot_o_proj(pl, attn_flat, cfg, plan, i, groups)
        lengths_all.append(lens)
        hn2 = L.rms_norm(h, pl["ln2"], cfg.rms_eps)
        h = h + M.mlp_block(pl, hn2, cfg)

    h_last = L.rms_norm(h[:, -1:], serve_params["final_norm"], cfg.rms_eps)
    table = serve_params.get("head", serve_params["embed"])
    logits = L.unembed(h_last, table, cfg.logit_softcap)[:, 0]
    cache.positions.fill_(T)
    state = ServeState(cache=cache,
                       last_tokens=torch.argmax(logits[..., :cfg.vocab_size], dim=-1),
                       decode_steps=0)
    return state, logits, torch.stack(lengths_all)


def _policy_kw(ccfg: CompressionConfig, head_importance, layer_idx: int) -> dict:
    """The policy's extra arguments: ``headkv`` reads its layer's row of
    ``head_importance`` when one is given."""
    if ccfg.policy == "headkv" and head_importance is not None:
        return {"head_importance": head_importance[layer_idx]}
    return {}


def _prefill_attention(pl, hn, positions, cfg, layer_idx, cache, plan, ccfg,
                       W, rows=None, head_importance=None, groups=None):
    """Full attention + compression + slot-cache fill for one layer."""
    B, T, D = hn.shape
    Hkv, G, Dh = cfg.n_kv_heads, cfg.q_per_kv, cfg.head_dim
    fw = first_weights(pl, plan, layer_idx, groups, keys=("wq", "wk", "wv"))
    q = torch.einsum("btd,hdgx->bthgx", hn, fw["wq"])  # (B,T,Hkv,G,Dh)
    k = torch.einsum("btd,hdx->bthx", hn, fw["wk"])
    v = torch.einsum("btd,hdx->bthx", hn, fw["wv"])
    q, k, v = _add_bias(q, k, v, fw)
    q = q.reshape(B, T, Hkv * G, Dh)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    window = M.layer_window(cfg, layer_idx)
    out = L.attention(q, k, v, positions, positions, window=window,
                      attn_cap=cfg.attn_softcap, causal=True)
    out_flat = out.reshape(B, T, Hkv * G * Dh)

    # --- compression ---------------------------------------------------------
    scores = K.snapkv_scores(q[:, T - W:].contiguous(), k.contiguous(),
                             positions[:, T - W:].contiguous(),
                             positions.contiguous(), attn_cap=cfg.attn_softcap)
    scores = pool_scores(scores, ccfg.pool)
    if window > 0:
        # sliding-window layers never need positions older than the window
        pos = torch.arange(T, device=scores.device)
        scores = torch.where(pos[None, None, :] >= T - window, scores, float("-inf"))
    idx, keep = policy_select(ccfg.policy, scores, ccfg, layer_idx, cfg.n_layers,
                              **_policy_kw(ccfg, head_importance, layer_idx))
    fill_from_selection(cache, layer_idx, k, v, idx, keep, plan, rows=rows)
    return out_flat, keep.T  # lens (Hkv, B)


def _slot_o_proj(pl, attn_flat, cfg, plan, layer_idx, groups=None):
    """(B, T, Hkv·G·Dh) → (B, T, D) via the first-replica o weights."""
    fs = plan.first_slot[layer_idx]
    wo = _full_slots(pl["wo_s"], groups)[fs].reshape(cfg.n_kv_heads * cfg.q_per_kv * cfg.head_dim,
                                cfg.d_model)
    return torch.einsum("bte,ed->btd", attn_flat, wo)


def _slot_proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(R, D) rows through every slot's (D, ...) weight → (S, R, ...).

    One batched product over the slot dimension of the stored layout
    ``(S, D, ...)``: a single product contracting ``d`` would first copy
    the weight to ``(D, S·...)``, a strided copy of the whole weight on
    every step."""
    S, D = w.shape[:2]
    out = torch.matmul(x, w.reshape(S, D, -1))  # (S, R, N)
    return out.reshape(S, x.shape[0], *w.shape[2:])


# ---------------------------------------------------------------------------
# Chunked prefill
# ---------------------------------------------------------------------------


def _cache_head_view(cache: SlotCache, layer: int, plan: PlanArrays,
                     rows: torch.Tensor, n_heads: int, groups=None):
    """Head-layout view of one layer's slot cache at the given global rows:
    ``(k (B, H, C, Dh), v, len_h (B, H), pos_h (B, H, C))``.  Every
    (head, row) pair has exactly one owning slot, whose entries are
    gathered (the reference sums the slots under 0/1 ownership weights,
    which gives the same values).  On a mesh rank (``groups``) the slot dim
    of the cache slices and of the plan arrays is all-gathered over the
    model group first: chunk attention needs every head."""
    B = rows.shape[0]
    dev = cache.k.device
    sh, ri, rc = plan.slot_head[layer], plan.replica_idx[layer], plan.replica_count[layer]
    kl, vl, ln, ps = cache.k[layer], cache.v[layer], cache.lengths[layer], cache.pos[layer]
    if groups is not None:
        sh, ri, rc, kl, vl, ln, ps = (comm.all_gather(x, groups.model_group, dim=0)
                                      for x in (sh, ri, rc, kl, vl, ln, ps))
    own = (sh >= 0)[:, None] & ((rows.to(torch.int32)[None, :] % rc[:, None])
                                == ri[:, None])  # (S, B)
    hit = ((sh[:, None, None] == torch.arange(n_heads, device=dev)[None, None, :])
           & own[:, :, None])  # (S, B, H)
    slot = hit.to(torch.int32).argmax(dim=0)  # (B, H) the owning slot
    b_ix = torch.arange(B, device=dev)[:, None]
    at = (slot, b_ix)
    return kl[at], vl[at], ln[at], ps[at]


def _chunk_attention(pl, hn, positions, valid, cfg, layer_idx, cache, plan,
                     ccfg, quota_l, rows, head_importance=None, groups=None):
    """Attention over (retained cache ‖ current chunk), then compression at
    the chunk boundary, for one layer.

    Earlier chunks kept different entries per head, so each (row, head)
    pair is its own batch element of `dense_attention`: its keys are the
    head's retained entries followed by the chunk's keys, masked by the
    retained length and ``valid`` and by the causal (and window) rule over
    absolute positions (cache keys are post-RoPE, so order does not
    matter).  At the boundary the SnapKV scores of the chunk's last
    ``min(obs_window, Ck)`` valid queries over the chunk's own keys
    (``kernels.ops.snapkv_scores``, kernel 2) feed the policy, whose
    selection is appended after the existing entries (`append_selection`),
    clamped by the valid tokens, the per-chunk ``quota_l`` and the slot's
    headroom.  Returns (attention output (B, Ck, Hkv·G·Dh), cumulative
    retained lengths (Hkv, B)).
    """
    B, Ck, D = hn.shape
    Hkv, G, Dh = cfg.n_kv_heads, cfg.q_per_kv, cfg.head_dim
    C = cache.k.shape[3]
    fw = first_weights(pl, plan, layer_idx, groups, keys=("wq", "wk", "wv"))
    x = hn.reshape(B * Ck, D)
    q = _slot_proj(x, fw["wq"]).reshape(Hkv, B, Ck, G, Dh).permute(1, 2, 0, 3, 4)
    k = _slot_proj(x, fw["wk"]).reshape(Hkv, B, Ck, Dh).permute(1, 2, 0, 3)
    v = _slot_proj(x, fw["wv"]).reshape(Hkv, B, Ck, Dh).permute(1, 2, 0, 3)
    q, k, v = _add_bias(q, k, v, fw)
    q = q.reshape(B, Ck, Hkv * G, Dh)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    window = M.layer_window(cfg, layer_idx)

    k_c, v_c, len_h, pos_h = _cache_head_view(cache, layer_idx, plan, rows, Hkv, groups)
    # (row, head) pairs as the batch: each head's cache holds its own keys
    qh = (q.reshape(B, Ck, Hkv, G, Dh).permute(0, 2, 1, 3, 4)
          .reshape(B * Hkv, Ck, G, Dh))
    kx = k.permute(0, 2, 1, 3).reshape(B * Hkv, Ck, 1, Dh)
    vx = v.permute(0, 2, 1, 3).reshape(B * Hkv, Ck, 1, Dh)
    k_cat = torch.cat([k_c.reshape(B * Hkv, C, 1, Dh).to(kx.dtype), kx], dim=1)
    v_cat = torch.cat([v_c.reshape(B * Hkv, C, 1, Dh).to(vx.dtype), vx], dim=1)
    q_pos = positions[:, None, :].expand(B, Hkv, Ck)
    k_pos = torch.cat([pos_h.reshape(B * Hkv, C), q_pos.reshape(B * Hkv, Ck)], dim=1)
    dev = hn.device
    in_cache = torch.arange(C, device=dev)[None, None, :] < len_h[..., None]
    in_chunk = torch.arange(Ck, device=dev)[None, :] < valid[:, None]  # (B, Ck)
    kv_mask = torch.cat([in_cache.reshape(B * Hkv, C),
                         in_chunk[:, None, :].expand(B, Hkv, Ck).reshape(B * Hkv, Ck)],
                        dim=1)
    out = L.dense_attention(qh, k_cat, v_cat, q_pos.reshape(B * Hkv, Ck), k_pos,
                            window=window, attn_cap=cfg.attn_softcap,
                            kv_mask=kv_mask, causal=True)
    out_flat = (out.reshape(B, Hkv, Ck, G, Dh).permute(0, 2, 1, 3, 4)
                .reshape(B, Ck, Hkv * G * Dh))

    # --- chunk-boundary compression --------------------------------------
    W = min(ccfg.obs_window, Ck)
    obs_ix = torch.clamp(valid[:, None] - W + torch.arange(W, device=dev)[None, :],
                         0, Ck - 1).long()  # (B, W): the last W valid queries
    q_obs = torch.gather(q, 1, obs_ix[:, :, None, None].expand(B, W, Hkv * G, Dh))
    pos_obs = torch.gather(positions, 1, obs_ix)
    scores = K.snapkv_scores(q_obs.contiguous(), k.contiguous(), pos_obs.contiguous(),
                             positions.contiguous(), attn_cap=cfg.attn_softcap)
    t_ix = torch.arange(Ck, device=dev)
    scores = torch.where(t_ix[None, None, :] < valid[:, None, None], scores,
                         float("-inf"))
    scores = pool_scores(scores, ccfg.pool)
    if window > 0:
        end = (valid + positions[:, 0])[:, None, None]
        scores = torch.where(positions[:, None, :] >= end - window, scores,
                             float("-inf"))
    idx, keep = policy_select(ccfg.policy, scores, ccfg, layer_idx, cfg.n_layers,
                              **_policy_kw(ccfg, head_importance, layer_idx))
    keep = torch.minimum(keep, valid[:, None])  # only real tokens
    keep = torch.minimum(keep, quota_l)  # the chunk's share of the budget
    keep = torch.minimum(keep, C - len_h)  # slot headroom
    keep = torch.clamp(keep, min=0).to(torch.int32)
    append_selection(cache, layer_idx, k, v, idx, keep, plan, rows, positions[:, 0])
    return out_flat, (len_h + keep).T  # (Hkv, B)


def prefill_chunk(
    serve_params: dict,
    tokens: torch.Tensor,  # (B, Ck) fixed-width chunk (padded past ``valid``)
    cfg: ModelConfig,
    plan: PlanArrays,
    ccfg: CompressionConfig,
    state: ServeState,
    rows: torch.Tensor,  # (B,) global row ids
    start: torch.Tensor,  # (B,) absolute position of chunk token 0
    valid: torch.Tensor,  # (B,) real tokens in this chunk (<= Ck)
    quota: Union[Sequence[int], torch.Tensor],  # (L,) per-head keep cap for this chunk
    head_importance: Optional[torch.Tensor] = None,  # (L, Hkv) headkv weights
    groups=None,  # a mesh rank (`prefill`'s)
) -> Tuple[ServeState, torch.Tensor, torch.Tensor]:
    """Process one fixed-width prompt chunk against an accumulating cache.

    The chunked twin of `prefill`: the prompt arrives ``chunk_tokens`` at a
    time, each chunk attends over the retained entries of the earlier
    chunks plus its own keys, and the compression policy runs at the chunk
    boundary, so per-head keep budgets accrue chunk by chunk.  ``tokens``
    always has the same width: the scheduler pads the last chunk and
    passes ``valid``.  ``state``'s slot cache is updated in place.

    Dense decoder-only families only: SSM / hybrid recurrences and
    encoder-decoder / VLM inputs do not carry across a chunk boundary.

    Returns (state, logits (B, V) fp32 at the last valid token, lengths
    (L, Hkv, B): the cumulative retained lengths after this chunk).
    """
    if cfg.family != "dense" or cfg.attention_free:
        raise ValueError(
            f"chunked prefill supports dense attention families only, "
            f"got family={cfg.family!r}")
    if cfg.is_encoder_decoder or cfg.is_vlm:
        raise ValueError("chunked prefill does not support enc-dec / vlm")
    _check_dense(cfg)
    dev = tokens.device
    h = M.embed_tokens(tokens, serve_params, cfg)  # (B, Ck, D)
    B, Ck, _ = h.shape
    start = torch.as_tensor(start, device=dev).to(torch.int32)
    valid = torch.as_tensor(valid, device=dev).to(torch.int32)
    quota = torch.as_tensor(quota, device=dev).to(torch.int32)
    rows = row_index(rows, dev)
    positions = start[:, None] + torch.arange(Ck, dtype=torch.int32, device=dev)[None, :]
    cache = state.cache
    lengths_all = []
    for i, pl in enumerate(serve_params["layers"]):
        hn = L.rms_norm(h, pl["ln1"], cfg.rms_eps)
        attn_flat, lens = _chunk_attention(pl, hn, positions, valid, cfg, i, cache,
                                           plan, ccfg, quota[i], rows, head_importance,
                                           groups)
        h = h + _slot_o_proj(pl, attn_flat, cfg, plan, i, groups)
        lengths_all.append(lens)
        hn2 = L.rms_norm(h, pl["ln2"], cfg.rms_eps)
        h = h + M.mlp_block(pl, hn2, cfg)

    last_ix = torch.clamp(valid - 1, min=0).long()
    h_last = torch.gather(h, 1, last_ix[:, None, None].expand(B, 1, h.shape[2]))
    h_last = L.rms_norm(h_last, serve_params["final_norm"], cfg.rms_eps)
    table = serve_params.get("head", serve_params["embed"])
    logits = L.unembed(h_last, table, cfg.logit_softcap)[:, 0]
    cache.positions.copy_(start + valid)
    new_state = ServeState(
        cache=cache,
        last_tokens=torch.argmax(logits[..., :cfg.vocab_size], dim=-1),
        decode_steps=state.decode_steps)
    return new_state, logits, torch.stack(lengths_all)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def decode_step(
    serve_params: dict,
    state: ServeState,
    cfg: ModelConfig,
    plan: PlanArrays,
    ccfg: CompressionConfig,
    tokens: Optional[torch.Tensor] = None,
    active: Optional[torch.Tensor] = None,
    kv_kinds: Optional[torch.Tensor] = None,
    phase: Optional[torch.Tensor] = None,
    rows: Optional[torch.Tensor] = None,
    groups=None,
) -> Tuple[ServeState, torch.Tensor]:
    """One decode step for the whole batch.  Returns (state, logits (B, V)).

    The cache is updated in place (one appended column per owned
    (slot, row) per layer); the returned state shares it.  ``active``
    ((B,) bool) marks the rows holding a live request: appends and position
    increments skip the others, so a retired row keeps lengths 0 and an
    exactly-zero attention output until a request is spliced in.  ``None``
    treats every row as live (one-shot serving).  ``kv_kinds`` ((L, H)
    int32, on the cache's device) is the kind grid of int8/fp8 pools; the
    per-slot kinds follow from the plan's ``slot_head`` at each layer.
    ``phase`` (a device scalar) stands for ``state.decode_steps`` in the
    ring-write index.

    On a mesh rank (``groups``, a `repro_torch.launch.mesh.Mesh`) the step
    sees the rank's slots and rows: ``plan`` and the slot weights hold its
    slots, ``rows`` ((B,)) are the global ids of its rows (the strided
    owner rule keys on them; default arange(B)), the paged table's global
    block ids are made local to the rank's pool partition, and the
    o-projection's contraction over the slots ends in the step's one
    collective per layer, an all-reduce over the model group.
    """
    _check_dense(cfg)
    tokens = state.last_tokens if tokens is None else tokens
    phase = state.decode_steps if phase is None else phase
    h = M.embed_tokens(tokens[:, None], serve_params, cfg)  # (B, 1, D)
    cache = state.cache
    positions = cache.positions
    for i, pl in enumerate(serve_params["layers"]):
        hn = L.rms_norm(h, pl["ln1"], cfg.rms_eps)
        attn = _decode_attention(pl, hn, positions, cfg, i, cache, plan,
                                 phase, ccfg, active, kv_kinds, rows, groups)
        h = h + _decode_slot_o(pl, attn, cfg, groups)
        hn2 = L.rms_norm(h, pl["ln2"], cfg.rms_eps)
        h = h + M.mlp_block(pl, hn2, cfg)

    h = L.rms_norm(h, serve_params["final_norm"], cfg.rms_eps)
    table = serve_params.get("head", serve_params["embed"])
    logits = L.unembed(h, table, cfg.logit_softcap)[:, 0]  # (B, V)
    if active is None:
        cache.positions += 1  # in place: every row is live in one-shot decode
    else:
        cache.positions += active.to(cache.positions.dtype)
    new_state = ServeState(
        cache=cache,
        last_tokens=torch.argmax(logits[..., :cfg.vocab_size], dim=-1),
        decode_steps=state.decode_steps + 1)
    return new_state, logits


def _local_table(cache: PagedCache, layer: int, groups=None) -> torch.Tensor:
    """One layer's (S, B, M) block table as ids into the pool this process
    holds.  A mesh rank holds one partition of ``n_part`` blocks while the
    table stores global ids: the partition-aware allocator keeps a rank's
    blocks in its partition, so subtracting the partition offset localizes
    them, and anything outside it (the global null block 0 on later
    partitions) goes to the partition's own null block 0."""
    table = cache.block_table[layer]
    if groups is None:
        return table
    n_part = cache.k_pool.shape[1]
    loc = table - groups.part * n_part
    return torch.where((loc > 0) & (loc < n_part), loc, 0)


def _decode_attention(pl, hn, positions, cfg, layer_idx, cache, plan,
                      decode_steps, ccfg, active=None, kv_kinds=None, rows=None,
                      groups=None):
    """Slot-layout attention for one new token; appends to the cache."""
    B = hn.shape[0]
    x = hn[:, 0]  # (B, D)
    q = _slot_proj(x, pl["wq_s"]).transpose(0, 1)  # (B, S, G, Dh)
    k_new = _slot_proj(x, pl["wk_s"]).transpose(0, 1)  # (B, S, Dh)
    v_new = _slot_proj(x, pl["wv_s"]).transpose(0, 1)
    if "bq_s" in pl:
        q, k_new, v_new = q + pl["bq_s"], k_new + pl["bk_s"], v_new + pl["bv_s"]
    # RoPE at each row's absolute position
    q = _rope_slots(q, positions, cfg)
    k_new = _rope_slots(k_new[:, :, None, :], positions, cfg)[:, :, 0, :]
    own = (plan.owner_mask(layer_idx, B) if rows is None
           else plan.owner_mask_rows(layer_idx, rows))  # (S, B)
    if active is not None:
        own = own & active[None, :]
    window = M.layer_window(cfg, layer_idx)
    ring = max(1, ccfg.decode_margin)
    if isinstance(cache, PagedCache):
        # paged backend: the same append index rule into pool blocks, then
        # decode attention through the block table
        capacity = ccfg.static_capacity()
        kinds = None
        if cache.k_scale is not None:
            grid = (torch.zeros((cfg.n_kv_heads,), dtype=torch.int32,
                                device=own.device)
                    if kv_kinds is None else kv_kinds[layer_idx])
            kinds = grid[torch.clamp(plan.slot_head[layer_idx], min=0).long()]
        table = _local_table(cache, layer_idx, groups)
        paged_append_token(cache, layer_idx, k_new.transpose(0, 1),
                           v_new.transpose(0, 1), own, decode_steps, capacity,
                           ring=ring, kinds=kinds, table=table)
        return K.paged_fairkv_decode(
            q, cache.k_pool[layer_idx], cache.v_pool[layer_idx],
            cache.pos_pool[layer_idx], table,
            cache.lengths[layer_idx], capacity, attn_cap=cfg.attn_softcap,
            q_pos=positions, window=window,
            k_scale=None if kinds is None else cache.k_scale[layer_idx],
            v_scale=None if kinds is None else cache.v_scale[layer_idx],
            kinds=kinds)  # (B, S, G, Dh)
    append_token(cache, layer_idx, k_new.transpose(0, 1), v_new.transpose(0, 1),
                 own, decode_steps, ring=ring)
    return K.fairkv_decode(q, cache.k[layer_idx], cache.v[layer_idx],
                           cache.lengths[layer_idx], attn_cap=cfg.attn_softcap,
                           k_pos=cache.pos[layer_idx], q_pos=positions,
                           window=window)  # (B, S, G, Dh)


def _rope_slots(q, positions, cfg):
    """RoPE over (B, S, G, Dh) at per-row positions."""
    B, S_, G, Dh = q.shape
    q2 = q.reshape(B, 1, S_ * G, Dh)  # one 'seq' position per row
    q2 = L.apply_rope(q2, positions[:, None], cfg.rope_theta)
    return q2.reshape(B, S_, G, Dh)


def _decode_slot_o(pl, attn, cfg, groups=None):
    """(B, S, G, Dh) → (B, 1, D): the contraction over slots.  Every
    (head, row) pair has exactly one owning slot and unowned slots give
    exact zeros, so the sum over S reassembles the batch's activation.
    One product over the stored ``(S·G·Dh, D)`` layout (an einsum would
    copy the whole weight to ``(G, S, Dh, D)`` first).  On a mesh rank the
    partial contraction over its slots is summed over the model group: the
    decode step's one collective per layer."""
    wo = pl["wo_s"]
    out = torch.matmul(attn.reshape(attn.shape[0], -1), wo.reshape(-1, wo.shape[-1]))
    if groups is not None:
        out = comm.all_reduce_sum(out, groups.model_group)
    return out[:, None]


# ---------------------------------------------------------------------------
# Speculative decoding: propose + verify
# ---------------------------------------------------------------------------


def _spec_supported(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.attention_free:
        raise ValueError(
            "speculative decoding supports dense attention families only, "
            f"got family={cfg.family!r}")
    if cfg.is_encoder_decoder or cfg.is_vlm:
        raise ValueError("speculative decoding does not support enc-dec/vlm")


def propose_step(
    serve_params: dict,
    state: ServeState,
    cfg: ModelConfig,
    plan: PlanArrays,
    ccfg: CompressionConfig,
    depths: torch.Tensor,  # (B,) int: speculative tokens per row (<= max_k)
    active: Optional[torch.Tensor] = None,
    kv_kinds: Optional[torch.Tensor] = None,
    draft_layers: int = 0,  # 0 = full depth (self-check mode)
    max_k: int = 1,
    phase: Optional[torch.Tensor] = None,
    rows: Optional[torch.Tensor] = None,
    groups=None,
) -> Tuple[ServeState, torch.Tensor]:
    """Draft up to ``max_k`` tokens per row with the layer-truncated draft.

    The draft is the target's early exit (`models.transformer.draft_view`)
    under the leading slice of the target plan (`core.planner.draft_plan`),
    so its appends land in the target's paged cache at the target's own
    layers < d (real KV; verify fills the layers >= d).  Step ``i`` runs
    `decode_step` with ``active & (i < depths)``.

    ``decode_step`` advances ``cache.positions`` in place; they are put
    back afterwards, as are ``last_tokens`` and ``decode_steps``: verify
    derives the advance from the accepted run, and the tick counts as one
    ring step whatever its depth.  The appended entries and ``lengths``
    stay.  Draft step ``i`` appends at ring phase ``decode_steps + i``
    (``phase + i`` with a device scalar).  Returns (state, proposals
    (B, max_k)); entries past a row's depth are garbage lanes the caller
    masks.  ``rows`` / ``groups``: a mesh rank's, as in `decode_step`.
    """
    _spec_supported(cfg)
    d = draft_layers if draft_layers > 0 else cfg.n_layers
    sp_d = M.draft_view(serve_params, d)
    plan_d = draft_plan(plan, d)
    B = state.last_tokens.shape[0]
    dev = state.last_tokens.device
    active_b = torch.ones((B,), dtype=torch.bool, device=dev) if active is None else active
    depths = torch.as_tensor(depths, device=dev)
    positions = state.cache.positions.clone()
    st = state
    proposals = []
    for i in range(max_k):
        st, _ = decode_step(sp_d, st, cfg, plan_d, ccfg, tokens=st.last_tokens,
                            active=active_b & (i < depths), kv_kinds=kv_kinds,
                            phase=None if phase is None else phase + i, rows=rows,
                            groups=groups)
        proposals.append(st.last_tokens)
    st.cache.positions.copy_(positions)
    props = (torch.stack(proposals, dim=1) if proposals
             else torch.zeros((B, 0), dtype=torch.int64, device=dev))
    return ServeState(cache=st.cache, last_tokens=state.last_tokens,
                      decode_steps=state.decode_steps), props


def verify_step(
    serve_params: dict,
    state: ServeState,
    cfg: ModelConfig,
    plan: PlanArrays,
    ccfg: CompressionConfig,
    tokens: torch.Tensor,  # (B, Q): [t0, p1..p_{Q-1}] (garbage past q_lens)
    q_lens: torch.Tensor,  # (B,) valid window per row (1 <= q_len <= Q)
    active: Optional[torch.Tensor] = None,
    kv_kinds: Optional[torch.Tensor] = None,
    draft_layers: int = 0,  # layers < d were filled by propose
    phase: Optional[torch.Tensor] = None,
    rows: Optional[torch.Tensor] = None,
    groups=None,
) -> Tuple[ServeState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One batched verify pass over the speculative window.

    Runs the full target over ``Q`` tokens per row (the last committed
    token, then the draft's proposals) through the multi-query paged
    kernel (5-D q, `fairkv_decode_mq_ref` semantics).  The greedy verdicts
    ``g[:, i]`` are what single-token decode would emit given the same
    prefix, so committing the accepted run ``g[:, :n_commit]`` gives greedy
    decode's tokens at any acceptance rate.

    Rejected entries roll back in place: on every owned (layer, slot, row)
    ``lengths`` drop by the rejected count and ``positions`` advance by
    ``n_commit`` (live rows only); the backend's `trim_rows` then frees the
    blocks no longer covered.  Returns (state, g (B, Q), n_commit (B,),
    logits (B, Q, V) fp32).  ``phase``, ``rows`` and ``groups`` are
    `decode_step`'s.
    """
    _spec_supported(cfg)
    cache = state.cache
    if not isinstance(cache, PagedCache):
        raise ValueError("speculative verify requires the paged cache backend")
    d = draft_layers if draft_layers > 0 else cfg.n_layers
    B, Q = tokens.shape
    dev = tokens.device
    active_b = torch.ones((B,), dtype=torch.bool, device=dev) if active is None else active
    q_lens = torch.as_tensor(q_lens, device=dev).to(torch.int32)
    h = M.embed_tokens(tokens, serve_params, cfg)  # (B, Q, D)
    positions = cache.positions
    positions_q = positions[:, None] + torch.arange(Q, dtype=torch.int32, device=dev)[None, :]
    phase = state.decode_steps if phase is None else phase
    for i, pl in enumerate(serve_params["layers"]):
        hn = L.rms_norm(h, pl["ln1"], cfg.rms_eps)
        attn = _verify_attention(pl, hn, positions_q, q_lens, cfg, i, cache,
                                 plan, phase, ccfg, i < d,
                                 active_b, kv_kinds, rows, groups)
        h = h + _verify_slot_o(pl, attn, groups)
        hn2 = L.rms_norm(h, pl["ln2"], cfg.rms_eps)
        h = h + M.mlp_block(pl, hn2, cfg)

    h = L.rms_norm(h, serve_params["final_norm"], cfg.rms_eps)
    table = serve_params.get("head", serve_params["embed"])
    logits = L.unembed(h, table, cfg.logit_softcap)  # (B, Q, V)
    g = torch.argmax(logits[..., :cfg.vocab_size], dim=-1)
    # leading run of proposals the target itself would have emitted
    if Q > 1:
        iq = torch.arange(Q - 1, device=dev)[None, :]
        ok = (tokens[:, 1:] == g[:, :-1]) & (iq + 1 < q_lens[:, None])
        n_acc = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1)
    else:
        n_acc = torch.zeros((B,), dtype=torch.int64, device=dev)
    n_commit = torch.minimum(n_acc + 1, q_lens.long())  # accepted run + bonus/fix
    # rollback: rejected entries drop out of `lengths` on every owned
    # (layer, slot, row), so the kernels' length masks no longer see them
    trim = torch.where(active_b, q_lens.long() - n_commit, 0)  # (B,)
    own_all = plan.owner_mask_all(B, rows)  # (L, S, B)
    cache.lengths.sub_(torch.where(own_all, trim[None, None, :], 0).to(torch.int32))
    cache.positions.add_(torch.where(active_b, n_commit, 0).to(torch.int32))
    last = torch.gather(g, 1, torch.clamp(n_commit - 1, min=0)[:, None])[:, 0]
    new_state = ServeState(cache=cache,
                           last_tokens=torch.where(active_b, last, state.last_tokens),
                           decode_steps=state.decode_steps + 1)
    return new_state, g, n_commit, logits


def _verify_attention(pl, hn, positions_q, q_lens, cfg, layer_idx, cache, plan,
                      decode_steps, ccfg, draft_filled, active, kv_kinds=None,
                      rows=None, groups=None):
    """Multi-query slot attention over the speculative window (one layer).

    ``hn`` is (B, Q, D); every token projects and RoPEs at its own absolute
    position, then appends into the paged cache:

    - ``draft_filled`` layers already hold the window's first ``q_len - 1``
      entries (real KV written by propose); only query ``q_len - 1``
      appends;
    - verify-only layers append every valid query in query order, so
      quantize-on-write scales evolve as under sequential decode.

    After the appends every live (slot, row) sits at ``base + q_len`` and
    the multi-query kernel masks query ``i`` to its causal prefix.
    Returns (B, S, Q, G, Dh).
    """
    B, Q, D = hn.shape
    x = hn.reshape(B * Q, D)
    S = pl["wq_s"].shape[0]
    q = _slot_proj(x, pl["wq_s"]).reshape(S, B, Q, *pl["wq_s"].shape[2:]).transpose(0, 1)
    k_new = _slot_proj(x, pl["wk_s"]).reshape(S, B, Q, -1).transpose(0, 1)  # (B, S, Q, Dh)
    v_new = _slot_proj(x, pl["wv_s"]).reshape(S, B, Q, -1).transpose(0, 1)
    if "bq_s" in pl:
        q = q + pl["bq_s"][:, None]
        k_new, v_new = k_new + pl["bk_s"][:, None], v_new + pl["bv_s"][:, None]
    q = _rope_slots_mq(q, positions_q, cfg)
    k_new = _rope_slots_mq(k_new[:, :, :, None, :], positions_q, cfg)[:, :, :, 0, :]
    own = (plan.owner_mask(layer_idx, B) if rows is None
           else plan.owner_mask_rows(layer_idx, rows)) & active[None, :]  # (S, B)
    capacity = ccfg.static_capacity()
    kinds = None
    if cache.k_scale is not None:
        grid = (torch.zeros((cfg.n_kv_heads,), dtype=torch.int32, device=own.device)
                if kv_kinds is None else kv_kinds[layer_idx])
        kinds = grid[torch.clamp(plan.slot_head[layer_idx], min=0).long()]
    table = _local_table(cache, layer_idx, groups)
    for qi in range(Q):
        m_q = (q_lens == qi + 1) if draft_filled else (qi < q_lens)
        # each entry records its own token's absolute position
        paged_append_token(cache, layer_idx, k_new[:, :, qi].transpose(0, 1),
                           v_new[:, :, qi].transpose(0, 1), own & m_q[None, :],
                           decode_steps, capacity, ring=max(1, ccfg.decode_margin),
                           kinds=kinds, positions=positions_q[:, qi], table=table)
    return K.paged_fairkv_decode(
        q.contiguous(), cache.k_pool[layer_idx], cache.v_pool[layer_idx],
        cache.pos_pool[layer_idx], table,
        cache.lengths[layer_idx], capacity, attn_cap=cfg.attn_softcap,
        q_pos=positions_q[:, 0].contiguous(), window=M.layer_window(cfg, layer_idx),
        k_scale=None if kinds is None else cache.k_scale[layer_idx],
        v_scale=None if kinds is None else cache.v_scale[layer_idx],
        kinds=kinds, q_lens=q_lens)


def _rope_slots_mq(q, positions_q, cfg):
    """RoPE over (B, S, Q, G, Dh) at per-(row, query) positions (B, Q)."""
    B, S_, Q, G, Dh = q.shape
    q2 = q.permute(0, 2, 1, 3, 4).reshape(B, Q, S_ * G, Dh)
    q2 = L.apply_rope(q2, positions_q, cfg.rope_theta)
    return q2.reshape(B, Q, S_, G, Dh).permute(0, 2, 1, 3, 4)


def _verify_slot_o(pl, attn, groups=None):
    """(B, S, Q, G, Dh) → (B, Q, D): the decode o-projection's contraction
    over slots, per query, as `_decode_slot_o`'s one product (and its one
    all-reduce over the model group on a mesh rank)."""
    B, S, Q = attn.shape[:3]
    wo = pl["wo_s"]
    x = attn.transpose(1, 2).reshape(B * Q, -1)  # (B·Q, S·G·Dh), a small copy
    out = torch.matmul(x, wo.reshape(-1, wo.shape[-1]))
    if groups is not None:
        out = comm.all_reduce_sum(out, groups.model_group)
    return out.reshape(B, Q, -1)


def init_serve_state(cfg: ModelConfig, plan: PlanArrays, batch: int,
                     ccfg: CompressionConfig, dtype=torch.float32,
                     device="cpu", cache: Optional[PagedCache] = None) -> ServeState:
    """Empty B-row ServeState: every row retired (lengths 0, positions 0).

    The continuous scheduler starts from it and splices requests into rows
    as they are admitted.  ``cache`` lets a cache backend put its own
    layout (a `PagedCache`) in place of the slot cache."""
    _check_dense(cfg)
    if cache is None:
        cache = init_cache(cfg.n_layers, int(plan.slot_head.shape[1]), batch,
                           ccfg.static_capacity(), cfg.head_dim, dtype=dtype,
                           device=device)
    return ServeState(cache=cache,
                      last_tokens=torch.zeros((batch,), dtype=torch.int64, device=device),
                      decode_steps=0)


def copy_state_(dst: ServeState, src: ServeState) -> ServeState:
    """Copy ``src``'s cache tensors, last tokens and ring phase into
    ``dst`` (same cache layout and shapes), in place; returns ``dst``.  A
    new state lands in storage a captured step already reads."""
    copy_fields_(dst.cache, src.cache)
    dst.last_tokens.copy_(src.last_tokens)
    dst.decode_steps = src.decode_steps
    return dst


def state_layout(state: ServeState) -> tuple:
    """The cache type and the shapes and dtypes of a state's tensors: two
    states with equal layouts fit `copy_state_`, and one captured step
    serves both."""
    tensors = [getattr(state.cache, f.name) for f in dataclasses.fields(state.cache)]
    return (type(state.cache).__name__,) + tuple(
        None if t is None else (tuple(t.shape), t.dtype)
        for t in tensors + [state.last_tokens])


def set_row_tokens(state: ServeState, rows: Rows,
                   tokens: Optional[torch.Tensor] = None) -> ServeState:
    """Set the last token of ``rows`` in place: ``tokens`` of a spliced
    sub-batch at int row ids, or 0 for retired rows (int ids or a (B,)
    bool mask).  Each cache backend does its own cache work and then calls
    this."""
    dev = state.last_tokens.device
    if tokens is None:
        state.last_tokens[rows_to_mask(rows, state.last_tokens.shape[0], dev)] = 0
    else:
        state.last_tokens[row_index(rows, dev)] = tokens.to(state.last_tokens.dtype)
    return state


def splice_state(state: ServeState, sub: ServeState, rows: Rows) -> ServeState:
    """Splice a prefilled sub-batch into ``rows`` of a live slot-cache
    state, in place.  ``sub`` must come from ``prefill(..., rows=rows)``.
    ``decode_steps`` keeps the live value: the ring-write phase is global,
    not per request."""
    insert_rows(state.cache, sub.cache, rows)
    return set_row_tokens(state, rows, sub.last_tokens)


def reset_state_rows(state: ServeState, rows: Rows) -> ServeState:
    """Retire rows of a slot-cache state in place: clear their cache rows,
    so their decode output is exactly zero and the rows can return to the
    freelist."""
    reset_rows(state.cache, rows)
    return set_row_tokens(state, rows)
