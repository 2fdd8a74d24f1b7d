"""Cell builders of the dry run (port of ``repro.launch.specs``): an
(arch × shape × mesh) cell → rank 0's fake arguments and the cell's step.

Every cell has the reference's arguments, laid out by its logical-axis
rules (`repro_torch.distributed.sharding`):

- train_4k     → (params, optimizer state, batch) under ``train_rules``;
- prefill_32k  → (serve params, batch, plan arrays) under ``serve_rules``;
- decode_32k / long_500k → (serve params, serve state, plan arrays).

The trees are built by the port's own code (``init_params``,
``slotify_params``, ``quantize_serve_params``) on fake tensors, each leaf
gets its spec from `tree_specs` (or the reference's explicit one for the
state, batch and plan arrays), and rank 0 holds a fake tensor of the
leaf's shard shape.  ``arg_bytes_per_rank`` sums them: the reference's
Σ ``sharding.shard_shape(leaf.shape)`` x itemsize.  Dtypes follow the
reference's arguments (int32 tokens, positions and plan arrays).

The cell's step, ``CellArtifacts.fn`` (the reference's), is `serve_step`
for every serve cell (decode_32k, prefill_32k and long_500k of every
family: dense, MoE, SSM, hybrid, encoder-decoder and VLM): the port's own
`decode_step` / `prefill` on the rank's shards, explicit SPMD in place of
the reference's GSPMD partition (`repro_torch.serving.engine`'s module
docstring has its collectives; long_500k is split-S decode where the
model has a cache, MoE runs expert parallel, the SSD branch and the
encoder and cross attention run on their own splits).  Every train_4k
cell runs `train_step`: the port's `train_step` (remat, the reference's
default `OptimizerConfig`) on the rank's rows, parameter and optimizer
state shards under ``train_rules`` (FSDP over ``data``, sequence and
tensor parallelism over ``model``, MoE experts over ``model``, the SSD
branch on its splits over the gathered sequence, the encoder over whole
frames: `repro_torch.models.transformer`'s and
`repro_torch.training.train_loop`'s module docstrings).

`executor_args` builds what the port's `MeshExecutor` itself holds on a
rank of a mesh (its slot weights, the rest replicated, its cache corner),
for the steps the dry run runs.  Nothing here allocates device memory: call
inside `repro_torch.distributed.step_stats.fake_tensors`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.cache.slot_cache import PlanArrays, SlotCache, init_cache
from repro_torch.compression.base import CompressionConfig
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.placement import HeadPlacement
from repro_torch.core.planner import PlannerConfig, build_plan
from repro_torch.core.profiles import synthetic_profile
from repro_torch.distributed.param_specs import (guarded, localize_scales, shard_shape,
                                                tree_specs)
from repro_torch.distributed.sharding import (ShardingRules, mesh_axes, serve_rules,
                                              step_shards, train_rules, train_shards)
from repro_torch.models.transformer import FAMILIES, init_params
from repro_torch.serving import engine as _serve
from repro_torch.serving.quant import QTensor, quantize_serve_params
from repro_torch.training import train_loop as _train
from repro_torch.training.optimizer import AdamWState, OptimizerConfig

BF16 = torch.bfloat16
I32 = torch.int32


# ---------------------------------------------------------------------------
# Compression operating point and plan per cell (the reference's, copied)
# ---------------------------------------------------------------------------


def cell_ccfg(cfg: ModelConfig, shape: InputShape) -> CompressionConfig:
    if shape.name == "long_500k":
        if cfg.sliding_window > 0 and not cfg.local_global_alternate:
            # pure sliding-window attention (hymba): the cache holds one window
            return CompressionConfig(policy="none", budget=cfg.sliding_window,
                                     capacity=cfg.sliding_window, decode_margin=64)
        # gemma2-style: global layers hold the full 500k retained context
        return CompressionConfig(policy="none", budget=shape.seq_len,
                                 capacity=shape.seq_len, decode_margin=64)
    return CompressionConfig(policy="ada_snapkv", budget=1024, alpha_max=1.5, decode_margin=64)


def cell_plan(cfg: ModelConfig, n_model_shards: int, planner_mode: str = "fairkv_dp",
              extra_copies: int = 4, seed: int = 0,
              batch_cap: Optional[int] = None) -> Optional[HeadPlacement]:
    if cfg.attention_free:
        return None
    profile = synthetic_profile(cfg.n_layers, cfg.n_kv_heads, budget=1024, skew=1.0,
                                seed=seed)
    return build_plan(profile, n_model_shards,
                      PlannerConfig(mode=planner_mode, extra_copies=extra_copies,
                                    batch_cap=batch_cap))


def quantize_auto(cfg: ModelConfig, n_model: int) -> bool:
    """The reference's rule: bf16 1D-TP weights above ~10 GB a rank → int8."""
    return cfg.param_count() * 2 / n_model > 10e9


# ---------------------------------------------------------------------------
# Global trees (fake) and rank 0's shards
# ---------------------------------------------------------------------------


def _max_seq(cfg: ModelConfig, shape: InputShape) -> int:
    return max(shape.seq_len + 64, 4096) if cfg.is_encoder_decoder else 4096


def params_fake(cfg: ModelConfig, shape: InputShape, dtype=BF16) -> dict:
    """The original-layout parameter tree, fake, on the CPU."""
    return init_params(cfg, 0, dtype=dtype, device="cpu", max_seq_len=_max_seq(cfg, shape))


def serve_params_fake(cfg: ModelConfig, shape: InputShape, plan: Optional[HeadPlacement],
                      dtype=BF16, quantize: bool = False, slots: Optional[slice] = None):
    """The serve tree: slot weights per ``plan`` (only ``slots`` of them when
    given), int8 projections when ``quantize``."""
    base = params_fake(cfg, shape, dtype)
    if plan is not None and not cfg.attention_free:
        base = _serve.slotify_params(base, plan, cfg, slots=slots)
    return quantize_serve_params(base) if quantize else base


def _leaf(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype)


def batch_fake(cfg: ModelConfig, shape: InputShape) -> Dict[str, torch.Tensor]:
    B, S = shape.global_batch, shape.seq_len
    if cfg.is_vlm:
        S = max(1, S - cfg.num_image_tokens)
    out = {"tokens": _leaf((B, S), I32)}
    if cfg.is_vlm:
        out["image_embeds"] = _leaf((B, cfg.num_image_tokens, cfg.d_model), BF16)
    if cfg.is_encoder_decoder:
        out["frames"] = _leaf((B, cfg.encoder_seq_len, cfg.d_model), BF16)
    return out


def batch_specs(batch: dict, rules: ShardingRules) -> dict:
    return {k: (guarded(rules, v.shape[0], "batch"),) + (None,) * (v.dim() - 1)
            for k, v in batch.items()}


def opt_fake(params: dict) -> AdamWState:
    f32 = lambda t: _map(lambda x: _leaf(x.shape, torch.float32), t)  # noqa: E731
    return AdamWState(step=_leaf((), I32), master=f32(params), mu=f32(params), nu=f32(params))


def serve_state_fake(cfg: ModelConfig, shape: InputShape, plan: Optional[HeadPlacement],
                     ccfg: CompressionConfig, rules: ShardingRules, dtype=BF16):
    """(state, specs): the reference's decode-time state with its explicit
    per-leaf specs."""
    B, L, cap = shape.global_batch, cfg.n_layers, ccfg.static_capacity()

    def leaf(shape_, dt, logical):
        return _leaf(shape_, dt), tuple(guarded(rules, d, name)
                                        for d, name in zip(shape_, logical))

    parts: Dict[str, Any] = {}
    if not cfg.attention_free:
        S_, Dh = plan.n_slots, cfg.head_dim
        kv = (L, S_, B, cap, Dh)
        kv_log = (None, "kv_slot", "batch", "cache_len", None)
        parts["cache"] = {
            "k": leaf(kv, dtype, kv_log), "v": leaf(kv, dtype, kv_log),
            "lengths": leaf((L, S_, B), I32, (None, "kv_slot", "batch")),
            "pos": leaf((L, S_, B, cap), I32, (None, "kv_slot", "batch", "cache_len")),
            "positions": leaf((B,), I32, ("batch",))}
    if cfg.family in ("ssm", "hybrid"):
        s = cfg.ssm
        parts["ssm_state"] = leaf((L, B, s.num_heads, s.head_dim, s.state_size),
                                  torch.float32, (None, "batch", "heads", None, None))
        parts["conv_state"] = leaf((L, B, s.conv_width - 1,
                                    s.d_inner + 2 * s.n_groups * s.state_size),
                                   dtype, (None, "batch", None, "ff"))
    if cfg.is_encoder_decoder:
        ck = (L, B, cfg.encoder_seq_len, cfg.n_kv_heads, cfg.head_dim)
        parts["cross_k"] = leaf(ck, dtype, (None, "batch", None, "kv_heads", None))
        parts["cross_v"] = leaf(ck, dtype, (None, "batch", None, "kv_heads", None))
    parts["last_tokens"] = leaf((B,), I32, ("batch",))
    parts["decode_steps"] = leaf((), I32, ())
    state = _map(lambda p: p[0], parts, is_leaf=lambda p: isinstance(p, tuple))
    specs = _map(lambda p: p[1], parts, is_leaf=lambda p: isinstance(p, tuple))
    return state, specs


def plan_specs(plan: HeadPlacement, rules: ShardingRules) -> dict:
    """The plan arrays' specs as the reference places them: the (L, S)
    arrays over the slot dim, ``first_slot`` (L, Hkv) whole."""
    slot = (None, guarded(rules, plan.n_slots, "kv_slot"))
    return {"slot_head": slot, "replica_idx": slot, "replica_count": slot,
            "first_slot": (None, None)}


def plan_arrays_fake(plan: HeadPlacement, rules: ShardingRules):
    """(arrays, specs) of the plan as the reference passes it: (L, S)
    int32 arrays and ``first_slot`` (`plan_specs`)."""
    L, S = len(plan.layers), plan.n_slots
    arrs = {k: _leaf((L, S), I32) for k in ("slot_head", "replica_idx", "replica_count")}
    arrs["first_slot"] = _leaf((L, plan.n_heads), I32)
    return arrs, plan_specs(plan, rules)


def _map(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of a dict / list / tuple / NamedTuple /
    `QTensor` tree (and the matching leaves of ``rest``)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, QTensor):
        return QTensor(q=_map(fn, tree.q, *(r.q for r in rest)),
                       scale=_map(fn, tree.scale, *(r.scale for r in rest)))
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def _shard(tree, specs, axes: Dict[str, int], device):
    """Rank 0's fake shards of a global tree: each leaf's shard shape."""
    return _map(lambda t, spec: torch.empty(shard_shape(tuple(t.shape), spec, axes),
                                            dtype=t.dtype, device=device), tree, specs)


def tree_bytes(tree) -> int:
    total = 0

    def add(t):
        nonlocal total
        total += t.numel() * t.element_size()

    _map(add, tree)
    return total


# ---------------------------------------------------------------------------
# Cell artifacts
# ---------------------------------------------------------------------------


# the families `serve_step` and `train_step` run: every one the port serves
STEP_FAMILIES = FAMILIES


def _as_plan(pa) -> Optional[PlanArrays]:
    """The plan arrays (None for an attention-free model, which has none)."""
    return pa if pa is None or isinstance(pa, PlanArrays) else PlanArrays(**pa)


def _as_state(st) -> _serve.ServeState:
    """A cell's state: a `ServeState`, or the cell's tree of it (no
    ``cache`` for an attention-free model; the SSD, conv and cross
    attention states where the family has them)."""
    if isinstance(st, _serve.ServeState):
        return st
    cache = SlotCache(**st["cache"]) if st.get("cache") is not None else None
    return _serve.ServeState(cache=cache, last_tokens=st["last_tokens"],
                             decode_steps=st["decode_steps"],
                             **{k: st.get(k) for k in ("ssm_state", "conv_state", "cross_k",
                                                      "cross_v")})


def serve_step(kind: str, cfg: ModelConfig, ccfg: CompressionConfig, mesh,
               rules: ShardingRules, sp_spec, n_slots: int, batch: int) -> Callable:
    """A serve cell's step on ``mesh``'s rank (a `repro_torch.launch.mesh.Mesh`)
    under ``rules``: ``fn(serve_params, batch | state, plan_arrays)`` on the
    rank's shards (``sp_spec`` the serve tree's specs; its `QTensor` scales
    may be whole, as the rules lay them out), returning the reference's
    outputs: (state, logits shard) for ``"decode"``, (state, logits shard,
    lengths) for ``"prefill"``.  ``n_slots`` and ``batch`` are the global
    slot and row counts.  The state and plan arrays may be the cell's
    trees or `ServeState` / `PlanArrays` (None and 0 slots for an
    attention-free model).  Under the long-context rules the decode step
    is split-S over the ``cache_len`` group; an MoE config's FFN runs
    expert parallel; the SSD branch and the encoder and cross attention
    run on their own splits (`step_shards`)."""
    if cfg.family not in STEP_FAMILIES:
        raise NotImplementedError(f"{cfg.name}: no serve step for the {cfg.family!r} family")
    shards = step_shards(rules, mesh, vocab=cfg.padded_vocab, ff=cfg.d_ff,
                         d_model=cfg.d_model, n_slots=n_slots, batch=batch,
                         cache_len=0 if cfg.attention_free else ccfg.static_capacity(),
                         experts=cfg.moe.num_experts,
                         ssm=cfg.ssm if cfg.family in ("ssm", "hybrid") else None,
                         heads=cfg.n_heads, kv_heads=cfg.n_kv_heads)
    if kind == "prefill":
        def fn(serve_params, batch, plan_arrays):
            return _serve.prefill(localize_scales(serve_params, sp_spec, mesh), batch, cfg,
                                  _as_plan(plan_arrays), ccfg, shards=shards)
    elif kind == "decode":
        def fn(serve_params, state, plan_arrays):
            return _serve.decode_step(localize_scales(serve_params, sp_spec, mesh),
                                      _as_state(state), cfg, _as_plan(plan_arrays), ccfg,
                                      shards=shards)
    else:
        raise ValueError(f"serve_step: kind {kind!r} is not prefill or decode")
    return fn


def train_step(cfg: ModelConfig, mesh, rules: ShardingRules, p_spec, batch: int, seq: int,
               ocfg: OptimizerConfig = OptimizerConfig(), remat: bool = True) -> Callable:
    """A train cell's step on ``mesh``'s rank under ``rules`` (``train_rules``):
    ``fn(params, opt_state, batch)`` on the rank's shards (``p_spec`` the
    params' spec tree; the optimizer state's master / mu / nu share it; the
    batch's ``tokens`` are the rank's rows, every token of them), returning
    (new params shards, new optimizer state shards, the reference's metrics
    ``loss`` / ``xent`` / ``aux`` / ``grad_norm`` / ``lr``, global: the same
    on every rank).  ``batch`` and ``seq`` are the global rows and tokens a
    row (a VLM's image prefix and text).  Refuses a family the port has no
    step for and a layout the step does not run (`train_shards`)."""
    if cfg.family not in STEP_FAMILIES:
        raise NotImplementedError(f"{cfg.name}: no train step for the {cfg.family!r} family")
    moe = cfg.moe.num_experts > 0
    shards = train_shards(rules, mesh, vocab=cfg.padded_vocab, ff=0 if moe else cfg.d_ff,
                          d_model=cfg.d_model, seq=seq, batch=batch,
                          experts=cfg.moe.num_experts,
                          ssm=cfg.ssm if cfg.family in ("ssm", "hybrid") else None)

    def fn(params, opt_state, batch_):
        return _train.train_step(params, opt_state, batch_, cfg, ocfg, remat, shards=shards,
                                 specs=p_spec)
    return fn


def _refused(why: str) -> Callable:
    def fn(*args):
        raise NotImplementedError(why)
    return fn


@dataclass
class CellArtifacts:
    kind: str  # train | prefill | decode
    args: Tuple  # rank 0's fake shards, the reference's argument order
    specs: Tuple  # the matching spec trees
    rules: ShardingRules
    arg_bytes_per_rank: int
    meta: Dict[str, Any] = field(default_factory=dict)
    # the cell's step on ``args`` (`serve_step`, `train_step`), or a callable that raises
    # (a cell built for axis sizes, with no ranks)
    fn: Optional[Callable] = None


def build_cell(cfg: ModelConfig, shape: InputShape, mesh, planner_mode: str = "fairkv_dp",
               extra_copies: int = 4, weights_2d: bool = False,
               quantize: Optional[bool] = None) -> CellArtifacts:
    """The cell's arguments under the rules, rank 0's shards on the mesh's
    device (``mesh``: a `repro_torch.launch.mesh.Mesh`, or ``{axis: size}``
    for shards on the CPU), and its step ``fn`` (on a `Mesh` only)."""
    axes = mesh_axes(mesh)
    device = "cpu" if isinstance(mesh, dict) else mesh.device
    n_model = axes["model"]
    ccfg = cell_ccfg(cfg, shape)
    if quantize is None:
        quantize = quantize_auto(cfg, n_model)
    if shape.kind == "train":
        rules = train_rules(axes)
        params = params_fake(cfg, shape)
        p_spec = tree_specs(params, rules, "train")
        opt = opt_fake(params)
        o_spec = AdamWState(step=(), master=p_spec, mu=p_spec, nu=p_spec)
        batch = batch_fake(cfg, shape)
        trees, specs = (params, opt, batch), (p_spec, o_spec, batch_specs(batch, rules))
        meta = {"ccfg": ccfg}
    else:
        plan = cell_plan(cfg, n_model, planner_mode, extra_copies,
                         batch_cap=shape.global_batch)
        rules = serve_rules(axes, long_context=shape.name == "long_500k",
                            weights_2d=weights_2d)
        sp = serve_params_fake(cfg, shape, plan, quantize=quantize)
        sp_spec = tree_specs(sp, rules, "serve")
        pa, pa_spec = plan_arrays_fake(plan, rules) if plan is not None else (None, None)
        if shape.kind == "prefill":
            batch = batch_fake(cfg, shape)
            trees = (sp, batch, pa)
            specs = (sp_spec, batch_specs(batch, rules), pa_spec)
        else:
            state, st_spec = serve_state_fake(cfg, shape, plan, ccfg, rules)
            trees, specs = (sp, state, pa), (sp_spec, st_spec, pa_spec)
        meta = {"ccfg": ccfg, "plan": plan, "weights_2d": weights_2d, "quantize": quantize}
    args = tuple(_shard(t, s, axes, device) for t, s in zip(trees, specs))
    if isinstance(mesh, dict):
        fn = _refused("a cell built for axis sizes has no ranks: build it on a "
                      "repro_torch.launch.mesh.Mesh to run its step")
    elif shape.kind == "train":
        fn = train_step(cfg, mesh, rules, specs[0], shape.global_batch, shape.seq_len)
    else:
        fn = serve_step(shape.kind, cfg, ccfg, mesh, rules, specs[0],
                        0 if plan is None else plan.n_slots, shape.global_batch)
    return CellArtifacts(kind=shape.kind, args=args, specs=specs, rules=rules,
                         arg_bytes_per_rank=tree_bytes(args), meta=meta, fn=fn)


# ---------------------------------------------------------------------------
# What the port's mesh executor holds on a rank
# ---------------------------------------------------------------------------


def _to_device(tree, device):
    return _map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=device), tree)


def executor_args(cfg: ModelConfig, shape: InputShape, mesh, executor, plan: HeadPlacement,
                  ccfg: CompressionConfig) -> dict:
    """Rank ``mesh.rank``'s inputs of the executor's steps, fake, on the
    mesh's device: ``sp`` (its slots' weights, bf16: the executor refuses
    int8; everything else whole), ``pa``, and for a decode cell the live
    ``state`` (its cache corner, the global last tokens), for a prefill
    cell the global prompt ``batch``."""
    dev = mesh.device
    sl = executor.local_slots(plan.n_slots)
    sp = _to_device(serve_params_fake(cfg, shape, plan, slots=sl), dev)
    pa = PlanArrays.from_plan(plan, device=dev)
    B = shape.global_batch
    out = {"sp": sp, "pa": pa}
    if shape.kind == "prefill":
        out["batch"] = {"tokens": torch.empty((B, shape.seq_len), dtype=torch.int64, device=dev)}
    else:
        r = mesh.rows(B)
        cache: SlotCache = init_cache(cfg.n_layers, sl.stop - sl.start, r.stop - r.start,
                                      ccfg.static_capacity(), cfg.head_dim, dtype=BF16,
                                      device=dev)
        out["state"] = _serve.ServeState(
            cache=cache, last_tokens=torch.zeros((B,), dtype=torch.int64, device=dev),
            decode_steps=0)
    return out
