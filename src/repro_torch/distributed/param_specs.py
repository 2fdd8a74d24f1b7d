"""Per-leaf sharding specs of parameter / state trees (port of
``repro.distributed.param_specs``).

A spec is a tuple, one entry per dim: ``None`` (whole) or the mesh axes
the dim splits over (a name or a tuple of names).  Rules are
divisibility-guarded: a logical axis maps onto its mesh axes only when the
dim divides their product (hymba's 25 query heads cannot split 16 ways, so
they stay whole), so every arch gets a spec on every mesh.  A
`repro_torch.serving.quant.QTensor`'s codes take their parent weight's
spec and its scale stays whole, as in the reference.

`local_shard` slices a real tree to one rank's shards (the counterpart of
placing arrays with a ``NamedSharding``).  There a `QTensor`'s scale takes
the slice matching its codes along every dim split over ``model`` (the
``kv_slot`` slots, ``w1`` / ``w3``'s ``ff`` columns, the int8 embedding's
rows over ``vocab``), so that the shard dequantizes by itself; a dim
split over ``data`` (``weights_2d``'s ``fsdp_w``) is all-gathered whole
before every product, so its scale stays whole.  `localize_scales` does
the same to shards whose scales are whole (the dry run's arguments, which
keep the rules' layout).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.distributed.sharding import MeshAxes, ShardingRules, mesh_group
from repro_torch.serving.quant import QTensor

Spec = Tuple[MeshAxes, ...]


def guarded(rules: ShardingRules, dim: int, logical: Optional[str]) -> MeshAxes:
    """``logical``'s mesh axes if ``dim`` divides their extent, else None."""
    return rules.guarded(dim, logical)


def spec_for(rules: ShardingRules, shape: Tuple[int, ...],
             logical: Tuple[Optional[str], ...]) -> Spec:
    if len(shape) != len(logical):
        raise ValueError(f"shape {tuple(shape)} has {len(shape)} dims, logical axes {logical}")
    return tuple(guarded(rules, d, name) for d, name in zip(shape, logical))


def shard_shape(shape: Tuple[int, ...], spec: Spec, axes: Dict[str, int]) -> Tuple[int, ...]:
    """One rank's shape of a leaf of ``shape`` under ``spec`` on a mesh of
    ``axes`` sizes (``NamedSharding.shard_shape``)."""
    rules = ShardingRules(axes=axes)
    out = []
    for d, phys in zip(shape, spec):
        n = rules.size(phys)
        if d % n:
            raise ValueError(f"dim {d} does not split over {phys} ({n} ranks)")
        out.append(d // n)
    return tuple(out)


# leaf name → logical axes per dim (original / train layout)
_TRAIN_MAP = {
    "embed": ("vocab", "fsdp"),
    "head": ("vocab", "fsdp"),
    # train attention is sequence-parallel, so attention weights shard
    # over fsdp only
    "wq": ("fsdp", None, None),
    "wk": ("fsdp", None, None),
    "wv": ("fsdp", None, None),
    "wo": (None, None, "fsdp"),
    "bq": (None, None),
    "bk": (None, None),
    "bv": (None, None),
    "w1": ("fsdp", "ff"),
    "w3": ("fsdp", "ff"),
    "w2": ("ff", "fsdp"),
    "router": (None, "expert"),
    "we1": ("expert", "fsdp", None),
    "we3": ("expert", "fsdp", None),
    "we2": ("expert", None, "fsdp"),
    "in_proj": ("fsdp", "ff"),
    "out_proj": ("ff", "fsdp"),
    "conv_w": (None, "ff"),
    "enc_pos": (None, None),
    "dec_pos": (None, None),
}

# serve layout (slot weights); "fsdp_w" is the data axis under
# serve_rules(weights_2d=True), else None
_SERVE_MAP = {
    **_TRAIN_MAP,
    "wq_s": ("kv_slot", "fsdp_w", None, None),
    "wk_s": ("kv_slot", "fsdp_w", None),
    "wv_s": ("kv_slot", "fsdp_w", None),
    "wo_s": ("kv_slot", None, None, "fsdp_w"),
    "bq_s": ("kv_slot", None, None),
    "bk_s": ("kv_slot", None),
    "bv_s": ("kv_slot", None),
    "attn_out_norm_s": ("kv_slot", None, None),
    "embed": ("vocab", "fsdp_w"),
    "head": ("vocab", "fsdp_w"),
    "w1": ("fsdp_w", "ff"),
    "w3": ("fsdp_w", "ff"),
    "w2": ("ff", "fsdp_w"),
    "we1": ("expert", "fsdp_w", None),
    "we3": ("expert", "fsdp_w", None),
    "we2": ("expert", None, "fsdp_w"),
    "in_proj": ("fsdp_w", "ff"),
    "out_proj": ("ff", "fsdp_w"),
    "wq": ("fsdp_w", "heads", None),
    "wk": ("fsdp_w", "kv_heads", None),
    "wv": ("fsdp_w", "kv_heads", None),
    "wo": ("heads", None, "fsdp_w"),
    "c_wq": ("fsdp_w", "heads", None),
    "c_wk": ("fsdp_w", "kv_heads", None),
    "c_wv": ("fsdp_w", "kv_heads", None),
    "c_wo": ("heads", None, "fsdp_w"),
}
# cross-attention weights in train layout
for _k in ("wq", "wk", "wv", "wo", "bq", "bk", "bv"):
    _TRAIN_MAP["c_" + _k] = _TRAIN_MAP[_k]


def _one(key: str, shape, rules: ShardingRules, table: dict) -> Spec:
    logical = table.get(key)
    if logical is None or len(logical) != len(shape):
        return (None,) * len(shape)  # norms / scalars / unknown: whole
    return spec_for(rules, tuple(shape), logical)


def leaf_spec(key: str, shape: Tuple[int, ...], rules: ShardingRules, mode: str = "train") -> Spec:
    """The spec of a leaf named ``key`` of ``shape`` (`tree_specs`' rule)."""
    return _one(key, tuple(shape), rules, _TRAIN_MAP if mode == "train" else _SERVE_MAP)


def tree_specs(tree: Any, rules: ShardingRules, mode: str = "train", key: str = "root") -> Any:
    """The spec tree matching ``tree`` (a dict / list / tuple / NamedTuple
    tree of tensors or `QTensor` leaves); a leaf's
    spec comes from the last dict key on its path (the reference's
    ``tree_pspecs``)."""
    table = _TRAIN_MAP if mode == "train" else _SERVE_MAP
    if isinstance(tree, QTensor):
        return QTensor(q=_one(key, tree.q.shape, rules, table),
                       scale=(None,) * len(tree.scale.shape))
    if isinstance(tree, dict):
        return {k: tree_specs(v, rules, mode, str(k)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_specs(v, rules, mode, key) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_specs(v, rules, mode, key) for v in tree)
    return _one(key, tree.shape, rules, table)


# ---------------------------------------------------------------------------
# One rank's shards of a real tree
# ---------------------------------------------------------------------------


def _narrow(t: torch.Tensor, dim: int, phys: MeshAxes, mesh) -> torch.Tensor:
    """The rank's slice of ``t`` along ``dim``, split over ``phys`` (a view)."""
    g = mesh_group(mesh, phys)
    n = t.shape[dim] // g.size
    return t.narrow(dim, g.rank * n, n)


def _scale_shard(scale: torch.Tensor, spec: Spec, q_whole: Tuple[int, ...], mesh):
    """A `QTensor` scale narrowed to the rank's slice along the dims its
    codes split over ``model`` where the scale spans the codes' whole
    extent ``q_whole`` (a scale of 1 along a dim broadcasts)."""
    for d, phys in enumerate(spec):
        if phys == "model" and scale.shape[d] > 1 and scale.shape[d] == q_whole[d]:
            scale = _narrow(scale, d, phys, mesh)
    return scale


def _walk(fn, tree, specs):
    """``fn(leaf, spec)`` over a dict / list / tuple / NamedTuple tree and
    its spec tree; `QTensor` leaves go to ``fn`` whole, None stays."""
    if tree is None or isinstance(tree, (QTensor, torch.Tensor)):
        return None if tree is None else fn(tree, specs)
    if isinstance(tree, dict):
        return {k: _walk(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_walk(fn, v, s) for v, s in zip(tree, specs)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(fn, v, s) for v, s in zip(tree, specs))
    raise TypeError(f"local_shard: unsupported node {type(tree).__name__}")


def local_shard(tree: Any, specs: Any, mesh) -> Any:
    """``mesh``'s rank's shards of a whole ``tree`` (tensors or `QTensor`
    leaves under dict / list / tuple / NamedTuple nodes) under ``specs``
    (`tree_specs`, or a spec tree of the same structure): each dim split
    over ``model`` or ``data`` cut to the rank's index in that group
    (``shard_shape`` of the leaf).  A cut leaf is a contiguous copy that
    owns its elements only (a view would keep the whole tensor's storage
    alive); a whole leaf is the tree's own tensor.  A `QTensor`'s scale is
    cut along the dims its codes split over ``model`` (module
    docstring)."""
    def own(view, t):
        return t.contiguous() if view is t else view.clone(
            memory_format=torch.contiguous_format)

    def cut(t, spec):
        out = t
        for d, phys in enumerate(spec):
            if phys is not None:
                out = _narrow(out, d, phys, mesh)
        return own(out, t)

    def one(leaf, spec):
        if isinstance(leaf, QTensor):
            scale = _scale_shard(leaf.scale, spec.q, tuple(leaf.q.shape), mesh)
            return QTensor(q=cut(leaf.q, spec.q), scale=own(scale, leaf.scale))
        return cut(leaf, spec)

    return _walk(one, tree, specs)


def localize_scales(tree: Any, specs: Any, mesh) -> Any:
    """A tree of the rank's shards (``specs`` its spec tree) whose `QTensor`
    scales are whole, as the rules lay them out, with each scale narrowed
    as `local_shard` cuts it (views: no bytes); scales already cut pass."""
    def one(leaf, spec):
        if not isinstance(leaf, QTensor):
            return leaf
        whole = tuple(n * (mesh_group(mesh, p).size if p == "model" else 1)
                      for n, p in zip(leaf.q.shape, spec.q))
        return QTensor(q=leaf.q, scale=_scale_shard(leaf.scale, spec.q, whole, mesh))

    return _walk(one, tree, specs)
