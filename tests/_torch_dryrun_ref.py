"""The reference side of `tests/test_torch_dryrun.py`, run as a script in a
subprocess (the host device count must be set before JAX is imported):

    XLA_FLAGS=--xla_force_host_platform_device_count=N \\
        python tests/_torch_dryrun_ref.py specs|bytes|audit

``specs``: ``tree_pspecs`` of every arch's full config in train and serve
modes (serve with and without ``long_context`` and ``weights_2d``) on the
(2, 4), (16, 16) and (2, 16, 16) meshes, and ``cell_plan`` per arch and
planner; ``bytes``: Σ ``sharding.shard_shape(leaf.shape)`` x itemsize over
``build_cell(...).args`` for every applicable cell of both production
meshes; ``audit``: ``run_executor_audit``'s decode step with minitron-8b's
smoke config on a (data 2, model 4) mesh of 8 host devices, with the
all-reduces' types as lowered (XLA:CPU compiles a bf16 all-reduce in f32).  Prints one
JSON object as its last line.  Nothing is compiled but the audit's step.
"""
from __future__ import annotations

import json
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from repro.configs import ALL_ARCHS, SHAPES, get_config, get_smoke_config
from repro.distributed.param_specs import tree_pspecs
from repro.distributed.sharding import serve_rules, train_rules
from repro.launch.specs import build_cell, cell_plan, params_sds, serve_params_sds

MESHES = {"2x4": ((2, 4), ("data", "model")), "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
PLANNERS = ("sha", "fairkv_nodp", "fairkv_dp")


def mesh_of(name):
    shape, axes = MESHES[name]
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)


def _key(path) -> str:
    parts = []
    for p in path:
        for attr in ("key", "idx", "name"):
            if hasattr(p, attr):
                parts.append(str(getattr(p, attr)))
                break
    return "/".join(parts)


def _entry(e):
    return list(e) if isinstance(e, tuple) else e


def flat_specs(specs, tree) -> dict:
    """{path: one entry per dim} of a PartitionSpec tree over ``tree``."""
    sp = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, P))[0]
    leaves = jax.tree.leaves(tree)
    out = {}
    for (path, spec), leaf in zip(sp, leaves):
        entries = [_entry(e) for e in spec] + [None] * (len(leaf.shape) - len(spec))
        out[_key(path)] = entries
    return out


def specs() -> dict:
    out, plans = {}, {}
    decode = SHAPES["decode_32k"]
    for arch in ALL_ARCHS:
        cfg = get_config(arch)
        params = params_sds(cfg, SHAPES["train_4k"])
        serve = {}
        for name in MESHES:
            mesh = mesh_of(name)
            n_model = mesh.shape["model"]
            out[f"{arch}|{name}|train"] = flat_specs(
                tree_pspecs(params, train_rules(mesh), "train"), params)
            if n_model not in serve:
                plan = cell_plan(cfg, n_model, batch_cap=decode.global_batch)
                quantize = cfg.param_count() * 2 / n_model > 10e9
                serve[n_model] = serve_params_sds(cfg, decode, plan, jnp.bfloat16,
                                                  quantize=quantize)
            for lc in (False, True):
                for w2 in (False, True):
                    rules = serve_rules(mesh, long_context=lc, weights_2d=w2)
                    out[f"{arch}|{name}|serve|{int(lc)}|{int(w2)}"] = flat_specs(
                        tree_pspecs(serve[n_model], rules, "serve"), serve[n_model])
        for mode in PLANNERS:
            for n_model in (4, 16):
                plan = cell_plan(cfg, n_model, mode, batch_cap=decode.global_batch)
                plans[f"{arch}|{mode}|{n_model}"] = None if plan is None else {
                    k: v.tolist() for k, v in plan.as_arrays().items()}
    return {"specs": out, "plans": plans}


def arg_bytes() -> dict:
    out = {}
    for name in ("16x16", "2x16x16"):
        mesh = mesh_of(name)
        for arch in ALL_ARCHS:
            cfg = get_config(arch)
            for shape_name, shape in SHAPES.items():
                if shape_name in cfg.shape_skips:
                    continue
                cell = build_cell(cfg, shape, mesh)
                total = 0
                for leaf in jax.tree.leaves(cell.args):
                    shd = getattr(leaf, "sharding", None)
                    shp = leaf.shape if shd is None else shd.shard_shape(leaf.shape)
                    total += int(np.prod(shp)) * leaf.dtype.itemsize
                out[f"{name}|{arch}|{shape_name}"] = total
    return out


def audit() -> dict:
    """`run_executor_audit`'s body with minitron-8b's smoke config on a
    (data 2, model 4) host mesh."""
    from repro.api import PlanArrays, ServeState
    from repro.cache.slot_cache import SlotCache
    from repro.compression.base import CompressionConfig
    from repro.distributed.hlo_stats import collective_stats, while_body_stats
    from repro.exec.mesh import MeshExecutor
    from repro.launch.mesh import make_host_mesh

    cfg = get_smoke_config("minitron-8b")
    shape = SHAPES["decode_32k"]
    mesh = make_host_mesh(model=4, data=2)
    ccfg = CompressionConfig(policy="ada_snapkv", budget=1024, alpha_max=1.5, decode_margin=64)
    plan = cell_plan(cfg, 4, "fairkv_dp", batch_cap=shape.global_batch)
    pa = PlanArrays.from_plan(plan)
    sp = serve_params_sds(cfg, shape, plan, jnp.bfloat16, quantize=False)
    B, L, S = shape.global_batch, cfg.n_layers, plan.n_slots
    cap, Dh = ccfg.static_capacity(), cfg.head_dim
    sds = jax.ShapeDtypeStruct
    state = ServeState(
        cache=SlotCache(k=sds((L, S, B, cap, Dh), jnp.bfloat16),
                        v=sds((L, S, B, cap, Dh), jnp.bfloat16),
                        lengths=sds((L, S, B), jnp.int32), pos=sds((L, S, B, cap), jnp.int32),
                        positions=sds((B,), jnp.int32)),
        ssm_state=None, conv_state=None, cross_k=None, cross_v=None,
        last_tokens=sds((B,), jnp.int32), decode_steps=sds((), jnp.int32))
    ex = MeshExecutor(cfg, ccfg, mesh=mesh)
    tokens = sds((B,), jnp.int32)
    hlo = ex.decode_hlo(sp, state, pa, tokens)
    # the program as lowered, before XLA:CPU rewrites bf16 collectives in f32
    args = (sp, state, pa) + ex._norm_decode_args(tokens, None, None)
    lowered = ex._decode_jit_for(sp, state).lower(*args).as_text()
    reduces = re.findall(r'stablehlo\.all_reduce".*?\}\) : \(tensor<([\dx]+)x(\w+)>\)',
                         lowered, flags=re.S)
    return {"collectives": collective_stats(hlo), "while_bodies": while_body_stats(hlo),
            "n_layers": L, "lowered_all_reduce": reduces}


if __name__ == "__main__":
    print(json.dumps({"specs": specs, "bytes": arg_bytes, "audit": audit}[sys.argv[1]]()))
