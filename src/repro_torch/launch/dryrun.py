"""Production dry run of the port: every (arch × shape × mesh) cell on fake
tensors under a fake process group (port of ``repro.launch.dryrun``).

For each cell this records, per rank:

- ``memory.argument_bytes``: the cell's arguments laid out by the
  reference's logical-axis rules (`repro_torch.launch.specs.build_cell`),
  always;
- ``executed``: the cell's own step (``build_cell(...).fn``, the
  reference's: `decode_step` or `prefill` on the rank's shards under
  ``serve_rules`` for every serve cell, decode_32k, prefill_32k and
  long_500k, and `train_step` under ``train_rules`` for every train_4k
  cell, of every family) run once on rank 0 of the mesh on fake tensors,
  on the cell's arguments, with its argument, output, temp and peak
  bytes, FLOPs, bytes read and written and collectives
  (`repro_torch.distributed.step_stats`); for a train cell also its
  ``contract`` (`train_contract`), for a decode cell its ``contract``
  (`decode_contract`), the collectives
  `decode_collectives` derives from the splits: for a dense cell 2·L + 1
  all-reduces of (B / data, d_model) over ``model`` (the embedding, each
  layer's o-projection and MLP), one all-gather of the argmax's (B /
  data, 2) pairs over it and nothing over ``data``; the split-S (o, lse)
  pairs' one all-gather a layer over ``data`` at long_500k; MoE's expert
  counts' one a layer over ``data`` and its router's columns' over
  ``model``; the SSD branch's gathers and sums, the hybrid's slot-norm Σ
  and cross attention's o-projection sum where their dims split;
- ``fits``: the executed step's peak (else the rules' arguments) within
  ``device_bytes``, the card's memory when one is present, else
  ``--device-bytes``.

Every cell the port builds executes its step; cells an arch skips are
``skipped`` with its reason.  ``--executor-audit`` records the
mesh executor's decode collectives on the production (data 16, model 16)
mesh instead: one all-reduce over ``model`` per attention layer (the
o-projection) and no all-gather over it; that executor keeps the MLP and
the vocab whole on every rank (as the reference's does) and gathers the
step's tokens and logits over ``data``.

The fake group has 256 or 512 ranks in this one process; its collectives
move nothing.  Nothing allocates device memory: fake ``cuda`` tensors need
no card.  Records land in ``experiments/dryrun_torch/<tag>.json``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
        [--mesh single|multi|both] [--planner fairkv_dp|sha|fairkv_nodp]
        [--executor-audit] [--out DIR] [--device-bytes N]
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import time
import traceback
from typing import Optional

import torch

from repro_torch.configs import ALL_ARCHS, SHAPES, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import step_stats
from repro_torch.launch import specs
from repro_torch.launch.mesh import fake_process_group, make_production_mesh

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments",
                       "dryrun_torch")
# torch.cuda.get_device_properties(0).total_memory of an NVIDIA H100 80GB
# HBM3 (power limit 700.00 W), the default when no card is present
H100_BYTES = 85_017_493_504
# the device of a train cell's fake tensors: autograd's bookkeeping of a
# fake CUDA tensor takes a device guard, which a torch built without CUDA
# lacks; a fake tensor's bytes are the same on either device
TRAIN_FAKE_DEVICE = "cpu"


def device_bytes(default: int = H100_BYTES) -> int:
    """The card's memory when one is present, else ``default``."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).total_memory
    return default


def decode_collectives(cfg: ModelConfig, rows: int, model: int, data: int = 1,
                       split_s: bool = False) -> dict:
    """The decode cell step's collectives on a rank of a (data, model) mesh
    under ``serve_rules`` (``rows`` = its B / data rows, ``split_s`` the
    long-context rules), derived from which dims the rules split (a
    guarded dim that divides the group's extent has a group, of one rank
    too): ``{group: {kind: (calls, elements)}}``.  Over ``model``, the
    all-reduces: the embedding's; a layer's o-projection (attention),
    ``out_proj`` (SSD), cross attention's o-projection (its heads split)
    and MLP or experts, each (rows, d_model); a layer's Σx² of the
    hybrid's slot norm and of the SSD's gated norm (its heads split over
    more than one rank), each (rows, 1).  Its all-gathers: the argmax's
    (rows, 2) pairs, an MoE layer's router columns (its experts split),
    an SSD layer's ``in_proj`` columns and conv channels (each where they
    split).  Over ``data``: split-S's (o, lse) pairs, one gather an
    attention layer, and MoE's expert counts, one a layer, when the rows
    split."""
    from repro_torch.distributed.sharding import serve_rules
    rules = serve_rules({"data": data, "model": model}, long_context=split_s)

    def split(logical, n):  # the dim has a group
        return n > 0 and rules.guarded(n, logical) is not None

    L, D, E = cfg.n_layers, cfg.d_model, cfg.moe.num_experts
    attn, s = not cfg.attention_free, cfg.ssm
    ssm = cfg.family in ("ssm", "hybrid")
    d_in, gn = s.d_inner, 2 * s.n_groups * s.state_size
    moe_split = E > 0 and model > 1 and split("expert", E)
    full = 1 + L * (attn + (ssm and split("ff", d_in))
                    + (cfg.is_encoder_decoder and split("heads", cfg.n_heads))
                    + (E > 0 or split("ff", cfg.d_ff)))
    sums = L * ((cfg.family == "hybrid") + (ssm and model > 1 and split("heads", s.num_heads)))
    proj, conv = 2 * d_in + gn + s.num_heads, d_in + gn
    gathers = [(1, rows * 2 * model)]
    if moe_split:
        gathers.append((L, L * D * E))
    if ssm and split("ff", proj):
        gathers.append((L, L * rows * proj))
    if ssm and split("ff", conv):
        gathers.append((L, L * rows * conv))
    out = {"model": {"all_reduce": (full + sums, (full * D + sums) * rows),
                     "all_gather": tuple(map(sum, zip(*gathers)))}}
    # over data, one gather a layer: split-S's pairs (the columns split), or
    # MoE's counts (the rows)
    if data > 1 and (attn if split_s else E > 0):
        out["data"] = {"all_gather": (L, None)}
    return out


def decode_contract(by_group: dict, cfg: ModelConfig, rows: int, model: int,
                    data: int = 1, split_s: bool = False) -> dict:
    """The decode cell step's collectives (`decode_collectives`) checked on
    a `StepStats.by_group` record: over ``model`` the all-reduces' and the
    all-gathers' calls and elements; over ``data`` one all-gather a layer,
    or nothing."""
    want = decode_collectives(cfg, rows, model, data, split_s)
    over_model, over_data = by_group.get("model", {}), by_group.get("data", {})

    def held(got, calls_elems):
        calls, elems = calls_elems
        return got.get("calls") == calls and elems in (None, got.get("elements"))

    out = {f"model_{kind}s": held(over_model.get(kind, {}), want["model"][kind])
           for kind in ("all_reduce", "all_gather")}
    if "data" in want:
        out["data_one_all_gather_per_layer"] = (
            set(over_data) == {"all_gather"} and held(over_data["all_gather"],
                                                       want["data"]["all_gather"]))
    else:
        out["nothing_over_data"] = not over_data
    return out


def _train_leaves(cfg: ModelConfig, max_seq_len: int = 4096) -> list:
    """Every parameter leaf of ``cfg``'s tree (`init_params`' layout) as
    (where, name, shape, uses): ``where`` is ``"layer"`` (one a decoder
    layer), ``"enc"`` (one an encoder layer) or ``"top"``; ``uses`` counts
    the products that read a weight in one forward, as (inside the layer's
    remat region, outside it); a leaf the forward never reads (mamba2's
    ``ln2``, the hybrid's ``ssm_out_norm``) has None."""
    D, F, E = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    hq, hkv, dh, s = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.ssm
    one, no = (1, 0), (0, 0)

    def attn(prefix="", uses=(one,) * 4):
        out = [(prefix + "wq", (D, hq, dh), uses[0]), (prefix + "wk", (D, hkv, dh), uses[1]),
               (prefix + "wv", (D, hkv, dh), uses[2]), (prefix + "wo", (hq, dh, D), uses[3])]
        if cfg.qkv_bias:
            out += [(prefix + "bq", (hq, dh), no), (prefix + "bk", (hkv, dh), no),
                    (prefix + "bv", (hkv, dh), no)]
        return out

    layer = [("ln1", (D,), no)]
    ffn = F > 0 or E > 0
    layer.append(("ln2", (D,), no if ffn else None))
    if not cfg.attention_free:
        layer += attn()
    if cfg.family in ("ssm", "hybrid"):
        d_in, H = s.d_inner, s.num_heads
        gn = 2 * s.n_groups * s.state_size
        layer += [("in_proj", (D, 2 * d_in + gn + H), one),
                  ("conv_w", (s.conv_width, d_in + gn), no), ("A_log", (H,), no),
                  ("ssm_D", (H,), no), ("dt_bias", (H,), no), ("ssm_norm", (d_in,), no),
                  ("out_proj", (d_in, D), one)]
    if cfg.family == "hybrid":
        layer += [("attn_out_norm", (hq * dh,), no), ("ssm_out_norm", (s.d_inner,), None)]
    if E > 0:
        Fe = cfg.moe.d_expert
        layer += [("router", (D, E), no), ("we1", (E, D, Fe), one), ("we3", (E, D, Fe), one),
                  ("we2", (E, Fe, D), one)]
    elif F > 0:
        layer += [("w1", (D, F), one), ("w3", (D, F), one), ("w2", (F, D), one)]
    if cfg.is_encoder_decoder:  # cross K / V are made outside the layers
        layer += attn("c_", (one, (0, 1), (0, 1), one)) + [("ln_cross", (D,), no)]
    V = cfg.padded_vocab
    out = [("layer",) + leaf for leaf in layer]
    out += [("top", "embed", (V, D), (0, 2 if cfg.tie_embeddings else 1)),
            ("top", "final_norm", (D,), no)]
    if not cfg.tie_embeddings:
        out.append(("top", "head", (V, D), (0, 1)))
    if cfg.is_encoder_decoder:
        enc = [("ln1", (D,), no), ("ln2", (D,), no)] + [
            (n, shape, (0, 1) if u else u) for n, shape, u in attn()] + [
            ("w1", (D, F), (0, 1)), ("w3", (D, F), (0, 1)), ("w2", (F, D), (0, 1))]
        out += [("enc",) + leaf for leaf in enc]
        out += [("top", "enc_final_norm", (D,), no),
                ("top", "enc_pos", (cfg.encoder_seq_len, D), no),
                ("top", "dec_pos", (max_seq_len, D), no)]
    return out


def train_collectives(cfg: ModelConfig, rows: int, seq: int, model: int, data: int = 1,
                      pods: int = 1, max_seq_len: int = 4096) -> dict:
    """A train cell step's collectives on a rank of a (pod, data, model)
    mesh under ``train_rules`` (``rows`` = its B / (pods · data) rows of
    ``seq`` positions, a VLM's image prefix and text; ``max_seq_len`` the
    rows of an encoder-decoder's ``dec_pos``), derived from the splits and
    the leaves' specs (with remat; a group of one issues nothing):
    ``{group: {kind: (calls, elements)}}``, the in-pod data group named
    ``"data"`` on one pod and ``"data_in_pod"`` beside the folded
    ``"data"`` on more.  A layer's collectives run in the forward and
    again in the backward's recompute, but for the last partial sum of a
    layer, after which nothing is saved (the non-reentrant checkpoint's
    early stop skips it); each differentiable one issues its pair in the
    backward (`repro_torch.distributed.comm`).

    - ``model`` (more than one rank), over the whole (rows, T, D)
      sequence and the (rows, T / model, D) slice: a layer's gathers of
      its normed input for attention's K / V or the SSD scan (one, shared
      by the hybrid's two branches) and of ``hn2`` for the MLP or the
      experts; its partial sums reduce-scattered onto the slice (the MLP's,
      the experts', ``out_proj``'s); the MoE router's columns and the
      SSD's ``in_proj`` columns and conv channels gathered where they
      split, and the gated norm's Σx² summed where the SSD heads split;
      the encoder's MLP summed whole (its frames do not split); the
      embedding's reduce-scatter, ``final_norm``'s gather, the
      vocab-parallel xent's max and (Σexp, gold) over the (rows, text − 1)
      labels; the gradient of every leaf whole over ``model``.
    - the in-pod data group (more than one rank), where a weight's d_model
      dim splits: a gather before each product that reads it (the
      embedding table twice: lookup and logits) and its backward's
      reduce-scatter; the gradients of the leaves whole over ``data``.
    - the rows' group (the data group on one pod, the folded one on
      more): an MoE layer's expert counts gathered, and one all-reduce of
      the xent metric.
    - ``pod``: one all-reduce of every leaf's gradient.
    - ``world``: an MoE layer's router probabilities summed (the aux
      loss's P̄) and the global norm's one scalar."""
    from repro_torch.distributed.param_specs import leaf_spec
    from repro_torch.distributed.sharding import train_rules

    axes = {"pod": pods, "data": data, "model": model} if pods > 1 else {
        "data": data, "model": model}
    rules = train_rules(axes)
    L, Le, D, E = cfg.n_layers, cfg.n_encoder_layers, cfg.d_model, cfg.moe.num_experts
    mult = {"layer": L, "enc": Le, "top": 1}
    t_loc = seq // model
    whole, part = rows * seq * D, rows * t_loc * D
    text = seq - cfg.num_image_tokens if cfg.is_vlm else seq
    s, ssm = cfg.ssm, cfg.family in ("ssm", "hybrid")
    dgroup = "data" if pods == 1 else "data_in_pod"
    world = model * data * pods
    out: dict = {}

    def add(group, kind, calls, elems):
        c, e = out.setdefault(group, {}).get(kind, (0, 0))
        out[group][kind] = (c + calls, e + elems)

    def splits(logical, dim):
        return model > 1 and dim > 0 and rules.guarded(dim, logical) is not None

    for where, name, shape, uses in _train_leaves(cfg, max_seq_len):
        if uses is None:
            continue
        spec = leaf_spec(name, shape, rules)
        named = {a for phys in spec if phys is not None
                 for a in ((phys,) if isinstance(phys, str) else phys)}
        n = math.prod(shape) // math.prod(rules.size(phys) for phys in spec)
        k = mult[where]
        inside, outside = uses
        if data > 1 and "data" in named:  # FSDP: a gather per product, its reduce-scatter
            add(dgroup, "all_gather", k * (2 * inside + outside), k * (2 * inside + outside)
                * n * data)
            add(dgroup, "reduce_scatter", k * (inside + outside), k * (inside + outside) * n)
        for group, on, size in (("model", "model", model), (dgroup, "data", data),
                                ("pod", None, pods)):
            if size > 1 and on not in named:
                add(group, "all_reduce", k, k * n)

    if model > 1:
        seq_gathers = (not cfg.attention_free or ssm) + (cfg.d_ff > 0 or E > 0)
        # (calls in the forward and the recompute) of the layer's partial sums
        # onto the slice: the last one runs once
        sums = (ssm + (cfg.d_ff > 0 or E > 0)) if cfg.family == "hybrid" else 1
        fwd_sums = 2 * sums - 1
        add("model", "all_gather", L * (2 * seq_gathers + sums) + 2,
            (L * (2 * seq_gathers + sums) + 2) * whole)
        add("model", "reduce_scatter", L * (fwd_sums + seq_gathers) + 2,
            (L * (fwd_sums + seq_gathers) + 2) * part)
        add("model", "all_reduce", 2, 3 * rows * (text - 1))
        if E > 0 and splits("expert", E):  # the router's columns
            add("model", "all_gather", 2 * L, 2 * L * D * E)
            add("model", "reduce_scatter", L, L * D * E // model)
        if ssm:
            d_in, gn = s.d_inner, 2 * s.n_groups * s.state_size
            for dim in (2 * d_in + gn + s.num_heads, d_in + gn):  # in_proj, conv
                if splits("ff", dim):
                    add("model", "all_gather", 2 * L, 2 * L * rows * seq * dim)
                    add("model", "reduce_scatter", L, L * rows * seq * dim // model)
            if splits("heads", s.num_heads):  # the gated norm's Σx²
                add("model", "all_reduce", 3 * L, 3 * L * rows * seq)
        if Le and splits("ff", cfg.d_ff):  # the encoder's MLP, summed whole both ways
            add("model", "all_reduce", 2 * Le, 2 * Le * rows * cfg.encoder_seq_len * D)
    if data * pods > 1:
        if E > 0:  # the expert counts
            add("data", "all_gather", 2 * L, 2 * L * data * pods * 2 * E)
        add("data", "all_reduce", 1, 1)
    if world > 1:
        if E > 0:
            add("world", "all_reduce", 2 * L, 2 * L * E)
        add("world", "all_reduce", 1, 1)
    return out


def train_contract(by_group: dict, cfg: ModelConfig, rows: int, seq: int, model: int,
                   data: int = 1, pods: int = 1, max_seq_len: int = 4096) -> dict:
    """The train cell step's collectives (`train_collectives`) checked on a
    `StepStats.by_group` record: calls and elements of every (group, kind)
    either side names."""
    want = train_collectives(cfg, rows, seq, model, data, pods, max_seq_len)
    keys = {(g, k) for g, kinds in list(want.items()) + list(by_group.items()) for k in kinds}
    return {f"{g}_{k}": (by_group.get(g, {}).get(k, {}).get("calls"),
                         by_group.get(g, {}).get(k, {}).get("elements"))
            == want.get(g, {}).get(k) for g, k in sorted(keys)}


def _executor(cfg, mesh, ccfg):
    """The port's mesh executor on the fake mesh, eager (a graph capture
    needs a real stream) and without its device synchronize."""
    from repro_torch.exec.mesh import MeshExecutor

    ex = MeshExecutor(cfg, ccfg, mesh=mesh, graphs=False)
    ex.synchronize = lambda: None
    return ex


def run_step(cfg: ModelConfig, shape_name: str, mesh, planner_mode: str = "fairkv_dp",
             extra_copies: int = 4):
    """One `MeshExecutor` step of the cell on ``mesh`` (fake tensors
    inside): returns (its `StepStats`, its output)."""
    shape = SHAPES[shape_name]
    ccfg = specs.cell_ccfg(cfg, shape)
    plan = specs.cell_plan(cfg, mesh.model, planner_mode, extra_copies,
                           batch_cap=shape.global_batch)
    ex = _executor(cfg, mesh, ccfg)
    a = specs.executor_args(cfg, shape, mesh, ex, plan, ccfg)
    with torch.inference_mode():
        if shape.kind == "prefill":
            out, st = step_stats.measure(ex._prefill, (a["sp"], a["pa"], a["batch"]),
                                         a["sp"], a["batch"], a["pa"], None, None)
        else:
            out, st = step_stats.measure(ex._decode, (a["sp"], a["state"], a["pa"]),
                                         a["sp"], a["state"], a["pa"], None, None)
    return st, out


def run_cell(arch: str, shape_name: str, multi_pod: bool, planner_mode: str = "fairkv_dp",
             dev_bytes: Optional[int] = None) -> dict:
    """One cell's record (see the module docstring)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": "multi" if multi_pod else "single",
           "planner": planner_mode}
    if shape_name in cfg.shape_skips:
        return {**rec, "status": "skipped", "reason": cfg.shape_skips[shape_name]}
    dev_bytes = dev_bytes or device_bytes()
    t0 = time.time()
    train = shape.kind == "train"
    with fake_process_group(512 if multi_pod else 256), step_stats.fake_tensors():
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    device=TRAIN_FAKE_DEVICE if train else "cuda")
        cell = specs.build_cell(cfg, shape, mesh, planner_mode=planner_mode)
        t_build = time.time() - t0
        arg = cell.arg_bytes_per_rank
        rec.update(kind=cell.kind, weights_2d=bool(cell.meta.get("weights_2d", False)),
                   quantize=bool(cell.meta.get("quantize", False)),
                   memory={"argument_bytes": arg}, device_bytes=dev_bytes,
                   build_s=round(t_build, 2))
        t0 = time.time()
        # a train step differentiates: the saved activations and the
        # backward's temporaries count toward its peak
        with contextlib.nullcontext() if train else torch.inference_mode():
            _, st = step_stats.measure(cell.fn, cell.args, *cell.args)
        step = {"train": "repro_torch.training.train_loop.train_step",
                "prefill": "repro_torch.serving.engine.prefill"}.get(
                    cell.kind, "repro_torch.serving.engine.decode_step")
        rec["executed"] = {"step": f"{step} (build_cell(...).fn)",
                           "seconds": round(time.time() - t0, 2), **st.record()}
        if train:
            rec["executed"]["contract"] = train_contract(
                st.by_group, cfg, shape.global_batch // mesh.data, shape.seq_len,
                mesh.model, mesh.data // mesh.pods, mesh.pods, specs._max_seq(cfg, shape))
        if cell.kind == "decode":
            long_ctx = shape_name == "long_500k"
            rows = shape.global_batch // (1 if long_ctx else mesh.data)
            rec["executed"]["contract"] = decode_contract(
                st.by_group, cfg, rows, mesh.model, mesh.data, split_s=long_ctx)
        rec.update(status="ok", fits=st.peak_bytes <= dev_bytes)
        cell_kind = cell.kind
        del cell
    ex = rec["executed"]
    m, c = ex["memory"], ex["collectives"]
    line = (f"  rules args {arg / 1e9:8.2f} GB/rank | step args {m['argument_bytes'] / 1e9:.2f} "
            f"GB temp {m['temp_bytes'] / 1e9:.2f} GB peak {m['peak_per_device_gb']:.2f} GB "
            f"| flops/rank {ex['cost']['flops_per_device']:.3e} | " + ", ".join(
                f"{k}x{v['count']} ({v['bytes'] / 1e6:.1f} MB)" for k, v in sorted(c.items())))
    if "contract" in ex:
        ok = all(ex["contract"].values())
        line += f" | {cell_kind} contract {'held' if ok else ex['contract']}"
    print(line + f" | fits {rec['fits']} ({dev_bytes / 1e9:.1f} GB)")
    return rec


def run_executor_audit(arch: str, out_dir: Optional[str] = None,
                       planner_mode: str = "fairkv_dp", cfg: Optional[ModelConfig] = None,
                       model: int = 16, data: int = 16, dev_bytes: Optional[int] = None) -> dict:
    """The mesh executor's decode step at decode_32k on a fake (data,
    model) mesh (the production (16, 16) by default): its collectives by
    group, and rank 0's argument and peak bytes.  ``cfg`` overrides the
    arch's config (a smoke config for tests).  Writes
    ``<arch>__executor_decode.json`` under ``out_dir`` when given."""
    cfg = cfg or get_config(arch)
    dev_bytes = dev_bytes or device_bytes()
    t0 = time.time()
    with fake_process_group(model * data), step_stats.fake_tensors():
        mesh = make_production_mesh(model=model, data=data)
        st, _ = run_step(cfg, "decode_32k", mesh, planner_mode)
    g = st.by_group
    rec = {"arch": arch, "kind": "executor_decode", "planner": planner_mode,
           "mesh": {"data": data, "model": model}, "shape": "decode_32k", "status": "ok",
           "seconds": round(time.time() - t0, 2), "n_layers": cfg.n_layers,
           **st.record(), "device_bytes": dev_bytes, "fits": st.peak_bytes <= dev_bytes,
           "contract": {
               "model_all_reduce_per_layer": g.get("model", {}).get(
                   "all_reduce", {}).get("calls", 0) == cfg.n_layers,
               "no_all_gather_over_model": "all_gather" not in g.get("model", {})}}
    parts = [f"{grp} {kind} x{v['calls']} ({v['bytes']} B)"
             for grp in ("model", "data") for kind, v in sorted(g.get(grp, {}).items())]
    print(f"  executor decode step collectives/rank: {', '.join(parts) or 'none'} | "
          f"args {st.argument_bytes / 1e9:.2f} GB peak {st.peak_bytes / 1e9:.2f} GB/rank | "
          f"fits {rec['fits']} ({dev_bytes / 1e9:.1f} GB)")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{arch}__executor_decode.json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def sweep(archs, shapes, meshes, planner: str, out_dir: Optional[str],
          dev_bytes: Optional[int] = None) -> dict:
    """Every cell; returns ``{"ok", "skipped", "fail"}`` counts and the
    records.  A cell that raises is recorded as ``fail``."""
    counts = {"ok": 0, "skipped": 0, "fail": 0}
    records = []
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    for shape_name in shapes:
        for arch in archs:
            for multi in meshes:
                tag = f"{arch}__{shape_name}__{'multi' if multi else 'single'}"
                print(f"[{tag}] planner={planner}")
                try:
                    rec = run_cell(arch, shape_name, multi, planner, dev_bytes=dev_bytes)
                except Exception as e:  # record failures, keep going
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape_name,
                           "mesh": "multi" if multi else "single", "status": "fail",
                           "error": f"{type(e).__name__}: {e}"}
                counts[rec["status"]] += 1
                if rec["status"] == "skipped":
                    print(f"  SKIP: {rec['reason'][:100]}")
                records.append(rec)
                if out_dir:
                    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
                        json.dump(rec, f, indent=1)
                gc.collect()
    return {"counts": counts, "records": records}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None, help="default: all")
    ap.add_argument("--shape", default=None, help="default: all applicable")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--planner", default="fairkv_dp",
                    choices=["sha", "fairkv_nodp", "fairkv_dp"])
    ap.add_argument("--executor-audit", action="store_true",
                    help="audit the mesh executor's decode step collectives on the "
                         "(data 16, model 16) mesh instead of the cell sweep "
                         "(requires --arch; dense archs)")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--device-bytes", type=int, default=H100_BYTES,
                    help="a rank's device memory when no card is present (default: an "
                         "NVIDIA H100 80GB HBM3's, power limit 700.00 W)")
    args = ap.parse_args(argv)
    dev_bytes = device_bytes(args.device_bytes)
    if args.executor_audit:
        if not args.arch:
            raise SystemExit("--executor-audit requires --arch")
        run_executor_audit(args.arch, args.out, args.planner, dev_bytes=dev_bytes)
        return
    archs = [args.arch] if args.arch else ALL_ARCHS
    shapes = [args.shape] if args.shape else ["decode_32k", "long_500k", "prefill_32k",
                                              "train_4k"]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    res = sweep(archs, shapes, meshes, args.planner, args.out, dev_bytes)
    c = res["counts"]
    print(f"\ndone: {c['ok']} ok, {c['skipped']} skipped (documented), {c['fail']} failed")
    if c["fail"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
