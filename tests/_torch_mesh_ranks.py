"""The ranks' side of the port's mesh tests (`tests/test_torch_mesh.py`,
`tests/test_torch_mesh_paged.py`, and the serve and train cells' steps of
`tests/test_torch_tp.py` and `tests/test_torch_train_tp.py`, whose ranks
run in the mesh tests' spawns).

Each function runs in every rank of a gloo mesh started by
`repro_torch.launch.mesh.spawn` and returns numpy results, which the test
holds against the JAX reference's local executor in the parent.  This
module imports the port only (each rank imports it by name), so the ranks
start without JAX.  The weights arrive as an ``.npz`` of the reference's
tree (`save_params`), every rank loads the whole tree and its engine keeps
its slots' share.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

import repro_torch.api as PORT
from repro_torch import interop
from repro_torch.api import Engine, synthesize_requests
from repro_torch.serving.request import Request

ARCH = "minitron-8b"
B, T, GEN = 4, 20, 4  # one-shot parity (the reference's tests/test_executor.py)
SB, ST, SGEN = 4, 20, 8  # speculative parity (tests/test_speculative.py)


# ---- weights through an .npz ------------------------------------------------


def save_params(path, tree) -> None:
    """A numpy tree of dicts and lists as one ``.npz`` (keys are paths)."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}{k}.", v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}{i}.", v)
        else:
            flat[prefix[:-1]] = np.asarray(node)

    walk("", tree)
    np.savez(path, **flat)


def load_params(path) -> dict:
    """`save_params`'s tree as the port's tensors (on the CPU)."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            parts = key.split(".")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]

    def fix(node):  # dicts keyed 0..n-1 were lists
        if isinstance(node, dict):
            node = {k: fix(v) for k, v in node.items()}
            if node and all(k.isdigit() for k in node):
                return [node[str(i)] for i in range(len(node))]
        return node

    return interop.to_torch(fix(tree), "cpu")


# ---- configurations, the same for both packages ----------------------------


def oneshot_cfg(pkg, backend, n_shards, skew, seed, executor="local"):
    """tests/test_executor.py's ``cfg_for``; ``pkg`` is ``repro.api`` (the
    reference) or ``repro_torch.api`` (the port, on the CPU)."""
    kw = {} if pkg.__name__.startswith("repro.") else {"device": "cpu"}
    return pkg.EngineConfig.smoke(
        ARCH, n_shards=n_shards, max_seq_len=T + GEN + 8,
        compression=pkg.CompressionConfig(policy="ada_snapkv", budget=16, alpha_max=2.0,
                                          obs_window=8, sink=2, decode_margin=8),
        planner=pkg.PlannerConfig(mode="fairkv_dp", extra_copies=4, batch_cap=4),
        scheduler=pkg.SchedulerConfig(max_rows=4, enable_replan=False),
        cache_backend=backend, paging=pkg.PagingConfig(block_size=8),
        executor=executor, profile_skew=skew, profile_seed=seed, **kw)


def spec_cfg(pkg, executor="local"):
    """tests/test_speculative.py's mesh ``cfg_for``."""
    cap = ST + SGEN + 8
    kw = {} if pkg.__name__.startswith("repro.") else {"device": "cpu"}
    return pkg.EngineConfig.smoke(
        ARCH, n_shards=4, max_seq_len=cap,
        compression=pkg.CompressionConfig(policy="none", budget=64, capacity=cap,
                                          alpha_max=1.0, obs_window=8, sink=2,
                                          decode_margin=8),
        planner=pkg.PlannerConfig(mode="fairkv_dp", extra_copies=6, batch_cap=SB),
        scheduler=pkg.SchedulerConfig(max_rows=SB, enable_replan=False),
        cache_backend="paged", paging=pkg.PagingConfig(block_size=8),
        executor=executor, **kw)


def chunk_cfg(pkg, executor="local", chunk=16):
    """tests/test_prefix.py's mesh ``cfg_for``."""
    kw = {} if pkg.__name__.startswith("repro.") else {"device": "cpu"}
    return pkg.EngineConfig.smoke(
        ARCH, n_shards=4, max_seq_len=128,
        compression=pkg.CompressionConfig(policy="none", budget=96, capacity=96,
                                          decode_margin=8, obs_window=8),
        planner=pkg.PlannerConfig(mode="fairkv_dp", extra_copies=4, batch_cap=4),
        scheduler=pkg.SchedulerConfig(max_rows=4, enable_replan=False),
        cache_backend="paged", paging=pkg.PagingConfig(block_size=16),
        executor=executor, prefix=pkg.PrefixConfig(enabled=False, chunk_tokens=chunk), **kw)


def chunk_reqs(request_cls, vocab):
    """tests/test_prefix.py's ``reqs_for``: prompts over and under a chunk."""
    rng = np.random.default_rng(9)
    shared = rng.integers(1, vocab, size=32).astype(np.int32)
    out = []
    for i, (t, a) in enumerate([(52, 0), (14, 1), (37, 3), (64, 5)]):
        if t > 32:
            prompt = np.concatenate([shared, rng.integers(1, vocab, size=t - 32).astype(np.int32)])
        else:
            prompt = rng.integers(1, vocab, size=t).astype(np.int32)
        out.append(request_cls(req_id=i, prompt=prompt, arrival_step=a, max_new_tokens=5))
    return out


def trace_reqs(synth):
    """tests/test_executor.py's continuous trace."""
    return synth(5, 0.6, 256, min_prompt=10, max_prompt=18, max_new_tokens=4, seed=2)


# ---- rank functions ---------------------------------------------------------


def _ptrs(eng) -> list:
    return [t.data_ptr() for pl in eng.sp["layers"] for t in pl.values()] + [
        eng.pa.slot_head.data_ptr()]


def oneshot_rank(mesh, wpath, cases, profiles):
    """One-shot `generate` per case (backend, n_shards, skew, seed), then a
    replan under ``profiles[i]`` and a second generate; the decode step's
    collectives in between."""
    params = load_params(wpath)
    out = []
    for (backend, n_shards, skew, seed), prof in zip(cases, profiles):
        eng = Engine.build(oneshot_cfg(PORT, backend, n_shards, skew, seed, "mesh"),
                           mesh=mesh, params=params)
        prompts = np.random.default_rng(seed).integers(0, 256, (B, T))
        res = eng.generate(prompts, GEN)
        rec = {"tokens": res.tokens, "logits": res.logits, "lengths": res.lengths,
               "state_lengths": eng.state_lengths(),
               "replicas": any(int(lp.replica_count.max()) > 1 for lp in eng.plan.layers)}
        idle = torch.zeros((B,), dtype=torch.bool)  # no appends: the audit changes nothing
        with torch.inference_mode():
            _, rec["collectives"] = eng.executor.decode_collectives(eng.sp, eng.state, eng.pa,
                                                                    active=idle)
        before = _ptrs(eng)
        eng.replan(profile=prof)
        res2 = eng.generate(prompts, GEN)
        rec.update(tokens2=res2.tokens, logits2=res2.logits,
                   state_lengths2=eng.state_lengths(), same_storage=_ptrs(eng) == before,
                   captures=dict(eng.executor.step_traces),
                   memory=eng.memory_stats())
        out.append(rec)
    return out


def family_cfg(pkg, arch, executor="local"):
    """`oneshot_cfg`'s slot setting for another dense arch (gemma2-9b,
    qwen1.5-110b)."""
    kw = {} if pkg.__name__.startswith("repro.") else {"device": "cpu"}
    return pkg.EngineConfig.smoke(
        arch, n_shards=2, max_seq_len=T + GEN + 8,
        compression=pkg.CompressionConfig(policy="ada_snapkv", budget=16, alpha_max=2.0,
                                          obs_window=8, sink=2, decode_margin=8),
        planner=pkg.PlannerConfig(mode="fairkv_dp", extra_copies=4, batch_cap=4),
        executor=executor, profile_skew=2.0, profile_seed=1, **kw)


def family_rank(mesh, wpath, arch):
    """One-shot `generate` of another dense arch on the mesh, and the decode
    step's collectives."""
    eng = Engine.build(family_cfg(PORT, arch, "mesh"), mesh=mesh, params=load_params(wpath))
    prompts = np.random.default_rng(1).integers(0, 256, (B, T))
    res = eng.generate(prompts, GEN)
    idle = torch.zeros((B,), dtype=torch.bool)
    with torch.inference_mode():
        _, coll = eng.executor.decode_collectives(eng.sp, eng.state, eng.pa, active=idle)
    return {"tokens": res.tokens, "logits": res.logits, "lengths": res.lengths,
            "collectives": coll}


def trace_rank(mesh, wpath, backend):
    """tests/test_executor.py's continuous trace on the mesh."""
    eng = Engine.build(oneshot_cfg(PORT, backend, 4, 2.0, 1, "mesh"), mesh=mesh,
                       params=load_params(wpath))
    out = eng.run_trace(trace_reqs(synthesize_requests), max_steps=300)
    pool = getattr(eng.scheduler.backend, "pool", None)
    return {"finished": out["finished"], "total": out["total"],
            "tokens": {r.req_id: list(r.generated) for r in eng.finished_requests},
            "blocks_in_use": None if pool is None else pool.blocks_in_use(),
            "partition_free": None if pool is None else pool.free_blocks_by_partition().sum(0)}


def _fresh(eng, prompts):
    eng.prefill(prompts)
    eng.state = eng.backend.from_prefill(eng.state, eng.pa)
    return eng.state


def _run_ref(eng, prompts):
    state = _fresh(eng, prompts)
    toks = []
    for _ in range(SGEN):
        state = eng.backend.prepare_decode(state, None)
        state, _ = eng.executor.decode(eng.sp, state, eng.pa, state.last_tokens)
        toks.append(state.last_tokens.cpu().numpy().copy())
    eng.state = state
    return np.stack(toks, 1)


def _run_spec(eng, prompts, draft_layers, max_k):
    """tests/test_speculative.py's ``run_spec``: propose, verify, trim."""
    cap = ST + SGEN + 8
    state = _fresh(eng, prompts)
    committed = [[] for _ in range(SB)]
    accepted = proposed = ticks = 0
    while min(len(c) for c in committed) < SGEN:
        lens = eng.backend.host_lengths(state)
        headroom = cap - lens.max(axis=(0, 1))
        depth = np.minimum(max_k, np.maximum(headroom - 1, 0)).astype(np.int32)
        if ticks % 2 == 1:
            depth = np.minimum(depth, np.maximum(1, max_k - 1))
        ticks += 1
        q_len = depth + 1
        state = eng.backend.prepare_decode(state, None, n_tokens=int(q_len.max()))
        st, props = eng.executor.propose(eng.sp, state, eng.pa, depth,
                                         draft_layers=draft_layers, max_k=max_k)
        tokens = np.concatenate([st.last_tokens.cpu().numpy()[:, None],
                                 props.cpu().numpy()], axis=1)
        st2, g, n_commit, _ = eng.executor.verify(eng.sp, st, eng.pa, tokens, q_len,
                                                  draft_layers=draft_layers)
        st2 = eng.backend.trim_rows(st2, np.arange(SB))
        g_np, nc = g.cpu().numpy(), n_commit.cpu().numpy()
        for b in range(SB):
            committed[b].extend(g_np[b, :nc[b]].tolist())
        proposed += int(depth.sum())
        accepted += int((nc - 1).sum())
        state = eng.state = st2
    eng.backend.pool.check_invariants()
    return np.stack([np.array(c[:SGEN]) for c in committed]), accepted / max(proposed, 1)


def spec_rank(mesh, wpath):
    """Sequential decode, then speculative full and partial drafts, then a
    replan and both again: tests/test_speculative.py's mesh case."""
    eng = Engine.build(spec_cfg(PORT, "mesh"), mesh=mesh, params=load_params(wpath))
    n_layers = eng.cfg.model.n_layers
    prompts = np.random.default_rng(0).integers(0, 256, (SB, ST))
    with torch.inference_mode():
        ref = _run_ref(eng, prompts)
        full, acc_f = _run_spec(eng, prompts, n_layers, 3)
        part, acc_p = _run_spec(eng, prompts, max(1, n_layers // 2), 3)
        eng.replan(profile=np.asarray(eng.profile).copy())
        ref2 = _run_ref(eng, prompts)
        again, _ = _run_spec(eng, prompts, n_layers, 3)
    return {"ref": ref, "full": full, "acc_full": acc_f, "partial": part,
            "acc_partial": acc_p, "ref_after_replan": ref2, "spec_after_replan": again}


def chunk_rank(mesh, wpath):
    """tests/test_prefix.py's mesh case: a chunked trace, twice."""
    eng = Engine.build(chunk_cfg(PORT, "mesh"), mesh=mesh, params=load_params(wpath))
    vocab = eng.cfg.model.vocab_size
    out = eng.run_trace(chunk_reqs(Request, vocab), max_steps=400)
    toks = {r.req_id: list(r.generated) for r in eng.scheduler.finished}
    chunks = len(eng.scheduler.chunk_s)
    eng.run_trace(chunk_reqs(Request, vocab), max_steps=400)
    return {"finished": out["finished"], "total": out["total"], "tokens": toks,
            "chunks": chunks, "prefix": eng.scheduler.prefix is None,
            "blocks_in_use": eng.scheduler.backend.pool.blocks_in_use()}


def oversubscribe_rank(mesh):
    """make_host_mesh over a one-rank group asked for two ranks."""
    from repro_torch.launch.mesh import make_host_mesh
    try:
        make_host_mesh(model=2, data=1)
    except ValueError as e:
        return str(e)
    return None


def compress_rank(mesh, grads, errs):
    """`compressed_all_reduce` of this rank's gradient tree (``grads`` and
    ``errs`` hold one numpy tree per rank of ``model``) over the model
    group: the summed tree and this rank's new error tree, as numpy."""
    from repro_torch.training.grad_compress import compressed_all_reduce

    r = mesh.model_idx
    summed, err = compressed_all_reduce(interop.to_torch(grads[r]), interop.to_torch(errs[r]),
                                        mesh.model_group)
    return interop.to_numpy(summed), interop.to_numpy(err)


def audit_rank(mesh):
    """The dry run's decode step (`repro_torch.launch.dryrun.run_step`:
    minitron-8b's smoke config at decode_32k, the mesh executor eager) on
    this gloo mesh's real tensors: its collectives by group."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun

    stats, _ = dryrun.run_step(get_smoke_config(ARCH), "decode_32k", mesh)
    return stats.by_group


# ---- the serve cells' step under serve_rules (tests/test_torch_tp.py) ------

TP_B, TP_T, TP_STEPS = 4, 20, 3  # a prefill of B x T, then TP_STEPS decode steps
TP_PLAN_SHARDS = 4  # one plan for both spawns: its 4 slots split over model 2 and 4
TP_COMP = dict(policy="ada_snapkv", budget=12, alpha_max=2.0, obs_window=8, sink=2,
               decode_margin=8)
# qwen1.5's smoke config widened so that the projections cross the int8
# threshold (2^16 elements); vocab 128 keeps the embedding plain and the run fp32
TP_WIDE = dict(d_model=256, d_ff=512, head_dim=64, vocab_size=128)


def tp_model(configs, arch, wide):
    """The smoke config of ``arch`` (widened by `TP_WIDE` when ``wide``) from
    a package's ``configs`` module."""
    cfg = configs.get_smoke_config(arch)
    return dataclasses.replace(cfg, **TP_WIDE) if wide else cfg


def tp_batch(cfg) -> dict:
    """The cells' prompt rows (numpy, seed 1): `TP_B` x `TP_T` tokens, and a
    VLM's image embeddings or an encoder-decoder's frames."""
    rng = np.random.default_rng(1)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (TP_B, TP_T))}
    if cfg.is_vlm:
        out["image_embeds"] = (0.5 * rng.standard_normal(
            (TP_B, cfg.num_image_tokens, cfg.d_model))).astype(np.float32)
    if cfg.is_encoder_decoder:
        out["frames"] = (0.5 * rng.standard_normal(
            (TP_B, cfg.encoder_seq_len, cfg.d_model))).astype(np.float32)
    return out


# the serve state's tensors beside the cache (the families that have them)
STATE_FIELDS = ("ssm_state", "conv_state", "cross_k", "cross_v")


def _np(t):
    return t.detach().cpu().numpy().copy()


def tp_rank(mesh, wpath, arch, wide, int8, weights_2d):
    """The serve cells' step (`repro_torch.launch.specs.serve_step`) under
    ``serve_rules(mesh, weights_2d=...)`` on this rank's shards
    (`local_shard` of the slotified, optionally int8, tree): a prefill and
    `TP_STEPS` decode steps.  Returns the rank's tokens, logits (its vocab
    columns), lengths, final cache corner and state shards (with their
    specs), the collectives of the prefill and of one decode step, and its
    slots and rows.  An attention-free model has no plan, no slots and no
    cache."""
    from repro_torch import configs
    from repro_torch.cache.slot_cache import PlanArrays
    from repro_torch.compression.base import CompressionConfig
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed import comm
    from repro_torch.distributed.param_specs import local_shard, tree_specs
    from repro_torch.distributed.sharding import serve_rules
    from repro_torch.launch import specs
    from repro_torch.serving import engine as E
    from repro_torch.serving.quant import QTensor, quantize_serve_params

    cfg = tp_model(configs, arch, wide)
    ccfg = CompressionConfig(**TP_COMP)
    plan = specs.cell_plan(cfg, TP_PLAN_SHARDS, batch_cap=TP_B)
    sp = E.slotify_params(load_params(wpath), plan, cfg)
    if int8:
        sp = quantize_serve_params(sp)
    rules = serve_rules(mesh, weights_2d=weights_2d)
    sp_spec = tree_specs(sp, rules, "serve")
    n_slots = 0 if plan is None else plan.n_slots
    pa = None
    if plan is not None:
        pa = PlanArrays.from_plan(plan)
        pa = {f.name: getattr(pa, f.name) for f in dataclasses.fields(pa)}
        pa = local_shard(pa, specs.plan_specs(plan, rules), mesh)
    batch = {k: torch.as_tensor(v) for k, v in tp_batch(cfg).items()}
    sp = local_shard(sp, sp_spec, mesh)
    batch = local_shard(batch, specs.batch_specs(batch, rules), mesh)
    step = {kind: specs.serve_step(kind, cfg, ccfg, mesh, rules, sp_spec, n_slots, TP_B)
            for kind in ("prefill", "decode")}
    _, st_spec = specs.serve_state_fake(cfg, InputShape("tp", TP_T, TP_B, "decode"), plan,
                                        ccfg, rules)
    sl, rows = mesh.slots(n_slots), mesh.rows(TP_B)
    with torch.inference_mode():
        before = comm.snapshot()
        state, logits, lengths = step["prefill"](sp, batch, pa)
        out = {"prefill_collectives": comm.by_kind(comm.since(before)),
               "tokens": [_np(state.last_tokens)], "logits": [_np(logits)],
               "lengths": _np(lengths), "slots": (sl.start, sl.stop),
               "rows": (rows.start, rows.stop), "model_idx": mesh.model_idx,
               "data_idx": mesh.data_idx,
               "int8": any(isinstance(w, QTensor) for w in sp["layers"][0].values())}
        for i in range(TP_STEPS):
            before = comm.snapshot()
            state, logits = step["decode"](sp, state, pa)
            if i == 0:
                out["collectives"] = comm.by_kind(comm.since(before))
            out["tokens"].append(_np(state.last_tokens))
            out["logits"].append(_np(logits))
    out["cache"] = None if state.cache is None else {
        f: _np(getattr(state.cache, f)) for f in ("k", "v", "lengths", "pos", "positions")}
    out["state"] = {f: (_np(getattr(state, f)), st_spec[f]) for f in STATE_FIELDS
                    if getattr(state, f) is not None}
    return out


# ---- long_500k's split-S decode step (tests/test_torch_tp.py) ------------

LONG_ARCH = "gemma2-9b"  # its smoke config: layer 0 local (window 16), layer 1 global
LONG_T, LONG_STEPS = 100, 32  # a prompt of 100 tokens, then 32 decode steps
# policy none at capacity 120 + margin 8 = 128 columns (64 a shard at data 2):
# lengths cross the shard boundary at prefill and reach capacity after 28
# steps, so the ring (the last 8 columns, on the last shard) wraps
LONG_COMP = dict(policy="none", budget=120, capacity=120, decode_margin=8)
# arch: (compression, prompt tokens, decode steps).  hymba's smoke cell holds
# one window of 16 + a ring of 8 (24 columns, 12 a shard at data 2): its
# prefill keeps the window's 16, past the shard boundary, and the ring wraps
# after 8 steps; mamba2 has no cache (nothing splits over data)
LONG_CELLS = {LONG_ARCH: (LONG_COMP, LONG_T, LONG_STEPS),
              "hymba-1.5b": (dict(policy="none", budget=16, capacity=16, decode_margin=8),
                             20, 14),
              "mamba2-1.3b": (dict(policy="none", budget=16, capacity=16, decode_margin=8),
                              20, 8)}
CACHE_FIELDS = ("k", "v", "lengths", "pos", "positions")


def long_rank(mesh, wpath, spath, arch=LONG_ARCH):
    """The long_500k cell's step (`specs.serve_step("decode")` under
    ``serve_rules(mesh, long_context=True)``: split-S over ``data`` where
    the model has a cache) of ``arch``'s smoke config (`LONG_CELLS`) on
    this rank's shards of the reference's prefilled state (``spath``, an
    .npz of its cache and recurrent state, last tokens and ring phase).
    Returns the tokens, logits (the rank's vocab columns), the final cache
    corner and state shards (with their specs), one step's collectives, and
    the rank's slots and columns."""
    from repro_torch import configs
    from repro_torch.cache.slot_cache import PlanArrays
    from repro_torch.compression.base import CompressionConfig
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed import comm
    from repro_torch.distributed.param_specs import local_shard, tree_specs
    from repro_torch.distributed.sharding import serve_rules
    from repro_torch.launch import specs
    from repro_torch.serving import engine as E

    comp, n_prompt, n_steps = LONG_CELLS[arch]
    cfg = configs.get_smoke_config(arch)
    ccfg = CompressionConfig(**comp)
    plan = specs.cell_plan(cfg, TP_PLAN_SHARDS, batch_cap=1)
    sp = E.slotify_params(load_params(wpath), plan, cfg)
    rules = serve_rules(mesh, long_context=True)
    sp_spec = tree_specs(sp, rules, "serve")
    n_slots, pa = 0, None
    if plan is not None:
        n_slots = plan.n_slots
        pa = PlanArrays.from_plan(plan)
        pa = local_shard({f.name: getattr(pa, f.name) for f in dataclasses.fields(pa)},
                         specs.plan_specs(plan, rules), mesh)
    with np.load(spath) as z:
        st = {k: torch.from_numpy(z[k]) for k in z.files}
    state = {"last_tokens": st["last_tokens"].long(), "decode_steps": st["decode_steps"],
             **{f: st[f] for f in STATE_FIELDS if f in st}}
    if "k" in st:
        state["cache"] = {f: st[f] for f in CACHE_FIELDS}
    _, st_spec = specs.serve_state_fake(cfg, InputShape("long", n_prompt, 1, "decode"), plan,
                                        ccfg, rules)
    sp = local_shard(sp, sp_spec, mesh)
    state = local_shard(state, st_spec, mesh)
    step = specs.serve_step("decode", cfg, ccfg, mesh, rules, sp_spec, n_slots, 1)
    n_cols = state["cache"]["k"].shape[3] if "cache" in state else 0
    sl = mesh.slots(n_slots)
    out = {"tokens": [], "logits": [], "slots": (sl.start, sl.stop),
           "cols": (mesh.data_idx * n_cols, (mesh.data_idx + 1) * n_cols),
           "model_idx": mesh.model_idx, "data_idx": mesh.data_idx}
    with torch.inference_mode():
        for i in range(n_steps):
            before = comm.snapshot()
            state, logits = step(sp, state, pa)
            if i == 0:
                out["collectives"] = comm.by_kind(comm.since(before))
            out["tokens"].append(_np(state.last_tokens))
            out["logits"].append(_np(logits))
    out["cache"] = None if state.cache is None else {
        f: _np(getattr(state.cache, f)) for f in CACHE_FIELDS}
    out["state"] = {f: (_np(getattr(state, f)), st_spec[f]) for f in STATE_FIELDS
                    if getattr(state, f) is not None}
    return out


# ---- the expert-parallel MoE block (tests/test_torch_tp.py) ----------------

# qwen3-moe's smoke width with 8 experts, top-2, at a capacity factor that
# drops replicas: 48 tokens (8 rows x 6) give Ce = 12 a expert
MOE_EP = dict(num_experts=8, top_k=2, d_expert=32, capacity_factor=1.0)
MOE_ROWS, MOE_SEQ = 8, 6


def moe_rank(mesh, arrays):
    """`moe_block` on this rank's shards under ``serve_rules(mesh)``: its
    rows of ``arrays["h"]`` (B over ``data``) and its experts (over
    ``model``), the router's columns gathered.  Returns its output rows,
    the aux loss and its rows."""
    from repro_torch import configs
    from repro_torch.configs.base import MoEConfig
    from repro_torch.distributed.param_specs import local_shard, tree_specs
    from repro_torch.distributed.sharding import serve_rules, step_shards
    from repro_torch.models.moe import moe_block

    cfg = dataclasses.replace(configs.get_smoke_config("qwen3-moe-30b-a3b"),
                              moe=MoEConfig(**MOE_EP))
    rules = serve_rules(mesh)
    pl = {k: torch.from_numpy(arrays[k]) for k in ("router", "we1", "we3", "we2")}
    pl = local_shard(pl, tree_specs(pl, rules, "serve"), mesh)
    h = local_shard({"h": torch.from_numpy(arrays["h"])},
                    {"h": (rules.guarded(MOE_ROWS, "batch"), None, None)}, mesh)["h"]
    shards = step_shards(rules, mesh, vocab=cfg.padded_vocab, ff=cfg.d_ff, d_model=cfg.d_model,
                         n_slots=mesh.model, batch=MOE_ROWS, experts=MOE_EP["num_experts"])
    with torch.inference_mode():
        out, aux = moe_block(pl, h, cfg, shards)
    rows = mesh.rows(MOE_ROWS)
    return {"out": _np(out), "aux": float(aux), "rows": (rows.start, rows.stop)}


def argmax_rank(mesh):
    """`vocab_argmax` over this rank's columns of fixed logits (16 columns,
    the last two padded): returns (its picks, the plain argmax over the
    whole real vocab)."""
    from repro_torch.distributed.sharding import Split
    from repro_torch.serving.engine import vocab_argmax

    g = mesh.model_group
    V, vocab = 16, 14
    n = V // g.size
    full = np.random.default_rng(3).standard_normal((4, V)).astype(np.float32)
    full[0] = 0.0
    full[0, 3] = full[0, n + 1] = 5.0  # a tie across the shards: the lower id wins
    full[1, n + 2] = full[1, n + 5] = 9.0  # a tie inside the last shard
    full[2, V - 1] = 100.0  # the largest logit in a padded column: never picked
    full[3] = 1.0  # every column tied: id 0
    got = vocab_argmax(torch.from_numpy(full[:, g.rank * n:(g.rank + 1) * n]), vocab,
                       Split(g, g.rank, g.size))
    return _np(got), np.argmax(full[:, :vocab], axis=-1)


# ---- the train cells' step under train_rules (tests/test_torch_train_tp.py)

# lr 1e-3: at 1e-2 Adam's first update lr·g/(|g| + eps) turns the fp32
# rounding of a gradient near eps into parameter steps past the 1e-4 bar,
# whatever the order of the sums (the single-process step misses it against
# the reference at 1e-2 too, `tests/test_torch_train_tp.py`)
TRAIN_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=3)
TRAIN_STEPS = 3


def train_batches(cfg, B, T) -> list:
    """The `SyntheticLM` batches (numpy) of the train cases' steps."""
    from repro_torch.configs.base import InputShape
    from repro_torch.training.data import SyntheticLM

    data = SyntheticLM(cfg, InputShape("test", T, B, "train"))
    return [data.get_batch(s) for s in range(TRAIN_STEPS)]


def train_cfg(configs, arch, layers):
    """``arch``'s smoke config from a package's ``configs`` module, cut to
    ``layers`` layers when given."""
    cfg = configs.get_smoke_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg, n_layers=layers)


def train_rank(mesh, wpath, arch, B, T, layers=None, layout=None):
    """The train cell's step (`repro_torch.launch.specs.train_step`) under
    ``train_rules`` on this rank's shards of the reference's fp32 tree
    (``wpath``): `TRAIN_STEPS` steps over its rows of `train_batches` (``T``
    the positions a row: a VLM's image prefix and text).
    ``layout`` (model, data, pods): run on a second mesh of that layout
    over the spawn's ranks (every rank makes it).  Returns each step's
    metrics, the final param and optimizer state shards (numpy) with the
    params' specs, the first step's collectives, and the rank's index in
    each axis."""
    from repro_torch import configs
    from repro_torch.distributed import comm
    from repro_torch.distributed.param_specs import local_shard, tree_specs
    from repro_torch.distributed.sharding import train_rules
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.training.optimizer import OptimizerConfig, init_optimizer

    if layout is not None:
        model, data, pods = layout
        mesh = make_host_mesh(model=model, data=data, pods=pods)
    cfg = train_cfg(configs, arch, layers)
    rules = train_rules(mesh)
    whole = load_params(wpath)
    spec = tree_specs(whole, rules, "train")
    params = local_shard(whole, spec, mesh)
    opt = init_optimizer(params)
    step = specs.train_step(cfg, mesh, rules, spec, B, T, OptimizerConfig(**TRAIN_OPT))
    out = {"metrics": [], "spec": spec, "model_idx": mesh.model_idx,
           "fsdp_idx": mesh.fsdp_group.rank, "data_idx": mesh.data_idx}
    for i, b in enumerate(train_batches(cfg, B, T)):
        # the rank's rows of the tokens and of the stub frontends' inputs
        rows = {k: (rules.guarded(B, "batch"),) + (None,) * (v.ndim - 1) for k, v in b.items()}
        batch = local_shard({k: torch.as_tensor(v) for k, v in b.items()}, rows, mesh)
        before = comm.snapshot()
        params, opt, met = step(params, opt, batch)
        if i == 0:
            out["collectives"] = comm.by_kind(comm.since(before))
        out["metrics"].append({k: float(v) for k, v in met.items()})
    out["params"] = interop.to_numpy(params)
    out["opt"] = {k: interop.to_numpy(getattr(opt, k)) for k in ("master", "mu", "nu")}
    out["opt_step"] = int(opt.step)
    return out


def jobs_rank(mesh, jobs):
    """Several of this module's rank functions in one spawn (a spawn of
    eight ranks costs seconds): ``jobs`` is a list of (name, args)."""
    return [globals()[name](mesh, *args) for name, args in jobs]


def card_rank(mesh, backend):
    """On the card: the local executor (graphed) and this mesh's executor
    on the same seed weights, one-shot; returns both runs' tokens and
    logits, the mesh's captures and replays, and one decode step's
    collectives (they count per replay)."""
    cfg = PORT.EngineConfig.smoke(
        ARCH, device="cuda", n_shards=4, max_seq_len=64, cache_backend=backend,
        planner=PORT.PlannerConfig(mode="fairkv_dp", extra_copies=4, batch_cap=4),
        paging=PORT.PagingConfig(block_size=8))
    loc = Engine.build(cfg)
    msh = Engine.build(cfg.replace(executor="mesh"), mesh=mesh, params=loc.params)
    prompts = np.random.default_rng(0).integers(0, 256, (4, 24))
    a, b = loc.generate(prompts, 6), msh.generate(prompts, 6)
    with torch.inference_mode():
        _, coll = msh.executor.decode_collectives(msh.sp, msh.state, msh.pa)
    return {"local": (a.tokens, a.logits), "mesh": (b.tokens, b.logits),
            "captures": dict(msh.executor.step_traces), "replays": dict(msh.executor.replays),
            "graphs": msh.executor.graphs, "collectives": coll,
            "n_layers": cfg.model.n_layers}
