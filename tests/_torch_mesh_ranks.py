"""The ranks' side of the port's mesh tests (`tests/test_torch_mesh.py`,
`tests/test_torch_mesh_paged.py`).

Each function runs in every rank of a gloo mesh started by
`repro_torch.launch.mesh.spawn` and returns numpy results, which the test
holds against the JAX reference's local executor in the parent.  This
module imports the port only (each rank imports it by name), so the ranks
start without JAX.  The weights arrive as an ``.npz`` of the reference's
tree (`save_params`), every rank loads the whole tree and its engine keeps
its slots' share.
"""
from __future__ import annotations

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
