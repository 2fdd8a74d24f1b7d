"""The port's chunked prefill and prefix index against the JAX package, on
the CPU.

minitron-8b smoke in fp32, weights carried across with
`repro_torch.interop`.  Covered here:

- the prefix index (`repro_torch.prefix.PrefixIndex`): chain keys
  byte-equal to the reference's, and the reference's unit cases (strict
  longest match, LRU order, incref on register / decref on eviction, pins,
  flush) run on both packages' index and pool with equal results,
  counters and refcounts;
- `prefill_chunk` on the same seeded inputs through both packages: logits
  within 1e-5, retained lengths and entry positions equal, K/V entries
  within 1e-5 (the projections' fp32 summation order differs);
- the single-device engine cases of the reference's `tests/test_prefix.py`
  (chunked ≡ monolithic, TTFT across chunks, sharing parity with observed
  refcounts, the property test), each driven tick by tick next to the JAX
  engine: per tick the same retained lengths, refcounts, block-table
  mirror, active and prefilling rows and index counters; at the end the
  same tokens (logits within 1e-4) and hit stamps.

Copy-on-write, admission and materialization cases are in
`tests/test_torch_prefix_cow.py`.
"""
import jax
import numpy as np
import pytest
import torch

from repro.api import CompressionConfig as JCompression
from repro.api import Engine as JEngine
from repro.api import EngineConfig as JEngineConfig
from repro.api import PagingConfig as JPaging
from repro.api import PlannerConfig as JPlanner
from repro.api import PrefixConfig as JPrefix
from repro.api import SchedulerConfig as JScheduler
from repro.api import synthesize_requests as jsynth
from repro.paging.block_pool import BlockPool as JBlockPool
from repro.prefix import PrefixIndex as JPrefixIndex
from repro.serving.request import Request as JRequest
from repro_torch import interop
from repro_torch.api import (CompressionConfig, Engine, EngineConfig, PagingConfig,
                             PlannerConfig, PrefixConfig, Request, SchedulerConfig,
                             synthesize_requests)
from repro_torch.kernels import build
from repro_torch.paging.block_pool import BlockPool
from repro_torch.prefix import PrefixIndex
from tests._hypothesis_compat import given, settings, st

torch.set_num_threads(2)

ARCH = "minitron-8b"
BS = 16  # block size of every engine-level case
TOL = 1e-4  # logits through a whole trace (fp32, summation order)


def configs(enabled=False, chunk=0, budget=128, margin=8, n_blocks=256, rows=3,
            max_seq=256, entries=256, kv="fp32", backend="paged", policy="none",
            **sched_kw):
    """(JAX config, port config): the reference's `tests/test_prefix.py`
    `_cfg`, the same in both packages."""
    sk = dict(max_rows=rows, enable_replan=False, collect_logits=True)
    sk.update(sched_kw)
    comp = dict(policy=policy, budget=budget, capacity=budget, decode_margin=margin,
                obs_window=8)
    j = JEngineConfig.smoke(
        ARCH, max_seq_len=max_seq, compression=JCompression(**comp),
        planner=JPlanner(batch_cap=rows), scheduler=JScheduler(**sk),
        cache_backend=backend, paging=JPaging(block_size=BS, n_blocks=n_blocks, kv_dtype=kv),
        prefix=JPrefix(enabled=enabled, chunk_tokens=chunk, max_entries=entries))
    t = EngineConfig.smoke(
        ARCH, device="cpu", max_seq_len=max_seq, compression=CompressionConfig(**comp),
        planner=PlannerConfig(batch_cap=rows), scheduler=SchedulerConfig(**sk),
        cache_backend=backend, paging=PagingConfig(block_size=BS, n_blocks=n_blocks, kv_dtype=kv),
        prefix=PrefixConfig(enabled=enabled, chunk_tokens=chunk, max_entries=entries))
    return j, t


_PARAMS: dict = {}


def shared_params():
    """One weight set for every engine of the module (a plain memo, so the
    hypothesis shim's runner, which takes no fixtures, reaches it too)."""
    if not _PARAMS:
        jparams = JEngine.build(configs()[0]).params
        _PARAMS["p"] = (jparams, interop.to_torch(jax.tree.map(np.asarray, jparams)))
    return _PARAMS["p"]


@pytest.fixture(scope="module")
def params():
    return shared_params()


def requests(specs, jax_side):
    """Fresh `Request`s of either package from (id, prompt, arrival, gen)."""
    cls = JRequest if jax_side else Request
    return [cls(req_id=i, prompt=np.asarray(p, np.int32).copy(), arrival_step=a,
                max_new_tokens=g) for i, p, a, g in specs]


def shared_specs(vocab, shared_len=48, n_shared=3, suffix=20, gen=6, spacing=8, seed=0):
    """The reference's `_shared_reqs`: ``n_shared`` requests sharing a
    ``shared_len`` prefix, spaced so the donor registers before the next
    arrival, plus one fully random request."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, vocab, size=shared_len).astype(np.int32)
    out = []
    for i in range(n_shared):
        sfx = rng.integers(1, vocab, size=suffix).astype(np.int32)
        out.append((i, np.concatenate([shared, sfx]), i * spacing, gen))
    out.append((n_shared, rng.integers(1, vocab, size=40).astype(np.int32), 1, gen))
    return out


def _snapshot(sched, jax_side):
    """What must match tick by tick: retained lengths, refcounts, the table
    mirror, active / prefilling rows, index counters, CoW count."""
    lengths = sched.state.cache.lengths
    lengths = np.asarray(lengths) if jax_side else lengths.cpu().numpy()
    b = sched.backend
    paged = getattr(b, "pool", None) is not None
    return dict(step=sched.step_idx, lengths=lengths.copy(),
                refcount=b.pool.refcount.copy() if paged else None,
                table=b.table.copy() if paged else None,
                active=sorted(sched.active), prefilling=sorted(sched.prefilling),
                prefix=sched.prefix_stats(), cow=getattr(b, "cow_copies", 0),
                queue=[r.req_id for r in sched.queue])


def drive(eng, reqs, jax_side, max_steps=400, stop=None):
    """`Scheduler.run`'s loop (submit at arrival, one tick each), keeping a
    snapshot per tick.  ``stop(sched)`` ends the run early when true; a
    later call resumes it (submitted requests carry an arrival time)."""
    sched = eng._ensure_scheduler()
    pending = sorted(reqs, key=lambda r: (r.arrival_step, r.req_id))
    i, snaps = 0, []
    while len(sched.finished) < len(pending) and sched.step_idx < max_steps:
        while i < len(pending) and pending[i].arrival_step <= sched.step_idx:
            if pending[i].arrival_time is None:
                sched.submit(pending[i])
            i += 1
        sched.step()
        snaps.append(_snapshot(sched, jax_side))
        if stop is not None and stop(sched):
            break
    return snaps


def run_pair(jc, tc, specs, params, max_steps=400):
    """The same trace through both packages' engines, tick by tick."""
    jparams, tparams = params
    je, te = JEngine.build(jc, params=jparams), Engine.build(tc, params=tparams)
    jr, tr = requests(specs, True), requests(specs, False)
    js, ts = drive(je, jr, True, max_steps), drive(te, tr, False, max_steps)
    return dict(je=je, te=te, jr=jr, tr=tr, js=js, ts=ts)


def assert_same_run(run):
    """Per tick: the same lengths, refcounts, table mirror, rows, index
    counters and CoW count; at the end the same tokens, logits within TOL,
    hit stamps and preemptions, and every request finished."""
    js, ts = run["js"], run["ts"]
    assert len(js) == len(ts)
    for a, b in zip(js, ts):
        for key in ("step", "active", "prefilling", "prefix", "cow", "queue"):
            assert a[key] == b[key], (a["step"], key, a[key], b[key])
        assert np.array_equal(a["lengths"], b["lengths"]), a["step"]
        if a["refcount"] is not None:
            assert np.array_equal(a["refcount"], b["refcount"]), a["step"]
            assert np.array_equal(a["table"], b["table"]), a["step"]
    assert all(r.is_finished for r in run["tr"])
    for a, b in zip(run["jr"], run["tr"]):
        assert a.generated == b.generated, a.req_id
        assert a.prefix_hit_tokens == b.prefix_hit_tokens, a.req_id
        assert a.n_preemptions == b.n_preemptions
        assert a.first_token_step == b.first_token_step
        sa, sb = a.prefix_shared_blocks, b.prefix_shared_blocks
        assert (sa is None) == (sb is None) and (sa is None or np.array_equal(sa, sb))
        for la, lb in zip(a.logits, b.logits):
            assert np.abs(np.asarray(la) - lb).max() < TOL


def tokens(reqs):
    return {r.req_id: list(r.generated) for r in reqs}


# ---------------------------------------------------------------------------
# the prefix index
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk,n", [(4, 16), (4, 11), (16, 100), (7, 50)])
def test_chain_keys_match_reference(chunk, n):
    """Byte-equal sha256 chain keys at every full boundary."""
    prompt = np.random.default_rng(n).integers(0, 50000, size=n).astype(np.int32)
    got = PrefixIndex(chunk_tokens=chunk).chain_keys(prompt)
    assert got == JPrefixIndex(chunk_tokens=chunk).chain_keys(prompt)
    assert [t for t, _ in got] == [chunk * (j + 1) for j in range(n // chunk)]


def test_chain_keys_commit_to_every_prior_token():
    idx = PrefixIndex(chunk_tokens=4)
    a = np.arange(16, dtype=np.int32)
    b = a.copy()
    b[9] = 99  # diverge inside chunk 2
    ka, kb = dict(idx.chain_keys(a)), dict(idx.chain_keys(b))
    assert sorted(ka) == sorted(kb) == [4, 8, 12, 16]
    assert ka[4] == kb[4] and ka[8] == kb[8]
    assert ka[12] != kb[12] and ka[16] != kb[16]  # the chain: divergence sticks
    assert dict(PrefixIndex(chunk_tokens=4).chain_keys(a)) == ka
    assert [t for t, _ in idx.chain_keys(a[:11])] == [4, 8]


def _register(idx, pool, prompt, tokens_, blocks_per_layer=2):
    """Register boundary ``tokens_`` of ``prompt`` with fresh blocks (the
    reference's `_register_boundary`)."""
    key = dict(idx.chain_keys(prompt))[tokens_]
    L, H, M = pool.n_layers, 2, 4
    table = np.zeros((L, H, M), np.int32)
    lengths = np.zeros((L, H), np.int32)
    for layer in range(L):
        ids = pool.alloc(layer, blocks_per_layer * H)
        table[layer, :, :blocks_per_layer] = np.asarray(ids).reshape(H, blocks_per_layer)
        lengths[layer, :] = blocks_per_layer * idx.chunk_tokens
    assert idx.register(key, tokens_, table, lengths)
    return idx._entries[key]


def _lookup_case(Index, Pool):
    pool, idx = Pool(2, 64), Index(chunk_tokens=4)
    idx.pool = pool
    prompt = np.arange(20, dtype=np.int32)
    e4, e8 = _register(idx, pool, prompt, 4), _register(idx, pool, prompt, 8)
    log = [idx.lookup(prompt) is e8, idx.lookup(prompt[:8]) is e4,
           idx.lookup(prompt[:4]) is None, idx.lookup(prompt[::-1].copy()) is None,
           idx.stats()]
    log += [idx.lookup(prompt) is e8, idx.evict_lru(), e8.key in idx._entries, len(idx),
            idx.lookup(prompt) is e8, idx.stats(), pool.refcount.copy()]
    return log


def _refcount_case(Index, Pool):
    pool, idx = Pool(2, 64), Index(chunk_tokens=4)
    idx.pool = pool
    entry = _register(idx, pool, np.arange(12, dtype=np.int32), 8)
    log = [entry.block_count(), pool.refcount.copy(),
           idx.register(entry.key, 8, entry.table, entry.lengths), pool.refcount.copy()]
    for layer in range(2):  # the donor retires: drop the alloc-time references
        pool.decref(layer, entry.table[layer][entry.table[layer] > 0].tolist())
    log += [idx.evict_lru(), pool.blocks_in_use(), pool.refcount.copy(), idx.stats()]
    pool.check_invariants()
    return log


def _pin_case(Index, Pool):
    pool, idx = Pool(1, 64), Index(chunk_tokens=4, max_entries=2)
    idx.pool = pool
    prompt = np.arange(24, dtype=np.int32)
    e1 = _register(idx, pool, prompt, 4)
    idx.pin(e1)
    log = [idx.evict_lru()]
    _register(idx, pool, prompt, 8)
    _register(idx, pool, prompt, 12)  # over max_entries: the LRU unpinned goes
    log += [len(idx), e1.key in idx._entries, idx.stats()]
    with pytest.raises(RuntimeError):
        idx.flush()  # a pinned entry is still live
    idx.unpin(e1)
    with pytest.raises(ValueError):
        idx.unpin(e1)
    idx.flush()
    log += [len(idx), pool.refcount.copy(), idx.stats()]
    pool.check_invariants()
    return log


def _same_log(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.array_equal(x, y) if isinstance(x, np.ndarray) else x == y


@pytest.mark.parametrize("case", [_lookup_case, _refcount_case, _pin_case],
                         ids=["lookup_longest_strict", "register_incref_evict_decref",
                              "pins_lru_flush"])
def test_index_matches_reference(case):
    """The reference's index unit cases on both packages: the same answers,
    counters and pool refcounts step by step."""
    got = case(PrefixIndex, BlockPool)
    _same_log(got, case(JPrefixIndex, JBlockPool))
    if case is _lookup_case:  # the reference's own expectations
        assert got[:4] == [True, True, True, True]
        assert got[4]["hits"] == 2 and got[4]["misses"] == 2
        assert got[5:10] == [True, True, True, 1, True]
    if case is _refcount_case:
        assert got[0] == 8 and (got[1][got[1] > 1] == 2).all()
        assert got[2] is False and got[4] is True and got[5] == 0
    if case is _pin_case:
        assert got[:3] == [False, 2, True] and got[3]["evictions"] == 1
        assert got[4] == 0


def test_prefix_config_validation():
    with pytest.raises(ValueError):
        PrefixConfig(enabled=True, chunk_tokens=0)  # sharing needs chunking
    with pytest.raises(ValueError):
        PrefixConfig(chunk_tokens=-1)
    with pytest.raises(ValueError):
        PrefixConfig(max_entries=0)
    with pytest.raises(ValueError, match="requires cache_backend='paged'"):
        configs(enabled=True, chunk=16)[1].replace(cache_backend="slot")
    with pytest.raises(TypeError):
        configs()[1].replace(prefix={"enabled": True})


def test_request_templates_match_reference():
    """Shared-prefix traces draw the reference's requests from one seed."""
    kw = dict(min_prompt=36, max_prompt=56, max_new_tokens=5, seed=4,
              prefix_templates=2, prefix_len=32, shared_fraction=0.6)
    j, t = jsynth(12, 0.4, 256, **kw), synthesize_requests(12, 0.4, 256, **kw)
    assert [r.arrival_step for r in j] == [r.arrival_step for r in t]
    assert all(np.array_equal(a.prompt, b.prompt) for a, b in zip(j, t))
    assert sum(np.array_equal(r.prompt[:32], t[0].prompt[:32]) for r in t) > 1
    with pytest.raises(ValueError, match="unique suffix"):
        synthesize_requests(2, 0.4, 256, min_prompt=16, prefix_templates=1, prefix_len=16)


# ---------------------------------------------------------------------------
# prefill_chunk on the same inputs through both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["none", "snapkv", "ada_snapkv", "streaming_llm", "pyramidkv",
                                    "h2o", "headkv"])
def test_prefill_chunk_matches_reference(params, policy):
    """Three chunks of a 40-token prompt (16, 16, then 8 valid of 16) into
    row 3 of a replicated plan (4 shards, fairkv_dp with 4 extra copies):
    after every chunk the logits agree within 1e-5, the retained lengths
    and entry positions are equal, and the K/V entries agree within 1e-5."""
    import jax.numpy as jnp
    from repro.compression.policies import layer_keep_bound
    from repro.serving import engine as jserve
    from repro_torch.serving import engine as tserve
    comp = dict(policy=policy, budget=6, alpha_max=2.0, obs_window=8, sink=2, pool=3,
                decode_margin=8)
    plan = dict(mode="fairkv_dp", extra_copies=4, batch_cap=4)
    jc = JEngineConfig.smoke(ARCH, n_shards=4, compression=JCompression(**comp),
                             planner=JPlanner(**plan))
    tc = EngineConfig.smoke(ARCH, n_shards=4, device="cpu",
                            compression=CompressionConfig(**comp), planner=PlannerConfig(**plan))
    je, te = JEngine.build(jc, params=params[0]), Engine.build(tc, params=params[1])
    m, ccfg = jc.model, jc.compression
    assert (te.plan.as_arrays()["slot_head"] >= 0).sum() > m.n_layers * m.n_kv_heads
    prompt = np.random.default_rng(11).integers(1, m.vocab_size, size=40)
    Ck, row, T = 16, 3, 40
    jst = jserve.init_serve_state(m, je.pa, 1, ccfg, dtype=jnp.float32)
    tst = tserve.init_serve_state(m, te.pa, 1, tc.compression, dtype=torch.float32)
    H, L = m.n_kv_heads, m.n_layers
    for start in range(0, T, Ck):
        n = min(Ck, T - start)
        chunk = np.zeros((1, Ck), np.int32)
        chunk[0, :n] = prompt[start:start + n]
        full = np.asarray([layer_keep_bound(policy, ccfg, T, H, layer, L) // H
                           for layer in range(L)])
        quota = np.maximum(1, np.ceil(full * n / T)).astype(np.int32)
        jst, jlog, jlen = jserve.prefill_chunk(
            je.sp, jnp.asarray(chunk), m, je.pa, ccfg, jst, jnp.asarray([row]),
            jnp.asarray([start]), jnp.asarray([n]), jnp.asarray(quota))
        with torch.inference_mode():
            tst, tlog, tlen = te.executor.prefill_chunk(te.sp, chunk, te.pa, tst, [row],
                                                        [start], [n], quota)
        assert np.abs(np.asarray(jlog) - tlog.numpy()).max() < 1e-5
        assert np.array_equal(np.asarray(jlen), tlen.numpy())
        jcache, tcache = jst.cache, tst.cache
        lens = tcache.lengths.numpy()
        assert np.array_equal(np.asarray(jcache.lengths), lens)
        assert np.array_equal(np.asarray(jcache.pos), tcache.pos.numpy())
        assert np.array_equal(np.asarray(jcache.positions), tcache.positions.numpy())
        assert int(tst.last_tokens[0]) == int(np.asarray(jst.last_tokens)[0])
        for a, b in ((jcache.k, tcache.k), (jcache.v, tcache.v)):
            assert np.abs(np.asarray(a) - b.numpy()).max() < 1e-5
    assert lens.sum() > 0 and tcache.pos.max() >= 32  # absolute positions


def test_prefill_chunk_refuses_non_dense():
    import dataclasses
    from repro_torch.serving.engine import prefill_chunk
    cfg = configs()[1].model
    for bad in ("ssm", "hybrid", "moe"):
        with pytest.raises(ValueError, match="dense attention"):
            prefill_chunk({}, torch.zeros((1, 4), dtype=torch.int64),
                          dataclasses.replace(cfg, family=bad), None, None, None, [0], [0],
                          [4], [1])


# ---------------------------------------------------------------------------
# chunked prefill through the scheduler
# ---------------------------------------------------------------------------


def test_chunked_matches_monolithic_local(params):
    """Chunked prefill (sharing off) next to the JAX engine, tick by tick;
    and against the port's monolithic prefill: the same tokens, logits
    within 1e-4, including a prompt shorter than one chunk."""
    jc, tc = configs(chunk=16)
    vocab = tc.model.vocab_size
    rng = np.random.default_rng(3)
    specs = [(i, rng.integers(1, vocab, size=t), a, 5)
             for i, (t, a) in enumerate([(50, 0), (12, 1), (33, 2), (64, 4)])]
    run = run_pair(jc, tc, specs, params)
    assert_same_run(run)
    assert any(s["prefilling"] for s in run["ts"])
    mono = Engine.build(configs()[1], params=params[1])
    mr = requests(specs, False)
    mono.run_trace(mr, max_steps=400)
    assert tokens(mr) == tokens(run["tr"])
    for a, b in zip(mr, run["tr"]):
        for la, lb in zip(a.logits, b.logits):
            assert np.abs(la - lb).max() < TOL
    pool = run["te"].scheduler.backend.pool
    assert pool.blocks_in_use() == 0
    pool.check_invariants()
    assert len(run["te"].scheduler.chunk_s) == sum(
        -(-len(p) // 16) for _, p, _, _ in specs if len(p) > 16)


def test_chunked_prefill_on_slot_backend(params):
    """Chunking alone works on the slot backend too (admission charges
    in-flight jobs as pending): the JAX engine's run, tick by tick."""
    jc, tc = configs(chunk=16, backend="slot", max_live_tokens=600)
    vocab = tc.model.vocab_size
    rng = np.random.default_rng(8)
    specs = [(i, rng.integers(1, vocab, size=t), a, 4)
             for i, (t, a) in enumerate([(40, 0), (36, 0), (20, 1), (44, 2)])]
    run = run_pair(jc, tc, specs, params)
    assert_same_run(run)
    assert any(len(s["prefilling"]) > 1 for s in run["ts"])


def test_ttft_spans_all_prefill_chunks(params):
    """A 64-token prompt at chunk 16 takes 4 ticks to its first token, as
    in the reference; monolithic prefill takes none.  Same tokens."""
    vocab = configs()[1].model.vocab_size
    prompt = np.random.default_rng(5).integers(1, vocab, size=64)
    got = {}
    for name, chunk in (("mono", 0), ("chunked", 16)):
        jc, tc = configs(chunk=chunk, rows=1)
        run = run_pair(jc, tc, [(0, prompt, 0, 4)], params, max_steps=100)
        assert_same_run(run)
        r = run["tr"][0]
        assert r.first_token_time is not None and r.ttft_seconds() > 0
        got[name] = r
    assert got["mono"].first_token_step == got["mono"].admit_step
    assert got["chunked"].first_token_step - got["chunked"].admit_step == 3
    assert got["chunked"].ttft_steps() == 3
    assert got["mono"].generated == got["chunked"].generated


# ---------------------------------------------------------------------------
# block sharing through the scheduler
# ---------------------------------------------------------------------------


def test_prefix_sharing_parity_with_observed_refcounts(params):
    """A shared-prefix trace next to the JAX engine, tick by tick (the same
    refcounts and tables throughout): hits, refcount > 1 while requests
    are live, the tokens of a chunked engine without sharing and of a
    monolithic one, and after `flush` an empty pool."""
    jc, tc = configs(enabled=True, chunk=16)
    specs = shared_specs(tc.model.vocab_size)
    run = run_pair(jc, tc, specs, params)
    assert_same_run(run)
    te = run["te"]
    sched = te.scheduler
    stats = te.prefix_stats()
    assert stats == run["je"].prefix_stats()
    assert stats["hits"] >= 1 and stats["entries"] >= 1
    assert max(int(s["refcount"].max()) for s in run["ts"]) > 1
    hit = [r for r in run["tr"] if r.prefix_hit_tokens > 0]
    assert hit and all(r.prefix_shared_blocks.sum() > 0 for r in hit)
    sched.backend.pool.check_invariants()
    for chunk in (16, 0):  # no sharing, chunked and monolithic
        plain = Engine.build(configs(chunk=chunk)[1], params=params[1])
        pr = requests(specs, False)
        plain.run_trace(pr, max_steps=400)
        assert tokens(pr) == tokens(run["tr"])
    # after every retirement only the index holds blocks (blocks_held
    # counts references: nested boundaries share blocks)
    distinct = {(layer, int(b)) for e in sched.prefix._entries.values()
                for layer in range(e.table.shape[0]) for b in e.table[layer].ravel() if b > 0}
    assert sched.backend.pool.blocks_in_use() == len(distinct) <= stats["blocks_held"]
    sched.prefix.flush()
    assert sched.backend.pool.blocks_in_use() == 0
    sched.backend.pool.check_invariants()


@settings(max_examples=3, deadline=None)
@given(seed=st.integers(0, 10_000), frac=st.floats(0.3, 1.0))
def test_property_no_cross_request_corruption(seed, frac):
    """Random shared-prefix traces: the JAX engine's run tick by tick, and
    sharing never changes a request's tokens against the port's
    unshared chunked run."""
    params = shared_params()
    jc, tc = configs(enabled=True, chunk=16)
    kw = dict(min_prompt=36, max_prompt=56, max_new_tokens=5, seed=seed,
              prefix_templates=2, prefix_len=32, shared_fraction=frac)
    reqs = synthesize_requests(6, 0.4, tc.model.vocab_size, **kw)
    specs = [(r.req_id, r.prompt, r.arrival_step, r.max_new_tokens) for r in reqs]
    run = run_pair(jc, tc, specs, params, max_steps=600)
    assert_same_run(run)
    run["te"].scheduler.backend.pool.check_invariants()
    plain = Engine.build(configs(chunk=16)[1], params=params[1])
    pr = requests(specs, False)
    plain.run_trace(pr, max_steps=600)
    assert tokens(pr) == tokens(run["tr"])


def test_no_kernel_launch_on_cpu(params):
    """The CPU path runs the plain versions: no kernel counter moves."""
    build.reset_launches()
    jc, tc = configs(enabled=True, chunk=16)
    eng = Engine.build(tc, params=params[1])
    eng.run_trace(requests(shared_specs(tc.model.vocab_size, n_shared=2), False))
    assert all(n == 0 for n in build.LAUNCHES.values())
