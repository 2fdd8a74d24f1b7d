"""The port's self-speculative decoding against the JAX package, on the CPU.

minitron-8b smoke in fp32 at the reference's own speculative-test setup
(`tests/test_speculative.py`: 4 shards, fairkv_dp with 6 extra copies, no
compression, block size 8, B=4 prompts of T=20, GEN=10), weights carried
across with `repro_torch.interop`.

- Executor level, hand-driven as the reference's ``_run_spec``: prepare
  (multi-token) -> propose -> verify -> trim, with a full-depth draft, a
  1-layer draft and adversarial proposals.  Committed tokens equal the
  port's plain decode and the JAX run; ``n_commit`` per tick, the device
  table and the `BlockPool` (free lists, refcounts) are bitwise the
  reference's after every trim.
- Scheduler level through `Engine.run_trace`: full and 1-layer drafts give
  the plain paged run's tokens (and the JAX spec run's), int8 pools give
  the JAX int8 spec run's tokens with the same codes; the port also
  reproduces the reference's divergence of int8 speculation from plain
  int8 decode (see `test_spec_int8_diverges_from_plain_int8`).
- Config errors.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import CompressionConfig as JCompression
from repro.api import Engine as JEngine
from repro.api import EngineConfig as JEngineConfig
from repro.api import PagingConfig as JPaging
from repro.api import PlannerConfig as JPlanner
from repro.api import SchedulerConfig as JScheduler
from repro.api import SpeculationConfig as JSpeculation
from repro.api import synthesize_requests as jsynth
from repro_torch import interop
from repro_torch.api import (CompressionConfig, Engine, EngineConfig, PagingConfig,
                             PlannerConfig, SchedulerConfig, SpeculationConfig,
                             synthesize_requests)
from repro_torch.kernels import build

torch.set_num_threads(2)

ARCH = "minitron-8b"
B, T, GEN = 4, 20, 10
CAP = T + GEN + 8
COMP = dict(policy="none", budget=64, capacity=64, alpha_max=1.0, obs_window=8,
            sink=2, decode_margin=8)
PROMPTS = np.random.default_rng(0).integers(0, 256, (B, T))
# scales are amax / qmax of fp32 projections that the two frameworks sum in
# different orders: a few fp32 steps apart (the codes are identical)
SCALE_RTOL = 2e-6


def _configs(spec=None, kv="fp32", backend="paged", **sk):
    sched = dict(max_rows=B, enable_replan=False)
    sched.update(sk)
    spec = spec or {}
    common = dict(n_shards=4, max_seq_len=CAP, cache_backend=backend)
    j = JEngineConfig.smoke(
        ARCH, compression=JCompression(**COMP), scheduler=JScheduler(**sched),
        planner=JPlanner(mode="fairkv_dp", extra_copies=6, batch_cap=B),
        paging=JPaging(block_size=8, kv_dtype=kv), speculation=JSpeculation(**spec),
        **common)
    t = EngineConfig.smoke(
        ARCH, device="cpu", compression=CompressionConfig(**COMP),
        scheduler=SchedulerConfig(**sched),
        planner=PlannerConfig(mode="fairkv_dp", extra_copies=6, batch_cap=B),
        paging=PagingConfig(block_size=8, kv_dtype=kv),
        speculation=SpeculationConfig(**spec), **common)
    return j, t


@pytest.fixture(scope="module")
def params():
    jparams = JEngine.build(_configs()[0]).params
    return jparams, interop.to_torch(jax.tree.map(np.asarray, jparams))


# ---------------------------------------------------------------------------
# executor level: prepare -> propose -> verify -> trim, by hand
# ---------------------------------------------------------------------------


def _fresh(eng):
    eng.prefill(PROMPTS)
    eng.state = eng.backend.from_prefill(eng.state, eng.pa)
    return eng.state


def _plain(eng):
    """GEN single-token greedy decode steps -> (B, GEN) tokens."""
    state = _fresh(eng)
    toks = []
    for _ in range(GEN):
        state = eng.backend.prepare_decode(state, None)
        state, _ = eng.executor.decode(eng.sp, state, eng.pa, state.last_tokens)
        toks.append(np.array(state.last_tokens))  # a copy: updated in place
    return np.stack(toks, 1)


def _spec(eng, draft_layers, max_k, adversarial, jax_side):
    """The scheduler's speculative tick, hand-driven (the reference's
    ``_run_spec``).  Returns (tokens (B, GEN), acceptance, per-tick
    [(n_commit, host table, device table, refcounts, free lists)])."""
    vocab = eng.cfg.model.vocab_size
    state = _fresh(eng)
    committed = [[] for _ in range(B)]
    accepted = proposed = ticks = 0
    log = []
    while min(len(c) for c in committed) < GEN:
        lens = np.asarray(state.cache.lengths)
        headroom = CAP - lens.max(axis=(0, 1))
        depth = np.minimum(max_k, np.maximum(headroom - 1, 0)).astype(np.int32)
        if ticks % 2 == 1:  # vary the depths between ticks
            depth = np.minimum(depth, np.maximum(1, max_k - 1))
        ticks += 1
        q_len = depth + 1
        state = eng.backend.prepare_decode(state, None, n_tokens=int(q_len.max()))
        wrap = jnp.asarray if jax_side else torch.as_tensor
        st, props = eng.executor.propose(eng.sp, state, eng.pa, wrap(depth),
                                         draft_layers=draft_layers, max_k=max_k)
        props = np.asarray(props)
        if adversarial:  # every lane wrong: the first proposal must be rejected
            props = (props + 1) % vocab
        tokens = np.concatenate([np.asarray(st.last_tokens)[:, None], props], axis=1)
        st, g, n_commit, _ = eng.executor.verify(eng.sp, st, eng.pa, wrap(tokens),
                                                 wrap(q_len), draft_layers=draft_layers)
        state = eng.backend.trim_rows(st, np.arange(B))
        g, nc = np.asarray(g), np.asarray(n_commit)
        for b in range(B):
            committed[b].extend(g[b, :nc[b]].tolist())
        proposed += int(depth.sum())
        accepted += int((nc - 1).sum())
        pool = eng.backend.pool
        free = [list(f[0] if jax_side else f) for f in pool._free]  # copies
        log.append((nc.copy(), eng.backend.table.copy(),
                    np.asarray(state.cache.block_table).copy(),
                    np.asarray(pool.refcount).copy(), free))
        pool.check_invariants()
    eng.state = state
    return np.stack([np.array(c[:GEN]) for c in committed]), accepted / max(proposed, 1), log


CASES = {"full_draft": (0, 3, False), "one_layer": (1, 3, False),
         "adversarial": (0, 3, True)}


@pytest.fixture(scope="module")
def executor_runs(params):
    jparams, tparams = params
    jc, tc = _configs()
    je, te = JEngine.build(jc, params=jparams), Engine.build(tc, params=tparams)
    nL = tc.model.n_layers
    out = {"plain": (_plain(je), None)}
    with torch.inference_mode():
        out["plain"] = (out["plain"][0], _plain(te))
        for name, (d, k, adv) in CASES.items():
            out[name] = (_spec(je, d or nL, k, adv, True),
                         _spec(te, d or nL, k, adv, False))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_spec_executor_matches_plain_and_reference(executor_runs, name):
    """Committed tokens equal the port's plain decode and the JAX spec run;
    per tick, n_commit, the host mirror, the device table, refcounts and
    free lists equal the reference's bitwise (every trim included)."""
    jplain, tplain = executor_runs["plain"]
    assert np.array_equal(jplain, tplain)
    (jtoks, jacc, jlog), (ttoks, tacc, tlog) = executor_runs[name]
    assert np.array_equal(ttoks, tplain)
    assert np.array_equal(ttoks, jtoks)
    assert tacc == jacc
    assert len(tlog) == len(jlog)
    for (jn, jh, jd, jr, jf), (tn, th, td, tr, tf) in zip(jlog, tlog):
        assert np.array_equal(jn, tn)
        assert np.array_equal(jh, th) and np.array_equal(jd, td)
        assert np.array_equal(th, td)  # the device table follows the mirror
        assert np.array_equal(jr, tr) and jf == tf
    if name == "full_draft":
        assert tacc == 1.0
    if name == "adversarial":
        assert tacc == 0.0 and len(tlog) == GEN  # one committed token per tick
        assert all((n == 1).all() for n, *_ in tlog)
    if name == "one_layer":
        assert 0.0 < tacc < 1.0


def test_no_kernel_launch_on_cpu(executor_runs):
    assert all(n == 0 for n in build.LAUNCHES.values())


# ---------------------------------------------------------------------------
# backend: multi-token prepare_decode and trim_rows against the reference
# ---------------------------------------------------------------------------


def test_prepare_and_trim_match_reference(params):
    """`prepare_decode(n_tokens)` takes provisional blocks through
    ``(min(len + n, C) - 1) // bs``, and `trim_rows` hands back every block
    past ``ceil(len / bs)``: tables, refcounts and free lists bitwise the
    reference backend's, the device table in sync with the mirror."""
    jparams, tparams = params
    jc, tc = _configs()
    je, te = JEngine.build(jc, params=jparams), Engine.build(tc, params=tparams)
    rng = np.random.default_rng(5)
    with torch.inference_mode():
        js, ts = _fresh(je), _fresh(te)
        for n_tokens in (9, 3, 17, 1):
            rows = np.sort(rng.choice(B, size=3, replace=False))
            js = je.backend.prepare_decode(js, rows, n_tokens=n_tokens)
            ts = te.backend.prepare_decode(ts, rows, n_tokens=n_tokens)
            assert np.array_equal(je.backend.table, te.backend.table)
            assert np.array_equal(ts.cache.block_table.numpy(), te.backend.table)
            # roll a few lengths back on both sides, as a rejected window does
            drop = rng.integers(0, 3, size=ts.cache.lengths.shape).astype(np.int32)
            lens = np.maximum(np.asarray(js.cache.lengths) - drop, 0)
            js = dataclasses.replace(js, cache=dataclasses.replace(
                js.cache, lengths=jnp.asarray(lens)))
            ts.cache.lengths.copy_(torch.from_numpy(lens))
            js = je.backend.trim_rows(js, rows)
            ts = te.backend.trim_rows(ts, rows)
            assert np.array_equal(je.backend.table, te.backend.table)
            assert np.array_equal(np.asarray(js.cache.block_table),
                                  ts.cache.block_table.numpy())
            assert np.array_equal(je.backend.pool.refcount, te.backend.pool.refcount)
            assert [f[0] for f in je.backend.pool._free] == te.backend.pool._free
            te.backend.pool.check_invariants()
    with pytest.raises(ValueError, match="n_tokens"):
        te.backend.prepare_decode(ts, [0], n_tokens=0)


# ---------------------------------------------------------------------------
# scheduler level: Engine.run_trace with speculation on
# ---------------------------------------------------------------------------

SPECS = {
    "plain": (None, "fp32"),
    "full_draft": (dict(enabled=True, max_k=3), "fp32"),
    "one_layer": (dict(enabled=True, max_k=3, draft_layers=1, min_k=1,
                       low_acceptance=0.4), "fp32"),
    "plain_int8": (None, "int8"),
    "one_layer_int8": (dict(enabled=True, max_k=3, draft_layers=1), "int8"),
    "full_draft_int8": (dict(enabled=True, max_k=3), "int8"),
}


def _trace(vocab, jax_side):
    return (jsynth if jax_side else synthesize_requests)(
        6, 0.5, vocab, min_prompt=8, max_prompt=20, max_new_tokens=10, seed=3)


@pytest.fixture(scope="module")
def traces(params):
    jparams, tparams = params
    out = {}
    for name, (spec, kv) in SPECS.items():
        jc, tc = _configs(spec, kv)
        je, te = JEngine.build(jc, params=jparams), Engine.build(tc, params=tparams)
        jr, tr = _trace(jc.model.vocab_size, True), _trace(tc.model.vocab_size, False)
        jsum = je.run_trace(jr, max_steps=400)
        depths = []
        if spec and spec.get("draft_layers") == 1 and kv == "fp32":
            sched = te._ensure_scheduler()  # record the adaptive depth per tick
            orig = sched._decode_tick_speculative

            def tick(events, orig=orig, sched=sched):
                orig(events)
                depths.append(dict(sched._spec_depth))
            sched._decode_tick_speculative = tick
        tsum = te.run_trace(tr, max_steps=400)
        out[name] = dict(jsum=jsum, tsum=tsum, jr=jr, tr=tr, je=je, te=te,
                         depths=depths)
    return out


def _tokens(reqs):
    return {r.req_id: tuple(r.generated) for r in reqs}


@pytest.mark.parametrize("name", list(SPECS))
def test_spec_trace_matches_reference(traces, name):
    """Every run: each request finished with all its tokens, the JAX
    scheduler's tokens and tick count, the pool empty and consistent."""
    run = traces[name]
    tsum, jsum = run["tsum"], run["jsum"]
    assert tsum["finished"] == tsum["total"] == 6
    assert _tokens(run["tr"]) == _tokens(run["jr"])
    assert tsum["steps"] == jsum["steps"]
    assert all(r.n_generated == r.max_new_tokens for r in run["tr"])
    pool = run["te"].scheduler.backend.pool
    pool.check_invariants()
    assert pool.blocks_in_use() == 0
    sched = run["te"].scheduler
    if SPECS[name][0] is not None:
        assert len(sched.propose_s) == len(sched.verify_s) == tsum["decode_ticks"] > 0
        assert [r.spec_proposed for r in run["tr"]] == [r.spec_proposed for r in run["jr"]]
        assert [r.spec_accepted for r in run["tr"]] == [r.spec_accepted for r in run["jr"]]


def test_spec_full_draft_fewer_ticks_same_tokens(traces):
    """Full-depth self-draft: the plain paged run's tokens in strictly
    fewer ticks, every proposal accepted."""
    plain, spec = traces["plain"], traces["full_draft"]
    assert _tokens(spec["tr"]) == _tokens(plain["tr"])
    assert spec["tsum"]["steps"] < plain["tsum"]["steps"]
    assert spec["tsum"]["decode_ticks"] < plain["tsum"]["decode_ticks"]
    assert spec["tsum"]["spec_proposed"] > 0
    assert spec["tsum"]["acceptance"] == 1.0
    assert plain["tsum"]["acceptance"] is None


def test_spec_one_layer_draft_rejects_and_adapts(traces):
    """A 1-layer draft is often rejected: tokens still equal the plain run,
    0 <= accepted <= proposed per request with accepted < proposed overall,
    and the adaptive depth walks down from max_k."""
    plain, spec = traces["plain"], traces["one_layer"]
    assert _tokens(spec["tr"]) == _tokens(plain["tr"])
    reqs = spec["tr"]
    assert all(0 <= r.spec_accepted <= r.spec_proposed for r in reqs)
    total_p = sum(r.spec_proposed for r in reqs)
    total_a = sum(r.spec_accepted for r in reqs)
    assert total_a < total_p
    assert spec["tsum"]["acceptance"] == pytest.approx(total_a / total_p)
    seen = [d for tick in spec["depths"] for d in tick.values()]
    assert max(seen) == 3 and min(seen) == 1  # seeded at max_k, walked to min_k


def test_spec_int8_matches_reference_codes(traces):
    """int8 pools under a 1-layer draft: the JAX spec run's tokens (checked
    above) and its pool contents at the end: codes bitwise, scales within
    a few fp32 steps (SCALE_RTOL)."""
    run = traces["one_layer_int8"]
    jc, tc = run["je"].scheduler.state.cache, run["te"].scheduler.state.cache
    for jp, tp in ((jc.k_pool, tc.k_pool), (jc.v_pool, tc.v_pool)):
        assert np.array_equal(np.asarray(jp), tp.numpy())
    for js, ts in ((jc.k_scale, tc.k_scale), (jc.v_scale, tc.v_scale)):
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=SCALE_RTOL, atol=0)
    assert run["tsum"]["spec_proposed"] > 0


def test_spec_int8_diverges_from_plain_int8(traces):
    """The port reproduces the reference's divergence of int8 speculation
    from plain int8 decode: with a 1-layer draft, request 2's tokens differ
    from the plain int8 run in both packages and the other five requests
    are identical; with a full-depth draft (nothing rejected) all six are
    identical.  The cause, shown on the first tick below: verify appends
    every window token with quantize-on-write, which raises the target
    block's scale as a running max and re-encodes its earlier entries;
    the rollback lowers only ``lengths``, so a rejected token leaves its
    block's scale above what plain decode gives."""
    plain, spec, full = (traces[k] for k in ("plain_int8", "one_layer_int8",
                                               "full_draft_int8"))
    for side in ("tr", "jr"):
        a, b = _tokens(plain[side]), _tokens(spec[side])
        assert [rid for rid in a if a[rid] != b[rid]] == [2]
        assert _tokens(full[side]) == a


def test_rejected_int8_entries_inflate_block_scales(params):
    """Mechanism of the divergence above, on layer 0 of int8 pools under a
    1-layer draft.  There every committed token's K/V is computed exactly
    as plain decode computes it (the draft's decode steps write layer 0),
    so after one speculative tick with rejections, and after each row's
    committed count of plain decode steps from the same prefill, retained
    lengths and tables agree and no block scale of the speculative cache is
    smaller; some are strictly larger, raised by rejected tokens."""
    _, tparams = params
    _, tc = _configs(kv="int8")
    spec_eng, plain_eng = (Engine.build(tc, params=tparams) for _ in range(2))
    with torch.inference_mode():
        s = _fresh(spec_eng)
        depth = np.full(B, 3, np.int32)
        s = spec_eng.backend.prepare_decode(s, None, n_tokens=4)
        st, props = spec_eng.executor.propose(spec_eng.sp, s, spec_eng.pa,
                                              torch.as_tensor(depth), draft_layers=1,
                                              max_k=3)
        tokens = torch.cat([st.last_tokens[:, None], props], dim=1)
        st, g, n_commit, _ = spec_eng.executor.verify(
            spec_eng.sp, st, spec_eng.pa, tokens, torch.as_tensor(depth + 1),
            draft_layers=1)
        st = spec_eng.backend.trim_rows(st, np.arange(B))
        assert int(n_commit.min()) < 4  # some window token was rejected
        p = _fresh(plain_eng)
        for j in range(int(n_commit.max())):
            rows = [b for b in range(B) if n_commit[b] > j]
            p = plain_eng.backend.prepare_decode(p, rows)
            p, _ = plain_eng.executor.decode(plain_eng.sp, p, plain_eng.pa,
                                             active=n_commit > j)
        assert torch.equal(st.cache.lengths, p.cache.lengths)
        tbl = st.cache.block_table[0]
        assert torch.equal(tbl, p.cache.block_table[0])
        ids = tbl[tbl > 0].long()
        ks, kp = st.cache.k_scale[0, ids], p.cache.k_scale[0, ids]
        assert bool((ks >= kp).all()) and bool((ks > kp).any())


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


def test_spec_config_errors(params):
    with pytest.raises(ValueError, match="requires cache_backend='paged'"):
        _configs(dict(enabled=True), backend="slot")
    with pytest.raises(ValueError, match="exceeds the model's"):
        _configs(dict(enabled=True, draft_layers=99))
    with pytest.raises(ValueError, match="min_k"):
        SpeculationConfig(max_k=2, min_k=3)
    with pytest.raises(ValueError, match="max_k"):
        SpeculationConfig(max_k=0)
    # the scheduler refuses a slot backend even past the config check
    from repro_torch.serving.scheduler import Scheduler
    _, tparams = params
    _, tc = _configs(backend="slot")
    eng = Engine.build(tc, params=tparams)
    with pytest.raises(ValueError, match="needs the paged backend"):
        Scheduler(tc.model, tparams, eng.plan, tc.compression, tc.scheduler,
                  eng.executor, spec_cfg=SpeculationConfig(enabled=True))
