"""The port's shared prefix blocks under copy-on-write, admission and
materialization, against the JAX package on the CPU.

The single-device cases of the reference's `tests/test_prefix.py` not in
`tests/test_torch_prefix.py` (whose helpers drive both engines tick by
tick and compare lengths, refcounts, block tables, rows, index counters
and CoW counts at every tick): CoW under ring wrap in fp32 and on int8
pools, the admission discount, shared admission fitting where private
admission cannot, materialize / migrate conservation; the counterpart of
`tests/test_speculative.py::test_spec_scheduler_ring_wrap_cow`; and the
scheduler paths around a chunked job: cancel mid-prefill, a replan
refused while jobs are in flight, index entries evicted before a
preemption.

On int8 pools the port seeds a prefix hit with the dequantized prefix
(ROADMAP C.4: the reference gathers the raw int8 codes as if they were
values); `test_quantized_seed_is_dequantized` shows the difference, and
the int8 CoW case holds the port to the reference where the fault does not
reach (topology, CoW count, the donor's tokens) and to the reference's own
oracles where it does.
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
from repro.api import PrefixConfig as JPrefix
from repro.api import SchedulerConfig as JScheduler
from repro.api import SpeculationConfig as JSpeculation
from repro.paging.backend import PagedBackend as JPagedBackend
from repro.paging.paged_cache import paged_to_slot as jpaged_to_slot
from repro_torch import interop
from repro_torch.api import (CompressionConfig, Engine, EngineConfig, PagingConfig,
                             PlannerConfig, PrefixConfig, Request, SchedulerConfig,
                             SpeculationConfig)
from repro_torch.paging.backend import PagedBackend
from repro_torch.paging.paged_cache import paged_to_slot
from tests.test_torch_prefix import (BS, assert_same_run, configs, drive, requests,
                                     run_pair, shared_specs, tokens)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def params():
    from tests.test_torch_prefix import shared_params
    return shared_params()


def wrap_specs(vocab, donor_gen=24):
    """The reference's ring-wrap trace: capacity 64 (budget 32 + margin
    32), a 48-token shared prefix; the donor's decode wraps its ring into
    its own registered blocks, the late request hits after the wrap."""
    rng = np.random.default_rng(7)
    shared = rng.integers(1, vocab, size=48).astype(np.int32)
    sfx = [rng.integers(1, vocab, size=8).astype(np.int32) for _ in range(2)]
    return [(0, np.concatenate([shared, sfx[0]]), 0, donor_gen),
            (1, np.concatenate([shared, sfx[1]]), 40, 6)]


WRAP = dict(chunk=16, budget=32, margin=32, max_seq=128)


# ---------------------------------------------------------------------------
# copy-on-write
# ---------------------------------------------------------------------------


def test_cow_privatizes_ring_wrap_writes(params):
    """Once the donor is at capacity its ring appends land in index-held
    prefix blocks and must copy on write.  Next to the JAX engine tick by
    tick (the same CoW count, refcounts and tables); the late sharer stays
    below capacity, so its tokens equal an unshared engine's only if the
    entry survived the donor's wrap bit for bit."""
    jc, tc = configs(enabled=True, **WRAP)
    specs = wrap_specs(tc.model.vocab_size)
    run = run_pair(jc, tc, specs, params)
    assert_same_run(run)
    backend = run["te"].scheduler.backend
    assert backend.cow_copies == run["je"].scheduler.backend.cow_copies > 0
    assert not backend._pending_cow
    assert run["tr"][1].prefix_hit_tokens == 48
    backend.pool.check_invariants()
    plain = Engine.build(configs(**WRAP)[1], params=params[1])
    pr = requests(specs, False)
    plain.run_trace(pr, max_steps=400)
    assert tokens(pr) == tokens(run["tr"])
    assert plain.scheduler.backend.cow_copies == 0


def test_cow_privatizes_quantized_scales(params):
    """The ring-wrap case on int8 pools: a privatized block copies its
    codes and its per-block scales.  Against the JAX engine: the same
    topology tick by tick (lengths, refcounts, tables, CoW count) and the
    donor's tokens (its blocks are self-prefilled in both).  The sharer is
    seeded from the dequantized prefix here and from raw codes in the
    reference (C.4), so its tokens are held to the reference's own
    oracles: the donor equals an unshared int8 engine, and the sharer's
    tokens do not depend on whether the donor wrapped (a second run whose
    donor stops before the wrap makes no copy at all)."""
    def sharing_run(donor_gen):
        jc, tc = configs(enabled=True, kv="int8", **WRAP)
        run = run_pair(jc, tc, wrap_specs(tc.model.vocab_size, donor_gen), params)
        for a, b in zip(run["js"], run["ts"]):
            for key in ("step", "active", "prefilling", "prefix", "cow"):
                assert a[key] == b[key], (a["step"], key)
            for key in ("lengths", "refcount", "table"):
                assert np.array_equal(a[key], b[key]), (a["step"], key)
        assert len(run["js"]) == len(run["ts"])
        assert all(r.is_finished for r in run["tr"])
        assert run["tr"][1].prefix_hit_tokens == run["jr"][1].prefix_hit_tokens == 48
        assert run["tr"][0].generated == run["jr"][0].generated  # the donor
        return run

    wrap = sharing_run(24)
    backend = wrap["te"].scheduler.backend
    assert backend.cow_copies == wrap["je"].scheduler.backend.cow_copies > 0
    assert not backend._pending_cow and not backend._pending_scale_reset
    cache = wrap["te"].scheduler.state.cache
    assert cache.k_pool.dtype == torch.int8 and float(cache.k_scale.max()) > 0
    backend.pool.check_invariants()
    plain = Engine.build(configs(kv="int8", **WRAP)[1], params=params[1])
    pr = requests(wrap_specs(plain.cfg.model.vocab_size), False)
    plain.run_trace(pr, max_steps=400)
    assert plain.scheduler.backend.cow_copies == 0
    assert pr[0].generated == wrap["tr"][0].generated
    nowrap = sharing_run(2)
    assert nowrap["te"].scheduler.backend.cow_copies == 0
    assert nowrap["tr"][1].generated == wrap["tr"][1].generated


def test_cow_copies_codes_and_scales():
    """`prepare_decode`'s CoW on an int8 pool by hand: the private block
    gets the shared block's codes, positions and both scales verbatim,
    the mirror and device table point the row at it, and the shared block
    loses one reference."""
    tc = configs(kv="int8", **WRAP)[1]
    eng = Engine.build(tc, params=None)
    b = PagedBackend(tc.model, tc.compression, paging=tc.paging)
    with torch.inference_mode():
        state = b.init_state(eng.pa, 2, torch.float32)
        cache = state.cache
        L, S = b.table.shape[:2]
        lyr, s = 1, int(np.nonzero(eng.pa.slot_head[1].numpy() >= 0)[0][0])
        row = int(np.nonzero(eng.pa.owner_mask(1, 2)[s].numpy())[0][0])
        ids = b.pool.alloc(lyr, 4)
        b.table[lyr, s, row, :4] = ids
        b._sync_table(cache)
        b.pool.incref(lyr, [ids[3]])  # the index holds the last block too
        cache.k_pool[lyr, ids[3]] = torch.randint(-127, 128, cache.k_pool.shape[2:],
                                                  dtype=torch.int8)
        cache.pos_pool[lyr, ids[3]] = torch.arange(BS, dtype=torch.int32) + 48
        cache.k_scale[lyr, ids[3]], cache.v_scale[lyr, ids[3]] = 0.5, 0.25
        cap = b.capacity
        cache.lengths[lyr, s, row] = cap  # at capacity: the ring phase picks the block
        steps = 48 - (cap - max(1, tc.compression.decode_margin))
        state.decode_steps = steps
        active = [row]
        b.prepare_decode(state, active)
        new = int(b.table[lyr, s, row, 3])
        assert new != ids[3] and b.cow_copies == 1 and not b._pending_cow
        assert int(cache.block_table[lyr, s, row, 3]) == new
        assert b.pool.refcount[lyr, ids[3]] == 1 and b.pool.refcount[lyr, new] == 1
        for t in (cache.k_pool, cache.v_pool, cache.pos_pool, cache.k_scale, cache.v_scale):
            assert torch.equal(t[lyr, new], t[lyr, ids[3]])


def test_quantized_seed_is_dequantized(params):
    """ROADMAP C.4.  A prefix hit's sub-state on int8 pools: the
    reference's seed holds the raw int8 codes (its view of the pool carries
    no scales), the port's the values those codes stand for, the same
    dequantization (kinds, scales, model dtype) as a replan's
    `paged_to_slot` of the whole pool."""
    jc, tc = configs(enabled=True, kv="int8", **WRAP)
    specs = wrap_specs(tc.model.vocab_size)[:1]
    je, te = JEngine.build(jc, params=params[0]), Engine.build(tc, params=params[1])
    jr, tr = requests(specs, True), requests(specs, False)
    done = lambda s: bool(s.prefix is not None and len(s.prefix))  # noqa: E731
    drive(je, jr, True, stop=done)
    drive(te, tr, False, stop=done)
    jsched, tsched = je.scheduler, te.scheduler
    jentry = next(iter(jsched.prefix._entries.values()))
    tentry = next(iter(tsched.prefix._entries.values()))
    assert np.array_equal(jentry.table, tentry.table)
    row = 2  # a free row
    jseed = jsched._seed_from_entry(jentry, row).cache
    with torch.inference_mode():
        tseed = tsched._seed_from_entry(tentry, row).cache
    assert jseed.k.dtype == jnp.int8  # the reference's fault: codes as values
    assert tseed.k.dtype == torch.float32
    assert np.array_equal(np.asarray(jseed.lengths), tseed.lengths.numpy())
    assert np.array_equal(np.asarray(jseed.pos), tseed.pos.numpy())
    # the reference's dequantization of the same blocks, through its scales
    tbl, lens = jsched._head_slot_table(jentry, row)
    live = jsched.state.cache
    view = dataclasses.replace(live, block_table=jnp.asarray(tbl), lengths=jnp.asarray(lens),
                               positions=jnp.full((1,), jentry.tokens, jnp.int32))
    kinds = jsched.backend._slot_kinds(jsched.pa)
    want = jpaged_to_slot(view, jsched.backend.capacity, kinds=kinds, out_dtype=jnp.float32)
    for a, b in ((want.k, tseed.k), (want.v, tseed.v)):
        a = np.asarray(a)
        assert np.abs(a - b.numpy()).max() <= 2e-6 * np.abs(a).max()
    assert np.abs(np.asarray(jseed.k)).max() > 10 * np.abs(tseed.k.numpy()).max()


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------


def test_admission_discounts_shared_blocks():
    """Admission charges only unshared blocks, as the reference's."""
    need = np.asarray([4, 4, 4], np.int64)
    req = Request(req_id=0, prompt=np.arange(8, dtype=np.int32))
    for stamp in (None, np.asarray([3, 5, 0], np.int64)):
        req.prefix_shared_blocks = stamp
        got = PagedBackend._discount_shared(need, req)
        assert np.array_equal(got, JPagedBackend._discount_shared(need, req))
    assert np.array_equal(got, [1, 0, 4])


def test_shared_admission_fits_where_private_cannot(params):
    """A pool where one private 64-token prompt blocks the next admission
    admits overlapping requests when 48 of those tokens are shared: the
    same peak of live + prefilling rows as the reference, higher with
    sharing than without, every tick's topology equal."""
    H = configs()[1].model.n_kv_heads
    n_blocks = 9 * H + 1  # admission charges 6H per private request
    vocab = configs()[1].model.vocab_size
    specs = shared_specs(vocab, shared_len=48, n_shared=4, suffix=16, gen=8, spacing=4,
                         seed=11)[:-1]
    peaks = {}
    for enabled in (True, False):
        jc, tc = configs(enabled=enabled, chunk=16, n_blocks=n_blocks, rows=4)
        run = run_pair(jc, tc, specs, params, max_steps=600)
        assert_same_run(run)
        peaks[enabled] = max(len(s["active"]) + len(s["prefilling"]) for s in run["ts"])
    assert peaks[True] > peaks[False]


# ---------------------------------------------------------------------------
# materialization of shared blocks
# ---------------------------------------------------------------------------


def test_materialize_and_migrate_conserve_shared_pool(params):
    """With two live rows sharing blocks, `paged_to_slot` is a pure gather
    (the rows materialize identical prefixes there) and a migration
    trial leaves the pool, refcounts and mirror untouched; the trace then
    finishes and the pool empties after `flush`."""
    tc = configs(enabled=True, chunk=16)[1]
    eng = Engine.build(tc, params=params[1])
    sched = eng._ensure_scheduler()
    reqs = requests(shared_specs(tc.model.vocab_size, gen=12), False)

    def live(s):  # two live rows map a common block
        tbl = s.backend.table
        rows = sorted(s.active)
        return not s.prefilling and any(
            np.intersect1d(tbl[:, :, a][tbl[:, :, a] > 0], tbl[:, :, b][tbl[:, :, b] > 0]).size
            for a in rows for b in rows if a < b)

    drive(eng, reqs, False, stop=live)
    backend = sched.backend
    assert live(sched)
    ref0, table0 = backend.pool.refcount.copy(), backend.table.copy()
    in_use0 = backend.pool.blocks_in_use()
    with torch.inference_mode():
        slot = paged_to_slot(sched.state.cache, backend.capacity)
    k, lens = slot.k.numpy(), slot.lengths.numpy()
    checked = 0
    rows = sorted(sched.active)
    for r0, r1 in [(a, b) for a in rows for b in rows if a < b]:
        for layer in range(k.shape[0]):
            for s in range(k.shape[1]):
                n = int(min(lens[layer, s, r0], lens[layer, s, r1], 48)) // BS * BS
                if n > 0 and np.array_equal(table0[layer, s, r0, :n // BS],
                                            table0[layer, s, r1, :n // BS]):
                    assert np.array_equal(k[layer, s, r0, :n], k[layer, s, r1, :n])
                    checked += 1
    assert checked > 0
    assert np.array_equal(backend.pool.refcount, ref0) and np.array_equal(backend.table, table0)
    assert backend.pool.blocks_in_use() == in_use0
    with torch.inference_mode():
        lens2, _commit = backend.migrate_cache(sched.state.cache, sched.pa, sched.pa,
                                               active_rows=sorted(sched.active))
    assert np.array_equal(backend.pool.refcount, ref0) and np.array_equal(backend.table, table0)
    backend.pool.check_invariants()
    assert np.array_equal(lens2.numpy(), lens)
    drive(eng, reqs, False)
    assert all(r.is_finished for r in reqs)
    sched.prefix.flush()
    assert backend.pool.blocks_in_use() == 0
    backend.pool.check_invariants()


# ---------------------------------------------------------------------------
# the scheduler around chunked jobs
# ---------------------------------------------------------------------------


def test_cancel_mid_chunked_prefill(params):
    """Cancelling a request mid-prefill frees its row and pin and holds no
    block; the trace then runs on with the JAX engine's topology."""
    jc, tc = configs(enabled=True, chunk=16)
    specs = shared_specs(tc.model.vocab_size)
    jparams, tparams = params
    out = {}
    for side, (E, cfg, p) in {True: (JEngine, jc, jparams), False: (Engine, tc, tparams)}.items():
        eng = E.build(cfg, params=p)
        reqs = requests(specs, side)
        sched = eng._ensure_scheduler()
        hit_job = lambda s: any(j.entry is not None for j in s.prefilling.values())  # noqa
        snaps = drive(eng, reqs, side, stop=hit_job)
        job = next(j for j in sched.prefilling.values() if j.entry is not None)
        rid, pins = job.req.req_id, job.entry.pins
        assert eng.cancel(rid) and job.req.cancelled and job.entry.pins == pins - 1
        assert job.row not in sched.prefilling and job.row in sched.freelist._free
        snaps += drive(eng, reqs, side)
        out[side] = (snaps, reqs)
    for a, b in zip(out[True][0], out[False][0]):
        for key in ("lengths", "refcount", "table"):
            assert np.array_equal(a[key], b[key])
        assert a["prefix"] == b["prefix"]
    assert tokens(out[True][1]) == tokens(out[False][1])


def test_replan_refused_while_prefilling(params):
    """A replan asked for while a chunked job is in flight is refused and
    changes nothing, as in the reference; the trigger never fires then."""
    for side, (E, p) in {True: (JEngine, params[0]), False: (Engine, params[1])}.items():
        cfg = configs(enabled=True, chunk=16)[0 if side else 1]
        eng = E.build(cfg, params=p)
        sched = eng._ensure_scheduler()
        drive(eng, requests(shared_specs(cfg.model.vocab_size), side), side,
              stop=lambda s: bool(s.prefilling) and len(s.active) >= 1)
        plan = sched.plan
        event = eng.replan()
        assert not event["accepted"] and "chunked prefills" in event["rejected_reason"]
        assert sched.plan is plan and not sched.should_replan()


def test_pool_pressure_evicts_index_before_preempting(params):
    """On a small pool, index-only entries go before any live request: the
    JAX engine's evictions and preemptions, tick by tick."""
    H = configs()[1].model.n_kv_heads
    jc, tc = configs(enabled=True, chunk=16, n_blocks=12 * H + 1, rows=3, entries=64)
    specs = shared_specs(tc.model.vocab_size, shared_len=48, n_shared=4, suffix=16,
                         gen=24, spacing=3, seed=5)
    run = run_pair(jc, tc, specs, params, max_steps=800)
    assert_same_run(run)
    stats = run["te"].prefix_stats()
    assert stats["evictions"] >= 1, stats


# ---------------------------------------------------------------------------
# speculative decoding over shared prefixes
# ---------------------------------------------------------------------------


def _spec_configs(spec=None):
    """The reference's `tests/test_speculative.py` `_cfg(rows=3, budget=32,
    margin=32, max_seq=128, prefix=...)` in both packages."""
    comp = dict(policy="none", budget=32, capacity=32, alpha_max=1.0, obs_window=8,
                sink=2, decode_margin=32)
    plan = dict(mode="fairkv_dp", extra_copies=6, batch_cap=3)
    sched = dict(max_rows=3, enable_replan=False, collect_logits=True)
    spec = spec or {}
    common = dict(n_shards=4, max_seq_len=128, cache_backend="paged")
    j = JEngineConfig.smoke(
        "minitron-8b", compression=JCompression(**comp), planner=JPlanner(**plan),
        scheduler=JScheduler(**sched), paging=JPaging(block_size=8),
        prefix=JPrefix(enabled=True, chunk_tokens=16), speculation=JSpeculation(**spec),
        **common)
    t = EngineConfig.smoke(
        "minitron-8b", device="cpu", compression=CompressionConfig(**comp),
        planner=PlannerConfig(**plan), scheduler=SchedulerConfig(**sched),
        paging=PagingConfig(block_size=8), prefix=PrefixConfig(enabled=True, chunk_tokens=16),
        speculation=SpeculationConfig(**spec), **common)
    return j, t


def test_spec_scheduler_ring_wrap_cow():
    """Speculation over shared prefixes with ring wrap (the reference's
    `test_spec_scheduler_ring_wrap_cow`): the donor reaches capacity, its
    depth drops to 0 and its ring appends copy on write out of the
    registered entry.  Both the speculative and the plain run equal the
    JAX engine's tick by tick (tokens, CoW count, refcounts, tables); the
    late sharer's tokens equal the plain run's, and the donor's up to its
    wrap."""
    jc, tc = _spec_configs()
    jparams = JEngine.build(jc).params
    params = (jparams, interop.to_torch(jax.tree.map(np.asarray, jparams)))
    specs = wrap_specs(tc.model.vocab_size)
    plain = run_pair(jc, tc, specs, params)
    spec = run_pair(*_spec_configs(dict(enabled=True, max_k=3)), specs, params)
    for run in (plain, spec):
        assert_same_run(run)
    ref, got = tokens(plain["tr"]), tokens(spec["tr"])
    assert got[1] == ref[1]  # the late sharer: full parity through CoW
    assert got[0][:9] == ref[0][:9]  # the donor, up to the wrap
    backend = spec["te"].scheduler.backend
    assert backend.cow_copies == spec["je"].scheduler.backend.cow_copies > 0
    assert not backend._pending_cow
    backend.pool.check_invariants()
    assert sum(r.spec_proposed for r in spec["tr"]) == sum(
        r.spec_proposed for r in spec["jr"]) > 0


def test_idle_admission_reclaims_index_blocks(params):
    """ROADMAP C.5.  Two unrelated 64-token prompts on a pool of 9H usable
    blocks: after the first retires, its index entries hold 4H blocks and
    the second (charged 6H) does not fit.  Nothing is live, so nothing but
    the index can free blocks: the reference idles until ``max_steps``
    (every tick a miss), the port evicts LRU entries and finishes with the
    reference's tokens for the first request."""
    H = configs()[1].model.n_kv_heads
    jc, tc = configs(enabled=True, chunk=16, n_blocks=9 * H + 1, rows=2)
    rng = np.random.default_rng(2)
    vocab = tc.model.vocab_size
    specs = [(0, rng.integers(1, vocab, size=64), 0, 4),
             (1, rng.integers(1, vocab, size=64), 12, 4)]
    run = run_pair(jc, tc, specs, params, max_steps=60)
    jr, tr = run["jr"], run["tr"]
    assert jr[0].is_finished and not jr[1].is_finished  # the reference stalls
    assert run["je"].prefix_stats()["misses"] > 30
    assert all(r.is_finished for r in tr)
    assert tr[0].generated == jr[0].generated
    stats = run["te"].prefix_stats()
    assert stats["evictions"] >= 1 and stats["misses"] == 2
    run["te"].scheduler.backend.pool.check_invariants()
    # up to the stall both runs are the same, tick by tick
    first = next(i for i, s in enumerate(run["ts"]) if s["prefix"]["evictions"])
    for a, b in zip(run["js"][:first], run["ts"][:first]):
        assert np.array_equal(a["refcount"], b["refcount"]) and a["prefix"] == b["prefix"]
