"""The port's executor layer against the JAX package, on the CPU.

minitron-8b smoke in fp32, weights carried across with
`repro_torch.interop`.  Covered here:

- the reference's executor plumbing (`tests/test_executor.py`): the
  built-in executor is registered, an unknown executor and equal mesh
  axes are rejected, the local executor refuses a mesh; the
  ``STEP_KINDS`` table equals the reference's, and the port rejects
  ``donate_state=False``, which it cannot honour;
- the ring-write phase as a device scalar: `ring_write_index` and a
  decode step at capacity give the int path's result bit for bit, and
  the reference's `ring_write_index`, across a wrap of the ring;
- `append_selection` without a host sync: bitwise the reference's on the
  same numpy inputs, chunks that overrun the capacity included;
- the static-address invariant that CUDA-graph replay rests on: the data
  pointers of the slot weights, the plan arrays, the cache, the last
  tokens and the ring-phase buffer do not move across a paged continuous
  trace with chunked prefill, copy-on-write at ring wrap and a forced
  replan, nor across two one-shot `generate` calls around a replan; the
  tokens (and, tick by tick, lengths, refcounts, tables and counters)
  equal the reference's;
- one engine serving a one-shot `generate` before and during a
  continuous trace (slot backend, and paged pools with sharing): the
  trace and each generate give what separate engines give;
- `Engine.warmup`: an all-inactive tick that leaves the cache and the
  ring phase as they were, so a warmed engine runs a trace as a cold one.

Graph capture itself needs the card: `tests/test_torch_cuda.py`.
"""
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
from repro.cache import slot_cache as jslot
from repro.exec.base import STEP_KINDS as J_STEP_KINDS
from repro_torch.api import (CompressionConfig, Engine, EngineConfig, ExecutorConfig,
                             PagingConfig, PlannerConfig, PrefixConfig, SchedulerConfig,
                             list_executors)
from repro_torch.cache import slot_cache as tslot
from repro_torch.exec.base import STEP_KINDS, make_executor
from repro_torch.exec.local import LocalExecutor, _tensors
from repro_torch.serving import engine as tserve
from tests.test_torch_prefix import assert_same_run, drive, requests, shared_params
from tests.test_torch_prefix_cow import wrap_specs

torch.set_num_threads(2)

ARCH = "minitron-8b"


@pytest.fixture(scope="module")
def params():
    return shared_params()


def _cfg(**kw):
    return EngineConfig.smoke(ARCH, device="cpu", **kw)


# ---------------------------------------------------------------------------
# registry / config plumbing (the reference's tests/test_executor.py)
# ---------------------------------------------------------------------------


def test_builtin_executors_registered():
    assert "local" in list_executors()


def test_config_rejects_unknown_executor():
    with pytest.raises(ValueError, match="local"):
        _cfg(executor="bogus")
    with pytest.raises(TypeError):
        _cfg(executor_cfg={"donate_state": True})


def test_executor_config_validation():
    with pytest.raises(ValueError, match="differ"):
        ExecutorConfig(data_axis="x", model_axis="x")
    with pytest.raises(ValueError, match="non-empty"):
        ExecutorConfig(data_axis="")
    with pytest.raises(ValueError, match="in place"):
        ExecutorConfig(donate_state=False)


def test_local_executor_rejects_mesh():
    cfg = _cfg()
    with pytest.raises(ValueError, match="mesh"):
        make_executor("local", cfg.model, cfg.compression, mesh=object(), device="cpu")


def test_step_kinds_and_counters():
    """The kind table is the reference's; on the CPU the local executor is
    eager (no capture, every counter and legacy view at 0), and graphs
    without a CUDA device are refused."""
    assert STEP_KINDS == J_STEP_KINDS
    cfg = _cfg()
    ex = make_executor("local", cfg.model, cfg.compression, device="cpu")
    assert isinstance(ex, LocalExecutor) and not ex.graphs
    assert ex.step_traces == {k: 0 for k in STEP_KINDS}
    assert (ex.prefill_traces, ex.prefill_chunk_traces, ex.decode_traces,
            ex.propose_traces, ex.verify_traces) == (0, 0, 0, 0, 0)
    assert (ex.pool_partitions, ex.row_partitions) == (1, 1)
    state = object()
    assert ex.shard_state(state) is state
    with pytest.raises(ValueError, match="CUDA"):
        LocalExecutor(cfg.model, cfg.compression, device="cpu", graphs=True)
    with pytest.raises(NotImplementedError, match="A.10"):
        ex.decode_hlo(None, None, None, None)


# ---------------------------------------------------------------------------
# the ring phase as a device scalar
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("capacity,ring", [(12, 4), (9, 9), (16, 1)])
def test_ring_phase_scalar_matches_int_and_reference(capacity, ring):
    """Across two wraps of the ring: a device-scalar phase gives the int
    phase's write index bit for bit, and the reference's."""
    rng = np.random.default_rng(capacity)
    lengths = rng.integers(0, capacity + 1, size=(3, 5)).astype(np.int32)
    lengths[0, :2] = capacity  # rows at capacity take the ring
    for phase in range(2 * ring + 3):
        got = tslot.ring_write_index(torch.as_tensor(lengths),
                                     torch.tensor(phase, dtype=torch.int64), capacity, ring)
        want = tslot.ring_write_index(torch.as_tensor(lengths), phase, capacity, ring)
        ref = jslot.ring_write_index(jnp.asarray(lengths), jnp.int32(phase), capacity, ring)
        assert got.dtype == want.dtype == torch.int32
        assert torch.equal(got, want)
        assert np.array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("backend", ["slot", "paged"])
def test_ring_phase_scalar_decode_step_bitwise(params, backend):
    """Decode steps at capacity (every append takes the recency ring) with
    the phase as a device scalar and as the host int: the same caches and
    logits, bit for bit, across a wrap."""
    _, tparams = params
    cfg = _cfg(compression=CompressionConfig(policy="snapkv", budget=8, capacity=8,
                                             obs_window=4, sink=1, decode_margin=3),
               cache_backend=backend, paging=PagingConfig(block_size=4))
    prompts = np.random.default_rng(3).integers(0, 200, size=(2, 24))
    runs = []
    for scalar in (False, True):
        eng = Engine.build(cfg, params=tparams)
        with torch.inference_mode():
            eng.prefill(prompts)
            state = eng.backend.from_prefill(eng.state, eng.pa)
            logits = []
            for step in range(10):  # 8 kept of capacity 11, ring 3: two wraps
                state = eng.backend.prepare_decode(state, None)
                phase = torch.tensor(state.decode_steps) if scalar else None
                state, lg = tserve.decode_step(eng.sp, state, cfg.model, eng.pa,
                                               cfg.compression, phase=phase)
                logits.append(lg)
        runs.append((state, torch.stack(logits)))
    (a, la), (b, lb) = runs
    assert torch.equal(la, lb) and torch.equal(a.last_tokens, b.last_tokens)
    assert int(a.cache.lengths.max()) == cfg.compression.static_capacity()
    for x, y in zip(_tensors(a.cache), _tensors(b.cache)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# append_selection without a host sync
# ---------------------------------------------------------------------------


def _plans(n_shards=2, copies=2, rows=4):
    """(JAX, port) plan arrays of one Fair-Copying plan (replicas present)."""
    kw = dict(mode="fairkv_dp", extra_copies=copies, batch_cap=rows, slots_per_shard=2)
    je = JEngine.build(JEngineConfig.smoke(ARCH, n_shards=n_shards, planner=JPlanner(**kw)))
    te = Engine.build(_cfg(n_shards=n_shards, planner=PlannerConfig(**kw)))
    assert (te.pa.replica_count > 1).any()
    for name in ("slot_head", "replica_idx", "replica_count", "first_slot"):
        assert np.array_equal(np.asarray(getattr(je.pa, name)), getattr(te.pa, name).numpy())
    return je.pa, te.pa


@pytest.mark.parametrize("C,Ck,Csel,fill", [(24, 8, 8, "low"), (24, 8, 8, "full"),
                                            (10, 16, 12, "mixed")],
                         ids=["headroom", "overrun", "selection_wider_than_capacity"])
def test_append_selection_bitwise_reference(C, Ck, Csel, fill):
    """The fixed-shape write gives the reference's cache bit for bit:
    entries land after each pair's length, columns past the capacity are
    dropped, unowned pairs are untouched."""
    jpa, tpa = _plans()
    L, S = tpa.slot_head.shape
    H, B, Dh = tpa.first_slot.shape[1], 3, 4
    rng = np.random.default_rng(C + Ck + Csel)
    hi = {"low": C // 3, "full": C + 1, "mixed": C + 1}[fill]
    lengths = rng.integers(0 if fill != "full" else C - 3, hi, size=(L, S, B)).astype(np.int32)
    k = rng.standard_normal((L, S, B, C, Dh)).astype(np.float32)
    v = rng.standard_normal((L, S, B, C, Dh)).astype(np.float32)
    pos = rng.integers(-1, 100, size=(L, S, B, C)).astype(np.int32)
    positions = rng.integers(0, 100, size=(B,)).astype(np.int32)
    k_full = rng.standard_normal((B, Ck, H, Dh)).astype(np.float32)
    v_full = rng.standard_normal((B, Ck, H, Dh)).astype(np.float32)
    sel_idx = np.sort(rng.integers(0, Ck, size=(B, H, Csel)), axis=-1).astype(np.int32)
    sel_len = rng.integers(0, Csel + 1, size=(B, H)).astype(np.int32)
    rows = np.array([2, 0, 3], np.int32)
    start = rng.integers(0, 50, size=(B,)).astype(np.int32)
    for layer in range(L):
        jc = jslot.append_selection(
            jslot.SlotCache(*(jnp.asarray(x) for x in (k, v, lengths, pos, positions))),
            layer, jnp.asarray(k_full), jnp.asarray(v_full), jnp.asarray(sel_idx),
            jnp.asarray(sel_len), jpa, jnp.asarray(rows), jnp.asarray(start))
        tc = tslot.SlotCache(*(torch.tensor(x) for x in (k, v, lengths, pos, positions)))
        tslot.append_selection(tc, layer, torch.tensor(k_full), torch.tensor(v_full),
                               torch.tensor(sel_idx), torch.tensor(sel_len), tpa,
                               torch.tensor(rows), torch.tensor(start))
        for name in ("k", "v", "lengths", "pos", "positions"):
            assert np.array_equal(np.asarray(getattr(jc, name)),
                                  getattr(tc, name).numpy()), (layer, name)
        assert (tc.lengths.numpy() != lengths).any()  # something was appended


# ---------------------------------------------------------------------------
# the static-address invariant
# ---------------------------------------------------------------------------


def _ptrs(*objs):
    return [t.data_ptr() for o in objs for t in _tensors(o)]


# a build profile that misplaces heads for the realized (uniform) lengths:
# layer 0's head 0 looks heavy, so the plan puts three of the four
# (layer, head) pairs on one shard and the replan from the realized
# profile is accepted (imbalance 1.5 -> 1.0)
SKEWED = np.array([[100.0, 1.0], [1.0, 1.0]])


def _wrap_configs():
    """The ring-wrap trace's configuration (capacity 64 = 32 + 32, chunks of
    16, sharing on) over two shards of two slots without replicas;
    replanning only when forced."""
    rows = 3
    sk = dict(max_rows=rows, enable_replan=False, collect_logits=True)
    comp = dict(policy="none", budget=32, capacity=32, decode_margin=32, obs_window=8)
    plan = dict(mode="fairkv_dp", batch_cap=rows, slots_per_shard=2, r_max=1)
    j = JEngineConfig.smoke(
        ARCH, n_shards=2, max_seq_len=128, compression=JCompression(**comp),
        planner=JPlanner(**plan), scheduler=JScheduler(**sk), cache_backend="paged",
        paging=JPaging(block_size=16, n_blocks=256),
        prefix=JPrefix(enabled=True, chunk_tokens=16))
    t = _cfg(n_shards=2, max_seq_len=128, compression=CompressionConfig(**comp),
             planner=PlannerConfig(**plan), scheduler=SchedulerConfig(**sk),
             cache_backend="paged", paging=PagingConfig(block_size=16, n_blocks=256),
             prefix=PrefixConfig(enabled=True, chunk_tokens=16))
    return j, t


def test_static_addresses_continuous(params):
    """A paged trace with chunked prefills, copy-on-write at ring wrap and a
    replan forced after it: no tensor a captured step reads moves, and
    every tick matches the reference's."""
    jparams, tparams = params
    jc, tc = _wrap_configs()
    je = JEngine.build(jc, params=jparams, profile=SKEWED)
    te = Engine.build(tc, params=tparams, profile=SKEWED)
    specs = wrap_specs(tc.model.vocab_size)
    jr, tr = requests(specs, True), requests(specs, False)
    sched = te._ensure_scheduler()
    live = lambda: _ptrs(sched.sp, sched.pa, sched.state.cache,  # noqa: E731
                         sched.state.last_tokens, te.executor.phase)
    before = live()
    seen = {"chunks": 0}

    def check(s):
        assert live() == before, s.step_idx
        seen["chunks"] += len(s.prefilling)
        return s.backend.cow_copies > 0 and not s.prefilling

    after_cow = lambda s: s.backend.cow_copies > 0 and not s.prefilling  # noqa: E731
    js, ts = drive(je, jr, True, stop=after_cow), drive(te, tr, False, stop=check)
    assert sched.backend.cow_copies > 0 and seen["chunks"] > 0
    old = sched.pa.slot_head.clone()
    jev = je.scheduler.replan()
    tev = te.scheduler.replan()
    assert tev["accepted"] and jev["accepted"]
    assert not torch.equal(old, sched.pa.slot_head)
    assert np.array_equal(sched.pa.slot_head.numpy(), np.asarray(je.scheduler.pa.slot_head))
    assert live() == before
    js += drive(je, jr, True)
    ts += drive(te, tr, False, stop=lambda s: check(s) and False)
    assert seen["chunks"] > 4  # the late request's chunks too
    assert_same_run(dict(je=je, te=te, jr=jr, tr=tr, js=js, ts=ts))


@pytest.mark.parametrize("backend", ["slot", "paged"])
def test_static_addresses_oneshot(params, backend):
    """Two `generate` calls around a one-shot replan: the second lands in
    the first one's tensors, the replan copies into them, and both give
    the reference's tokens and lengths."""
    jparams, tparams = params
    comp = dict(policy="ada_snapkv", budget=16, alpha_max=2.0, obs_window=8, sink=2,
                decode_margin=8)
    plan = dict(mode="fairkv_dp", extra_copies=2, batch_cap=4, slots_per_shard=2)
    kw = dict(n_shards=2, cache_backend=backend)
    je = JEngine.build(JEngineConfig.smoke(ARCH, compression=JCompression(**comp),
                                           planner=JPlanner(**plan), **kw), params=jparams)
    te = Engine.build(_cfg(compression=CompressionConfig(**comp),
                           planner=PlannerConfig(**plan), **kw), params=tparams)
    prompts = np.random.default_rng(5).integers(0, 256, size=(4, 40)).astype(np.int32)
    t1 = te.generate(prompts, 5)
    live = lambda: _ptrs(te.sp, te.pa, te.state.cache, te.state.last_tokens,  # noqa: E731
                         te.executor.phase)
    before = live()
    old = te.pa.slot_head.clone()
    flipped = np.ascontiguousarray(te.profile[:, ::-1])  # heads swap roles
    te.replan(profile=flipped)
    assert not torch.equal(old, te.pa.slot_head)  # the replan moved heads
    assert live() == before
    t2 = te.generate(prompts, 5)
    assert live() == before
    j1 = je.generate(prompts, 5)
    je.replan(profile=flipped)
    j2 = je.generate(prompts, 5)
    for a, b in ((j1, t1), (j2, t2)):
        assert np.array_equal(np.asarray(a.tokens), b.tokens)
        assert np.array_equal(np.asarray(a.lengths), b.lengths)


@pytest.mark.parametrize("mode", ["slot", "chunked"])
def test_generate_between_ticks(mode):
    """One engine serving a one-shot `generate` before and during a
    continuous trace, with a replan accepted mid-trace: the trace gives a
    continuous-only engine's tokens and logits, and each generate the
    tokens and logits of a one-shot engine built on the plan it ran under.
    The one-shot state and the scheduler's share a layout (on the card
    each gets its own decode graph)."""
    from tests.test_torch_cuda import _SKEWED, _graph_cfg, _mixed_trace, mixed_run
    cfg = _graph_cfg(mode, device="cpu")
    eng = Engine.build(cfg, profile=_SKEWED)
    prompts = np.random.default_rng(2).integers(0, 256, size=(3, 40))
    reqs = _mixed_trace(cfg.model.vocab_size)
    outs, plans = mixed_run(eng, reqs, prompts)
    assert tserve.state_layout(eng._live) == tserve.state_layout(eng.scheduler.state)
    cont = Engine.build(cfg, params=eng.params, profile=_SKEWED)
    cont.warmup()
    ref_reqs = _mixed_trace(cfg.model.vocab_size)
    list(cont.stream(ref_reqs))
    for x, y in zip(reqs, ref_reqs):
        assert x.generated == y.generated
        assert all(np.array_equal(p, q) for p, q in zip(x.logits, y.logits))
    for out, plan in zip(outs, plans):
        ref = Engine(cfg, eng.params, plan, eng.profile).generate(prompts, 4)
        assert np.array_equal(out.tokens, ref.tokens)
        assert np.array_equal(out.logits, ref.logits)
    assert plans[0] is not plans[1]  # the scheduler replanned in between


# ---------------------------------------------------------------------------
# Engine.warmup
# ---------------------------------------------------------------------------


def test_warmup_leaves_state_and_trace_unchanged(params):
    """The all-inactive warmup tick (decode, then propose + verify with
    speculation, and a chunk step on a scratch sub-state with chunking)
    leaves lengths, positions and the ring phase as they were; a warmed
    engine then runs a trace to the cold engine's tokens, and warmup is a
    no-op while requests are live."""
    from repro_torch.api import SpeculationConfig, synthesize_requests
    _, tparams = params
    cfg = _cfg(cache_backend="paged", paging=PagingConfig(block_size=8),
               compression=CompressionConfig(policy="ada_snapkv", budget=16, obs_window=8,
                                             sink=2, decode_margin=8),
               scheduler=SchedulerConfig(max_rows=2),
               speculation=SpeculationConfig(enabled=True, max_k=2, draft_layers=1),
               prefix=PrefixConfig(chunk_tokens=16))

    def trace():
        return synthesize_requests(4, 0.5, cfg.model.vocab_size, min_prompt=20,
                                   max_prompt=40, max_new_tokens=5, seed=2)

    cold = Engine.build(cfg, params=tparams)
    cold_reqs = trace()
    cold.run_trace(cold_reqs)
    warm = Engine.build(cfg, params=tparams)
    warm.warmup()
    st = warm.scheduler.state
    assert st.decode_steps == 0
    assert int(st.cache.lengths.abs().sum()) == 0 and int(st.cache.positions.abs().sum()) == 0
    warm_reqs = trace()
    warm.run_trace(warm_reqs)
    assert [r.generated for r in warm_reqs] == [r.generated for r in cold_reqs]
    busy = Engine.build(cfg, params=tparams)
    busy.submit(trace()[0])
    busy.step()
    sched = busy.scheduler
    steps, lengths = sched.state.decode_steps, sched.state.cache.lengths.clone()
    busy.warmup()  # a live row: a no-op
    assert sched.state.decode_steps == steps and torch.equal(sched.state.cache.lengths, lengths)
