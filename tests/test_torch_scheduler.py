"""The port's continuous-batching scheduler and paged backend against the
JAX package, end to end on the CPU.

minitron-8b smoke in fp32 (4 shards, fairkv_dp with 4 extra copies,
Ada-SnapKV budget 12, block size 8), weights carried across with
`repro_torch.interop`, and the same seeded `synthesize_requests` trace fed
to `Engine.run_trace` in both packages.  Required: identical tokens per
request on the slot backend, on paged pools in the engine dtype, int8 and
fp8, with online replanning (the same accepted/rejected replan sequence)
and on an undersized pool (the same preemption count); per-token logits
within 1e-4 (fp32, summation order).  Also one-shot `generate` on the
paged backend, the fail-fast and unknown-backend errors, the port's
stream / cancel / drain, and the refusal of what is not ported yet.
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
from repro.api import SchedulerConfig as JScheduler
from repro.api import synthesize_requests as jsynth
from repro.serving.request import Request as JRequest
from repro_torch import interop
from repro_torch.api import (CompressionConfig, Engine, EngineConfig, PagingConfig,
                             PlannerConfig, Request, SchedulerConfig, synthesize_requests)
from repro_torch.kernels import build

torch.set_num_threads(2)

ARCH, ROWS, N_REQ, GEN = "minitron-8b", 2, 5, 6
COMP = dict(policy="ada_snapkv", budget=12, alpha_max=2.0, obs_window=8, sink=2,
            decode_margin=8)
TOL = 1e-4
RUNS = {  # name: (backend, n_blocks, kv_dtype, replan)
    "slot": ("slot", 0, "fp32", False),
    "paged": ("paged", 0, "fp32", False),
    "paged_replan": ("paged", 0, "fp32", True),
    "slot_replan": ("slot", 0, "fp32", True),
    "int8": ("paged", 0, "int8", False),
    "fp8": ("paged", 0, "fp8", False),
    "undersized": ("paged", 16, "fp32", False),
}


def _configs(backend="slot", n_blocks=0, kv="fp32", replan=False):
    sk = dict(max_rows=ROWS, enable_replan=replan, collect_logits=True)
    if replan:  # an aggressive schedule, so the trigger fires on a short trace
        sk.update(replan_window=2, replan_threshold=1.01, replan_cooldown=2,
                  replan_min_rows=1)
    common = dict(n_shards=4, max_seq_len=64)
    j = JEngineConfig.smoke(
        ARCH, compression=JCompression(**COMP), scheduler=JScheduler(**sk),
        planner=JPlanner(mode="fairkv_dp", extra_copies=4, batch_cap=ROWS),
        cache_backend=backend,
        paging=JPaging(block_size=8, n_blocks=n_blocks, kv_dtype=kv), **common)
    t = EngineConfig.smoke(
        ARCH, device="cpu", compression=CompressionConfig(**COMP),
        scheduler=SchedulerConfig(**sk),
        planner=PlannerConfig(mode="fairkv_dp", extra_copies=4, batch_cap=ROWS),
        cache_backend=backend,
        paging=PagingConfig(block_size=8, n_blocks=n_blocks, kv_dtype=kv), **common)
    return j, t


def _traces(name, vocab):
    j = jsynth(N_REQ, 0.5, vocab, min_prompt=12, max_prompt=24, max_new_tokens=GEN, seed=0)
    t = synthesize_requests(N_REQ, 0.5, vocab, min_prompt=12, max_prompt=24,
                            max_new_tokens=GEN, seed=0)
    if name == "undersized":  # long generations outgrow a 15-block pool
        for r in j + t:
            r.max_new_tokens = 18
    return j, t


@pytest.fixture(scope="module")
def runs():
    j0, _ = _configs()
    jprobe = JEngine.build(j0)
    params = interop.to_torch(jax.tree.map(np.asarray, jprobe.params))
    out = {"params": (jprobe.params, params)}
    build.reset_launches()
    for name, (backend, nb, kv, rp) in RUNS.items():
        jc, tc = _configs(backend, nb, kv, rp)
        jr, tr = _traces(name, jc.model.vocab_size)
        je = JEngine.build(jc, params=jprobe.params)
        te = Engine.build(tc, params=params)
        out[name] = (je.run_trace(jr, max_steps=500), te.run_trace(tr, max_steps=500),
                     jr, tr, te)
    out["launches"] = dict(build.LAUNCHES)
    return out


@pytest.mark.parametrize("name", list(RUNS))
def test_trace_matches_reference(runs, name):
    """Identical tokens per request, logits within 1e-4, every request
    finished, the same replans and preemptions; pools end empty."""
    jsum, tsum, jr, tr, te = runs[name]
    assert tsum["finished"] == tsum["total"] == N_REQ
    for a, b in zip(jr, tr):
        assert a.generated == b.generated, a.req_id
        assert a.n_preemptions == b.n_preemptions
        for la, lb in zip(a.logits, b.logits):
            assert np.abs(np.asarray(la) - lb).max() < TOL
    assert tsum["preemptions"] == jsum["preemptions"]
    assert ([e["accepted"] for e in tsum["replan_log"]]
            == [e["accepted"] for e in jsum["replan_log"]])
    assert tsum["steps"] == jsum["steps"]
    assert len(te.scheduler.prepare_s) >= tsum["decode_ticks"] > 0
    if te.cfg.cache_backend == "paged":
        pool = te.scheduler.backend.pool
        assert pool.blocks_in_use() == 0
        pool.check_invariants()
        assert tsum["memory"]["blocks_in_use"] == jsum["memory"]["blocks_in_use"] == 0
        assert 0 < tsum["memory"]["peak_blocks_in_use_per_layer"] <= pool.usable_blocks


def test_slot_and_paged_give_the_same_tokens(runs):
    """The backend is storage, not math: paged pools in the engine dtype
    give the slot backend's tokens and logits bit for bit."""
    for a, b in zip(runs["slot"][3], runs["paged"][3]):
        assert a.generated == b.generated
        for la, lb in zip(a.logits, b.logits):
            assert np.array_equal(la, lb)


def test_replan_fires_and_keeps_tokens(runs):
    """Online replanning (cache migration, slot and paged) fires on this
    trace and leaves every request's tokens as without it."""
    for name in ("paged_replan", "slot_replan"):
        tsum, tr = runs[name][1], runs[name][3]
        assert any(e["accepted"] for e in tsum["replan_log"])
        for a, b in zip(runs["slot"][3], tr):
            assert a.generated == b.generated


def test_undersized_pool_preempts(runs):
    tsum, tr = runs["undersized"][1], runs["undersized"][3]
    assert tsum["preemptions"] >= 1
    assert sum(r.n_preemptions for r in tr) == tsum["preemptions"]


def test_no_kernel_launch_on_cpu(runs):
    assert all(n == 0 for n in runs["launches"].values())


def test_generate_paged_matches_reference(runs):
    """One-shot `generate` re-housed in paged pools (engine dtype and int8)
    equals the JAX engine's: tokens, lengths, logits within 1e-4."""
    jparams, params = runs["params"]
    prompts = np.random.default_rng(3).integers(0, 256, size=(2, 20)).astype(np.int32)
    for kv in ("fp32", "int8"):
        jc, tc = _configs("paged", kv=kv)
        jres = JEngine.build(jc, params=jparams).generate(prompts, 6)
        te = Engine.build(tc, params=params)
        tres = te.generate(prompts, 6)
        assert np.array_equal(jres.tokens, tres.tokens)
        assert np.array_equal(np.asarray(jres.lengths), tres.lengths)
        assert np.abs(np.asarray(jres.logits) - tres.logits).max() < TOL
        mem = te.memory_stats()
        assert 0 < mem["cache_bytes"] < mem["slot_equivalent_bytes"]


def test_never_fits_fails_fast(runs):
    _, params = runs["params"]
    _, tc = _configs("paged", n_blocks=4)
    eng = Engine.build(tc, params=params)
    with pytest.raises(ValueError, match="never be admitted"):
        eng.submit(np.arange(20, dtype=np.int32) % 50, max_new_tokens=18)


def test_config_errors():
    with pytest.raises(ValueError, match="unknown cache backend"):
        _configs("pagedd")
    with pytest.raises(ValueError, match="requires cache_backend='paged'"):
        _configs("slot", kv="int8")
    with pytest.raises(ValueError, match="block_size"):
        PagingConfig(block_size=0)


def test_stream_cancel_drain(runs):
    """`stream` yields each request's tokens in order (the run_trace tokens
    of the same trace); `cancel` frees a live row's blocks; `drain` stops
    admission and lets live rows finish."""
    _, params = runs["params"]
    _, tc = _configs("paged")
    eng = Engine.build(tc, params=params)
    _, tr = _traces("paged", tc.model.vocab_size)
    got = {}
    for ev in eng.stream(tr):
        got.setdefault(ev.req_id, []).append(ev.token)
    assert [got[r.req_id] for r in tr] == [r.generated for r in runs["paged"][3]]
    eng2 = Engine.build(tc, params=params)
    a = eng2.submit(np.arange(12, dtype=np.int32), max_new_tokens=8)
    b = eng2.submit(np.arange(14, dtype=np.int32) + 3, max_new_tokens=8)
    c = eng2.submit(np.arange(13, dtype=np.int32) + 5, max_new_tokens=8)
    eng2.step()
    assert eng2.scheduler.backend.pool.blocks_in_use() > 0
    assert eng2.cancel(a.req_id) and a.cancelled
    eng2.drain()
    while not b.is_finished:
        eng2.step()
    assert not c.is_finished and c in eng2.scheduler.queue
    assert eng2.scheduler.backend.pool.blocks_in_use() == 0
    eng2.scheduler.backend.pool.check_invariants()
    assert not eng2.cancel(12345)


def test_unported_features_refuse(runs):
    """Pool partitions (the multi-GPU executor) are ported: a split is one
    partition per (slot part, row part), sized for its own worst case, and
    a split the slots or rows do not divide is refused."""
    from repro_torch.paging.paged_cache import init_paged_cache
    cache, pool = init_paged_cache(1, 4, 2, 16, 8, PagingConfig(), partitions=(2, 1))
    M = -(-16 // PagingConfig().block_size)  # blocks per (slot, row) at capacity 16
    assert (pool.n_partitions, pool.part_size) == (2, 2 * 2 * M + 1)
    assert tuple(cache.k_pool.shape[:2]) == (1, 2 * pool.part_size)
    cache, _ = init_paged_cache(1, 4, 2, 16, 8, PagingConfig(), partitions=(2, 1), shard=(1, 0))
    assert tuple(cache.k_pool.shape[:2]) == (1, pool.part_size)
    assert tuple(cache.block_table.shape[1:3]) == (2, 2)
    with pytest.raises(ValueError, match="do not split"):
        init_paged_cache(1, 4, 2, 16, 8, PagingConfig(), partitions=(3, 1))
    with pytest.raises(ValueError, match="do not split"):
        init_paged_cache(1, 4, 2, 16, 8, PagingConfig(), partitions=(1, 4))


def test_request_trace_matches_reference():
    j = jsynth(24, 0.25, 1000, min_prompt=512, max_prompt=2048, max_new_tokens=32, seed=0)
    t = synthesize_requests(24, 0.25, 1000, min_prompt=512, max_prompt=2048,
                            max_new_tokens=32, seed=0)
    assert [r.arrival_step for r in j] == [r.arrival_step for r in t]
    assert all(np.array_equal(a.prompt, b.prompt) for a, b in zip(j, t))
    assert isinstance(t[0], Request) and not isinstance(t[0], JRequest)
