"""The port's observability layer (`repro_torch.obs`) against the JAX
package's, on the CPU.

- Registry, trace ring and exports: the same calls on both packages'
  `MetricsRegistry` / `TraceBuffer` give the same snapshot, Prometheus
  text and JSONL, and the same Chrome trace events (timestamps aside).
- Engine wiring: the same continuous traces through both packages' engines
  (a paged int8 pool that preempts, with online replanning; shared-prefix
  reuse with chunked prefill; speculative decoding; a one-shot
  `generate`) leave the same metric families, series and help texts, every
  counter at the same value, the same histogram counts, the same
  deterministic gauges and the same trace event names.  One family
  differs by design: ``stepfn_compiles_total`` counts CUDA-graph captures
  in the port (none on the CPU, where the steps run eagerly) and jit
  traces in the reference.
- Obs off changes no token and records nothing; a capture is counted once
  by `_observe_step`, and none happens during a trace.
"""
import json
import time

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
from repro.obs import MetricsRegistry as JRegistry
from repro.obs import TraceBuffer as JTrace
from repro_torch.api import (CompressionConfig, Engine, EngineConfig, MetricsRegistry, Obs,
                             ObsConfig, PagingConfig, PlannerConfig, PrefixConfig,
                             SchedulerConfig, SpeculationConfig, TraceBuffer)
from repro_torch.obs import NULL_OBS
from tests.test_torch_prefix import requests, shared_params, shared_specs

torch.set_num_threads(2)

ARCH = "minitron-8b"
# gauges that are a pure function of the trace (not of a clock)
DETERMINISTIC_GAUGES = {
    "shard_load_tokens", "shard_projected_load", "sched_imbalance", "sched_active_rows",
    "sched_queue_depth", "sched_prefilling_rows", "prefix_entries", "prefix_shared_blocks",
    "prefix_bytes_saved", "pool_free_blocks", "pool_blocks_in_use",
    "pool_free_blocks_partition", "pool_fragmentation_blocks", "pool_max_refcount",
    "cache_live_tokens", "cache_utilization", "kv_bytes_per_token", "spec_depth"}


# ---------------------------------------------------------------------------
# registry, trace ring, exports
# ---------------------------------------------------------------------------


def _record(reg):
    reg.counter("req_total", help="all requests").inc(2, shard="0")
    reg.counter("req_total").inc(3, shard="1")
    reg.counter("zero").inc(0, outcome="rejected")
    reg.gauge("depth", help="queue depth").set(3.5)
    reg.gauge("depth").set(4, tenant='a"b\\c')
    h = reg.histogram("lat", help="latency")
    for v in (0.0001, 0.003, 0.2, 7.0, 99.0):
        h.observe(v, kind="decode")
    reg.histogram("custom", buckets=(0.5, 1.0)).observe(0.7)
    return reg


def test_registry_exports_match_reference():
    j, t = _record(JRegistry()), _record(MetricsRegistry())
    assert t.snapshot() == j.snapshot()
    assert t.to_prometheus() == j.to_prometheus()
    assert t.to_jsonl() == j.to_jsonl()
    assert t.counter_value("req_total", shard="1") == j.counter_value("req_total", shard="1")
    for reg in (j, t):  # a family keeps its kind
        with pytest.raises(TypeError, match="already registered"):
            reg.gauge("req_total")


def _trace(tr):
    with tr.span("step", rows=3):
        pass
    tr.instant("compile", kind="decode")
    tr.complete("external", time.perf_counter(), 0.25, executor="local")
    for i in range(6):
        tr.instant("e", i=i)
    try:
        with tr.span("boom"):
            raise RuntimeError("x")
    except RuntimeError:
        pass
    return json.loads(tr.export_json())


def test_trace_ring_matches_reference():
    j, t = _trace(JTrace(capacity=5)), _trace(TraceBuffer(capacity=5))

    def strip(doc):
        return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
                for e in doc["traceEvents"]]
    assert strip(t) == strip(j)
    assert len(t["traceEvents"]) == 5 and t["traceEvents"][-1]["args"]["error"] == "RuntimeError"
    assert set(t) == set(j)


def test_obs_handle_and_null_path():
    assert not Obs.build(ObsConfig(enabled=False)).enabled
    assert Obs.build(ObsConfig(enabled=False)).metrics is NULL_OBS.metrics
    with pytest.raises(ValueError):
        ObsConfig(trace_capacity=0)
    m = NULL_OBS.metrics
    m.counter("a").inc(5)
    assert m.snapshot() == {} and m.to_prometheus() == ""


# ---------------------------------------------------------------------------
# the same traces through both packages' engines
# ---------------------------------------------------------------------------


def _pool_configs():
    """Paged int8 pools of 16 blocks (the trace must preempt) with an
    aggressive replan schedule, Ada-SnapKV on a 4-shard fairkv_dp plan."""
    comp = dict(policy="ada_snapkv", budget=12, alpha_max=2.0, obs_window=8, sink=2,
                decode_margin=8)
    sk = dict(max_rows=2, enable_replan=True, replan_window=2, replan_threshold=1.01,
              replan_cooldown=2, replan_min_rows=1)
    plan = dict(mode="fairkv_dp", extra_copies=4, batch_cap=2)
    pg = dict(block_size=8, n_blocks=16, kv_dtype="int8")
    common = dict(n_shards=4, max_seq_len=64, cache_backend="paged")
    return (JEngineConfig.smoke(ARCH, compression=JCompression(**comp),
                                scheduler=JScheduler(**sk), planner=JPlanner(**plan),
                                paging=JPaging(**pg), **common),
            EngineConfig.smoke(ARCH, device="cpu", compression=CompressionConfig(**comp),
                               scheduler=SchedulerConfig(**sk), planner=PlannerConfig(**plan),
                               paging=PagingConfig(**pg), **common))


def _prefix_configs():
    """Shared-prefix reuse with 16-token chunks on bf16-equivalent pools."""
    comp = dict(policy="none", budget=128, capacity=128, decode_margin=8, obs_window=8)
    sk = dict(max_rows=3, enable_replan=False)
    pg = dict(block_size=16, n_blocks=256)
    pf = dict(enabled=True, chunk_tokens=16)
    common = dict(max_seq_len=256, cache_backend="paged")
    return (JEngineConfig.smoke(ARCH, compression=JCompression(**comp),
                                scheduler=JScheduler(**sk), planner=JPlanner(batch_cap=3),
                                paging=JPaging(**pg), prefix=JPrefix(**pf), **common),
            EngineConfig.smoke(ARCH, device="cpu", compression=CompressionConfig(**comp),
                               scheduler=SchedulerConfig(**sk), planner=PlannerConfig(batch_cap=3),
                               paging=PagingConfig(**pg), prefix=PrefixConfig(**pf), **common))


def _spec_configs():
    """Self-speculative decoding with a 1-layer draft."""
    comp = dict(policy="none", budget=64, capacity=64, alpha_max=1.0, obs_window=8,
                sink=2, decode_margin=8)
    sk = dict(max_rows=2, enable_replan=False)
    spec = dict(enabled=True, max_k=3, draft_layers=1)
    common = dict(n_shards=4, max_seq_len=64, cache_backend="paged")
    return (JEngineConfig.smoke(ARCH, compression=JCompression(**comp),
                                scheduler=JScheduler(**sk), paging=JPaging(block_size=8),
                                planner=JPlanner(batch_cap=2),
                                speculation=JSpeculation(**spec), **common),
            EngineConfig.smoke(ARCH, device="cpu", compression=CompressionConfig(**comp),
                               scheduler=SchedulerConfig(**sk), paging=PagingConfig(block_size=8),
                               planner=PlannerConfig(batch_cap=2),
                               speculation=SpeculationConfig(**spec), **common))


def _specs(name, vocab):
    rng = np.random.default_rng(2)
    if name == "prefix":
        return shared_specs(vocab)
    gen = 18 if name == "pool" else 8
    return [(i, rng.integers(1, vocab, size=int(rng.integers(12, 24))), a, gen)
            for i, a in enumerate([0, 0, 1, 2, 3])]


CASES = {"pool": _pool_configs, "prefix": _prefix_configs, "spec": _spec_configs}


def _run(name):
    jparams, tparams = shared_params()
    jc, tc = CASES[name]()
    je, te = JEngine.build(jc, params=jparams), Engine.build(tc, params=tparams)
    specs = _specs(name, tc.model.vocab_size)
    jr, tr = requests(specs, True), requests(specs, False)
    jout, tout = je.run_trace(jr, max_steps=400), te.run_trace(tr, max_steps=400)
    assert tout["finished"] == tout["total"] == jout["finished"]
    assert {r.req_id: r.generated for r in tr} == {r.req_id: r.generated for r in jr}
    return je, te, jout, tout


def _assert_same_metrics(je, te):
    js, ts = je.metrics(), te.metrics()
    assert "stepfn_compiles_total" not in ts  # no capture on the CPU
    assert sum(te.executor.step_traces.values()) == 0
    assert set(js) - {"stepfn_compiles_total"} == set(ts)
    for name, fam in ts.items():
        ref = js[name]
        assert (fam["kind"], fam["help"]) == (ref["kind"], ref["help"]), name
        labels = [s["labels"] for s in fam["series"]]
        assert labels == [s["labels"] for s in ref["series"]], name
        for a, b in zip(ref["series"], fam["series"]):
            if fam["kind"] == "counter" or name in DETERMINISTIC_GAUGES:
                assert b["value"] == a["value"], (name, b["labels"], a["value"], b["value"])
            elif fam["kind"] == "histogram":
                assert b["count"] == a["count"], name
                if name == "spec_acceptance":
                    assert b["sum"] == pytest.approx(a["sum"], rel=1e-12)
            elif name == "kv_quant_rel_err":  # two codecs, one error: fp32 sums
                assert b["value"] == pytest.approx(a["value"], rel=1e-4)
    jnames = {e["name"] for e in json.loads(je.trace_export())["traceEvents"]}
    tnames = {e["name"] for e in json.loads(te.trace_export())["traceEvents"]}
    assert tnames == jnames - {f"stepfn_{k}_compile" for k in
                               ("prefill", "prefill_chunk", "decode", "propose", "verify")}
    json.loads(te.trace_export())
    for line in te.metrics_prometheus().splitlines():
        if not line.startswith("#"):
            float(line.rsplit(" ", 1)[1])


@pytest.mark.parametrize("name", sorted(CASES))
def test_trace_metrics_match_reference(name):
    je, te, jout, tout = _run(name)
    _assert_same_metrics(je, te)
    m = te.obs.metrics
    assert m.counter_value("sched_admissions_total") >= tout["finished"]
    assert m.counter_value("sched_retirements_total") == tout["finished"]
    assert m.get("ttft_s").count() >= tout["finished"]
    if name == "pool":
        assert tout["preemptions"] > 0 and m.counter_value("pool_exhausted_total") > 0
        assert (m.counter_value("sched_preemptions_total") == tout["preemptions"])
        assert (m.counter_value("sched_replans_total", outcome="accepted")
                == tout["replans"] == jout["replans"])
        assert m.counter_value("kv_quant_tokens_total") > 0
    if name == "prefix":
        assert m.counter_value("prefix_hits_total") == te.stats().prefix.hits > 0
    if name == "spec":
        assert m.counter_value("spec_proposed_total") == tout["spec_proposed"] > 0
    st, sj = te.stats(), je.stats()
    assert st.scheduler.replans_accepted == sj.scheduler.replans_accepted
    assert st.scheduler.replans_rejected == sj.scheduler.replans_rejected


def test_oneshot_metrics_match_reference():
    """`generate`: one TTFT sample, one ITL and one decode `stepfn_wall_s`
    sample per step, one prefill sample, in both packages."""
    jparams, tparams = shared_params()
    jc, tc = _pool_configs()
    jc = jc.replace(paging=JPaging(block_size=8, kv_dtype="int8"))
    tc = tc.replace(paging=PagingConfig(block_size=8, kv_dtype="int8"))
    je, te = JEngine.build(jc, params=jparams), Engine.build(tc, params=tparams)
    prompts = np.random.default_rng(0).integers(0, tc.model.vocab_size, (2, 12))
    jres, tres = je.generate(prompts, 3), te.generate(prompts, 3)
    assert np.array_equal(jres.tokens, tres.tokens)
    _assert_same_metrics(je, te)
    m = te.obs.metrics
    assert m.get("ttft_s").count() == 1 and m.get("itl_s").count() == 3
    assert m.get("stepfn_wall_s").count(kind="decode", executor="local") == 3
    assert m.get("stepfn_wall_s").count(kind="prefill", executor="local") == 1


def test_obs_off_keeps_tokens_and_records_nothing():
    """Obs off: the same tokens (the quantization-error observation reads
    the admitted caches only with obs on), empty exports."""
    _, tparams = shared_params()
    _, tc = _pool_configs()
    vocab = tc.model.vocab_size
    outs = {}
    for enabled in (True, False):
        eng = Engine.build(tc.replace(obs=ObsConfig(enabled=enabled)), params=tparams)
        reqs = requests(_specs("pool", vocab), False)
        out = eng.run_trace(reqs, max_steps=400)
        assert out["finished"] == out["total"]
        outs[enabled] = ({r.req_id: list(r.generated) for r in reqs}, out["preemptions"],
                         out["replans"])
        if not enabled:
            assert eng.metrics() == {} and eng.metrics_prometheus() == ""
            assert json.loads(eng.trace_export())["traceEvents"] == []
            assert eng.stats().scheduler.replans_accepted is None
    assert outs[True] == outs[False]


def test_captures_are_counted_once_and_never_during_a_trace():
    """`_observe_step` counts a call that captured (``step_traces`` grew)
    once in ``stepfn_compiles_total`` and a replay not at all; on the CPU a
    whole trace through the observed executor captures nothing."""
    _, tparams = shared_params()
    _, tc = _pool_configs()
    eng = Engine.build(tc, params=tparams)
    ex = eng.executor

    def step(capture):
        if capture:
            ex.step_traces["decode"] += 1
        return "out"

    assert ex._observe_step("decode", step, (True,)) == "out"
    for _ in range(3):
        ex._observe_step("decode", step, (False,))
    m = eng.obs.metrics
    assert m.counter_value("stepfn_compiles_total", kind="decode", executor="local") == 1
    assert m.get("stepfn_wall_s").count(kind="decode", executor="local") == 4
    with pytest.raises(ValueError, match="unknown StepFn kind"):
        ex._observe_step("bogus", step, (False,))
    ex.step_traces["decode"] = 0
    eng2 = Engine.build(tc, params=tparams)
    eng2.warmup()
    before = dict(eng2.executor.step_traces)
    eng2.run_trace(requests(_specs("pool", tc.model.vocab_size), False), max_steps=400)
    assert eng2.executor.step_traces == before
    assert eng2.obs.metrics.counter_value("stepfn_compiles_total", kind="decode",
                                          executor="local") == 0
