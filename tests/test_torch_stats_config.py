"""The port's `Engine.stats()` and `EngineConfig.to_dict` / `from_dict`
against the JAX package, on the CPU.

- After the same traces (paged pools with shared-prefix reuse; an
  undersized int8 pool that preempts and replans; speculative decoding)
  and after a one-shot `generate`, every typed field of every
  `EngineStats` section equals the reference's; the deprecated accessors
  delegate to it.
- Config files: `to_dict` round-trips through JSON; a dict the reference's
  `to_dict` wrote loads in the port and equals the port's own config;
  unknown keys are rejected at any depth, as in the reference.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.api import EngineConfig as JEngineConfig
from repro.api import ObsConfig as JObs
from repro.api import PagingConfig as JPaging
from repro.api import PrefixConfig as JPrefix
from repro.api import SpeculationConfig as JSpeculation
from repro.api import CompressionConfig as JCompression
from repro.api import Engine as JEngine
from repro_torch.api import (CompressionConfig, Engine, EngineConfig, EngineStats, ObsConfig,
                             PagingConfig, PrefixConfig, SpeculationConfig)
from repro_torch.api import stats as tstats
from tests.test_torch_obs import CASES, _pool_configs, _run
from tests.test_torch_prefix import shared_params

torch.set_num_threads(2)

ARCH = "minitron-8b"
SECTIONS = ("scheduler", "pool", "prefix", "plan", "speculation")


def _typed(section) -> dict:
    """A stats section's typed fields (``detail`` holds each package's raw
    dict, whose keys differ)."""
    return {f.name: getattr(section, f.name) for f in dataclasses.fields(section)
            if f.name != "detail"}


def _assert_same_stats(je, te):
    js, ts = je.stats(), te.stats()
    assert isinstance(ts, EngineStats)
    for name in SECTIONS:
        assert _typed(getattr(ts, name)) == _typed(getattr(js, name)), name
    assert ts.speculation.detail == js.speculation.detail
    assert ts.prefix.detail == js.prefix.detail
    json.dumps(ts.to_dict())


@pytest.mark.parametrize("name", sorted(CASES))
def test_stats_match_reference_after_trace(name):
    je, te, _, _ = _run(name)
    _assert_same_stats(je, te)
    st = te.stats()
    assert st.scheduler.mode == "continuous"
    assert st.scheduler.finished == len(te.finished_requests) > 0
    assert te.replan_log == st.scheduler.replan_log
    assert te.imbalance() == st.scheduler.imbalance
    assert te.memory_stats() == st.pool.detail
    assert te.prefix_stats() == st.prefix.detail
    assert [r.req_id for r in te.finished_requests] == [r.req_id for r in je.finished_requests]
    if name == "pool":
        assert st.scheduler.preemptions > 0 and st.pool.backend == "paged"
    if name == "prefix":
        assert st.prefix.enabled and st.prefix.hits > 0
    if name == "spec":
        assert st.speculation.enabled and st.speculation.proposed > 0


def test_stats_oneshot_and_idle():
    jparams, tparams = shared_params()
    jc, tc = _pool_configs()
    jc = jc.replace(paging=JPaging(block_size=8, kv_dtype="int8"))
    tc = tc.replace(paging=PagingConfig(block_size=8, kv_dtype="int8"))
    je, te = JEngine.build(jc, params=jparams), Engine.build(tc, params=tparams)
    _assert_same_stats(je, te)  # idle: every section empty
    assert te.stats().scheduler.mode == "idle" and te.stats().pool.detail == {}
    with pytest.raises(RuntimeError):
        te.memory_stats()
    with pytest.raises(RuntimeError):
        te.imbalance()
    prompts = np.random.default_rng(0).integers(0, tc.model.vocab_size, (2, 12))
    je.generate(prompts, 3)
    te.generate(prompts, 3)
    _assert_same_stats(je, te)
    assert te.stats().pool.blocks_in_use > 0


def test_collect_stats_is_the_engine_method():
    _, tparams = shared_params()
    te = Engine.build(_pool_configs()[1], params=tparams)
    assert tstats.collect_stats(te) == te.stats()


# ---------------------------------------------------------------------------
# config files
# ---------------------------------------------------------------------------


def _pair(**kw):
    """The same configuration in both packages (the port's on the CPU)."""
    comp = dict(policy="headkv", budget=24, alpha_max=2.0, obs_window=8, sink=2,
                decode_margin=8, headkv_base_ratio=0.3, pyramid_beta=0.5)
    pg = dict(block_size=8, n_blocks=64, kv_dtype="int8",
              kv_dtype_overrides={(0, 1): "fp8", (1, 0): "fp8"})
    common = dict(n_shards=2, max_seq_len=96, cache_backend="paged", dtype="bfloat16",
                  seed=3, profile_skew=1.5)
    j = JEngineConfig.smoke(ARCH, compression=JCompression(**comp), paging=JPaging(**pg),
                            prefix=JPrefix(enabled=True, chunk_tokens=16, max_entries=7),
                            speculation=JSpeculation(enabled=True, max_k=2, draft_layers=1),
                            obs=JObs(enabled=False, trace_capacity=9), **common, **kw)
    t = EngineConfig.smoke(ARCH, device="cpu", compression=CompressionConfig(**comp),
                           paging=PagingConfig(**pg),
                           prefix=PrefixConfig(enabled=True, chunk_tokens=16, max_entries=7),
                           speculation=SpeculationConfig(enabled=True, max_k=2, draft_layers=1),
                           obs=ObsConfig(enabled=False, trace_capacity=9), **common, **kw)
    return j, t


def test_to_dict_round_trips_through_json():
    _, t = _pair()
    d = json.loads(json.dumps(t.to_dict()))
    assert EngineConfig.from_dict(d) == t
    assert EngineConfig.from_dict(t.to_dict()) == t
    default = EngineConfig.smoke(ARCH)
    assert EngineConfig.from_dict(json.loads(json.dumps(default.to_dict()))) == default


def test_port_dict_has_the_reference_keys():
    """Every key of the reference's dict is in the port's, except the ones
    the port does not model; the port adds ``device``."""
    j, t = _pair()
    jd, td = j.to_dict(), t.to_dict()
    assert set(td) - set(jd) == {"device"}
    assert set(jd) - set(td) == {"frontend"}
    for sec in ("compression", "paging", "planner", "scheduler", "prefix", "speculation",
                "executor_cfg", "obs", "model"):
        extra = set(jd[sec]) - set(td[sec])
        assert extra <= {"append_mode", "decode_impl"}, (sec, extra)
        assert set(td[sec]) <= set(jd[sec]), sec


def test_reference_dict_loads_in_the_port():
    j, t = _pair()
    loaded = EngineConfig.from_dict(json.loads(json.dumps(j.to_dict())))
    assert loaded.device == "cuda"  # the port's default: the card
    assert loaded.replace(device="cpu") == t
    # the reference's default dict too, and a pyramidkv / slot one
    for cfg in (JEngineConfig.smoke(ARCH),
                JEngineConfig.smoke(ARCH, compression=JCompression(policy="pyramidkv"))):
        got = EngineConfig.from_dict(cfg.to_dict())
        assert got.compression == CompressionConfig(**{
            k: v for k, v in dataclasses.asdict(cfg.compression).items()
            if k != "append_mode"})


def test_unknown_keys_are_rejected():
    _, t = _pair()
    d = t.to_dict()
    for path in (("bogus",), ("paging", "bogus"), ("model", "moe", "bogus"),
                 ("compression", "headkv_ratio")):
        bad = json.loads(json.dumps(d))
        node = bad
        for p in path[:-1]:
            node = node[p]
        node[path[-1]] = 1
        with pytest.raises(ValueError, match="unknown key"):
            EngineConfig.from_dict(bad)
    bad = json.loads(json.dumps(d))
    bad["compression"]["append_mode"] = "bogus"  # a reference-only key, unknown value
    with pytest.raises(ValueError, match="append_mode"):
        EngineConfig.from_dict(bad)
    with pytest.raises(TypeError):
        EngineConfig.from_dict({"model": 3})
    with pytest.raises(TypeError, match="obs must be an ObsConfig"):
        EngineConfig.smoke(ARCH, device="cpu", obs={"enabled": False})
