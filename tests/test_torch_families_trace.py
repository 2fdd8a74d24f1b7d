"""gemma2-9b and granite-3-2b through the port's scheduler against the JAX
package, on the CPU: continuous batching on paged pools in the engine dtype
and on int8 pools, chunked prefill, and self-speculative decoding with a
1-layer draft (qwen1.5-110b's runs, with online replanning, are in
`tests/test_torch_families_bias.py`, so the two files spread over workers).

Smoke configs in fp32 (4 shards, fairkv_dp with 4 extra copies, Ada-SnapKV
budget 12, block size 8, 2 rows), the reference's weights (qwen1.5's
biases drawn non-zero, `tests/test_torch_families.py`) and the same seeded
`synthesize_requests` trace fed to `Engine.run_trace` in both packages.
Required: identical tokens per request, per-token logits within 1e-4
(fp32, summation order; 1e-3 on int8 pools, see ``TOL_INT8``), the same
tick count and accepted replans, every request finished and the pool
empty.
"""
import numpy as np
import pytest
import torch

from repro.api import PagingConfig as JPaging
from repro.api import PrefixConfig as JPrefix
from repro.api import SchedulerConfig as JScheduler
from repro.api import SpeculationConfig as JSpeculation
from repro.api import Engine as JEngine
from repro.api import synthesize_requests as jsynth
from repro_torch.api import (Engine, PagingConfig, PrefixConfig, SchedulerConfig,
                             SpeculationConfig, synthesize_requests)
from tests.test_torch_families import ARCHS, configs, shared_params

torch.set_num_threads(2)

ROWS, N_REQ, GEN = 2, 4, 6
TOL = 1e-4
# int8 pools: the per-block scales are amax / 127 of fp32 projections the
# two frameworks sum in different orders, so a value on a rounding boundary
# can take the neighbouring code; one code step moves a logit by ~1e-4 at
# these widths (qwen1.5's non-zero biases widen the amax)
TOL_INT8 = 1e-3
SCHED = dict(max_rows=ROWS, collect_logits=True)
RUNS = {  # name: (backend, kv_dtype, scheduler extras, chunk tokens, speculation)
    "paged": ("paged", "fp32", {}, 0, None),
    "int8": ("paged", "int8", {}, 0, None),
    "chunked": ("paged", "fp32", {}, 8, None),
    "speculative": ("paged", "fp32", {}, 0, dict(enabled=True, max_k=3, draft_layers=1)),
}
TRACE_ARCHS = [a for a in ARCHS if a != "qwen1.5-110b"]
CASES = [(a, n) for a in TRACE_ARCHS for n in RUNS]


def run_pair(arch, run, params):
    """One trace through both packages' `Engine.run_trace`; ``run`` is a
    value of `RUNS`.  Returns (reference summary, port summary, reference
    requests, port requests, port engine)."""
    backend, kv, extra, chunk, spec = run
    sk = {**SCHED, "enable_replan": False, **extra}
    jc, tc = configs(
        arch, cache_backend=(backend, backend),
        scheduler=(JScheduler(**sk), SchedulerConfig(**sk)),
        paging=(JPaging(block_size=8, kv_dtype=kv), PagingConfig(block_size=8, kv_dtype=kv)),
        prefix=(JPrefix(chunk_tokens=chunk), PrefixConfig(chunk_tokens=chunk)),
        speculation=(JSpeculation(**(spec or {})), SpeculationConfig(**(spec or {}))))
    trace = dict(min_prompt=12, max_prompt=24, max_new_tokens=GEN, seed=0)
    jr = jsynth(N_REQ, 0.5, jc.model.vocab_size, **trace)
    tr = synthesize_requests(N_REQ, 0.5, tc.model.vocab_size, **trace)
    je = JEngine.build(jc, params=params[0])
    te = Engine.build(tc, params=params[1], profile=np.asarray(je.profile))
    return je.run_trace(jr, max_steps=500), te.run_trace(tr, max_steps=500), jr, tr, te


@pytest.fixture(scope="module")
def runs():
    out = {}
    for arch in TRACE_ARCHS:
        params = shared_params(configs(arch)[0])
        for name, run in RUNS.items():
            out[arch, name] = run_pair(arch, run, params)
    return out


def check_same_run(pair, name):
    """Tokens, logits, ticks and replans as the reference's; every request
    finished; pools empty; chunking and speculation really ran."""
    jsum, tsum, jr, tr, te = pair
    tol = TOL_INT8 if te.cfg.paging.kv_dtype == "int8" else TOL
    assert tsum["finished"] == tsum["total"] == N_REQ
    for a, b in zip(jr, tr):
        assert a.generated == b.generated, a.req_id
        for la, lb in zip(a.logits, b.logits):
            assert np.abs(np.asarray(la) - lb).max() < tol
    assert tsum["steps"] == jsum["steps"]
    assert ([e["accepted"] for e in tsum["replan_log"]]
            == [e["accepted"] for e in jsum["replan_log"]])
    if te.cfg.cache_backend == "paged":
        assert te.scheduler.backend.pool.blocks_in_use() == 0
    sched = te.scheduler
    if name == "chunked":
        assert len(sched.chunk_s) > N_REQ  # prompts over a chunk took several
    if name == "speculative":
        assert tsum["spec_proposed"] > 0
        assert ([(r.spec_proposed, r.spec_accepted) for r in tr]
                == [(r.spec_proposed, r.spec_accepted) for r in jr])


@pytest.mark.parametrize("arch,name", CASES, ids=[f"{a}-{n}" for a, n in CASES])
def test_trace_matches_reference(runs, arch, name):
    check_same_run(runs[arch, name], name)
