"""qwen1.5-110b (qkv bias) through the port's scheduler against the JAX
package, on the CPU: the runs of `tests/test_torch_families_trace.py`
(paged pools in the engine dtype and int8, chunked prefill, a 1-layer
speculative draft) and online replanning on the slot and paged backends.

The biases are drawn non-zero (the reference initialises them to zero).  A
replan rewrites the slot weights in place (`serving.engine.slotify_params`
with ``out=``); had ``SLOT_WEIGHTS`` left the biases out, the new plan's
weights would run under the old plan's biases and the tokens after the
first accepted replan would differ from the reference's.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import PlannerConfig, build_plan, synthetic_profile
from repro_torch.serving.engine import SLOT_WEIGHTS, slotify_params

from tests.test_torch_families import configs, shared_params
from tests.test_torch_families_trace import RUNS, check_same_run, run_pair

torch.set_num_threads(2)

ARCH = "qwen1.5-110b"
REPLAN = dict(enable_replan=True, replan_window=2, replan_threshold=1.01,
              replan_cooldown=2, replan_min_rows=1)
ALL_RUNS = {**RUNS,
            "slot_replan": ("slot", "fp32", REPLAN, 0, None),
            "paged_replan": ("paged", "fp32", REPLAN, 0, None)}


@pytest.fixture(scope="module")
def runs():
    params = shared_params(configs(ARCH)[0])
    return {name: run_pair(ARCH, run, params) for name, run in ALL_RUNS.items()}


@pytest.mark.parametrize("name", list(ALL_RUNS))
def test_trace_matches_reference(runs, name):
    check_same_run(runs[name], name)


@pytest.mark.parametrize("name", ["slot_replan", "paged_replan"])
def test_replan_runs_accept_a_replan(runs, name):
    """The replan runs really replan: at least one new plan is accepted
    mid-trace (the tokens after it are held by the parity test above)."""
    assert any(e["accepted"] for e in runs[name][1]["replan_log"])


def test_slotify_into_live_weights_rewrites_the_biases():
    """`slotify_params(..., out=sp)` (a replan's in-place rewrite) leaves
    every slot leaf, the q/k/v biases included, bitwise what a fresh
    slotify under the new plan gives, in the tensors ``sp`` already held."""
    cfg = configs(ARCH)[1].model
    params = shared_params(configs(ARCH)[0])[1]
    prof = synthetic_profile(cfg.n_layers, cfg.n_kv_heads, budget=64, skew=2.0, seed=1)
    plan_a = build_plan(prof, 4, PlannerConfig(mode="sha"))
    plan_b = build_plan(prof, 4, PlannerConfig(mode="fairkv_dp", extra_copies=4))
    assert not np.array_equal(plan_a.as_arrays()["slot_head"], plan_b.as_arrays()["slot_head"])
    sp = slotify_params(params, plan_a, cfg)
    slot_keys = [k for k in sp["layers"][0] if k.endswith("_s")]
    assert sorted(slot_keys) == sorted(SLOT_WEIGHTS)  # the biases among them
    ptrs = [pl[k].data_ptr() for pl in sp["layers"] for k in slot_keys]
    slotify_params(params, plan_b, cfg, out=sp)
    fresh = slotify_params(params, plan_b, cfg)
    assert [pl[k].data_ptr() for pl in sp["layers"] for k in slot_keys] == ptrs
    for got, want in zip(sp["layers"], fresh["layers"]):
        for k in slot_keys:
            assert torch.equal(got[k], want[k]), k
        assert want["bq_s"].abs().sum() > 0
