"""The SSM and hybrid families in the port against the JAX package, on the
CPU: mamba2-1.3b (attention-free) and hymba-1.5b (attention and SSD heads in
parallel, their outputs averaged), also at G = 5 query heads per kv head
(``n_kv_heads = 1``: the smoke config keeps 5 / 5 heads, G = 1).

Smoke configs in fp32 (4 shards, Ada-SnapKV budget 12, B = 2 prompts of
T = 24, 6 new tokens; hymba's window of 16 binds), the reference's weights
carried across with `repro_torch.interop`.  The reference initialises
``A_log``, ``dt_bias``, the norms to zero and ``ssm_D`` to one, values that
hide a wrong sign or a dropped term, so `perturbed_params` draws them (and
every norm scale) non-zero.  Required:

- one-shot under sha and fairkv_dp: identical greedy tokens and retained
  lengths, logits within 1e-4, and the port's plan invariance below 1e-3;
- continuous batching on the slot backend and on paged pools in the engine
  dtype (mamba2 with replanning off, hymba with it on and at least one
  replan accepted), and hymba on an undersized pool that preempts (the
  replay rebuilds the row's SSD and conv state from its prompt and earlier
  tokens): the reference's tokens per request, logits within 1e-4, its
  tick count, preemptions and replan decisions, every request finished and
  the pool empty; a replan rewrites ``attn_out_norm_s`` in the live slot
  tensors (bitwise a fresh slotify);
- mamba2 has nothing to place: a replan is refused in one-shot and
  continuous mode, ``imbalance()`` is 1.0 and the memory stats are zero.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Engine as JEngine
from repro.api import PagingConfig as JPaging
from repro.api import SchedulerConfig as JScheduler
from repro.api import synthesize_requests as jsynth
from repro_torch import interop
from repro_torch.api import Engine, PagingConfig, SchedulerConfig, synthesize_requests
from repro_torch.core import PlannerConfig, build_plan, synthetic_profile
from repro_torch.serving.engine import slotify_params
from tests.test_torch_families import GEN, PLANNERS, B, T, configs

torch.set_num_threads(2)

TOL = 1e-4
VARIANTS = {  # name: (arch, ModelConfig overrides); the encdec file's too
    "mamba2": ("mamba2-1.3b", {}),
    "hymba": ("hymba-1.5b", {}),
    "hymba-g5": ("hymba-1.5b", {"n_kv_heads": 1}),  # 5 query heads per kv head
    "whisper": ("whisper-small", {}),
    "llava": ("llava-next-34b", {}),
    "llava-g7": ("llava-next-34b", {"n_heads": 14, "n_kv_heads": 2}),  # G = 7
}
NAMES = ["mamba2", "hymba", "hymba-g5"]
# drawn non-zero: (scale, offset) of 0.5 N(0, 1) + offset per leaf
NONZERO = {"A_log": (0.5, 0.0), "dt_bias": (0.5, 0.0), "ssm_D": (0.5, 1.0),
           "ssm_norm": (0.3, 0.0), "attn_out_norm": (0.3, 0.0), "ssm_out_norm": (0.3, 0.0),
           "ln1": (0.3, 0.0), "ln2": (0.3, 0.0), "ln_cross": (0.3, 0.0)}
ROWS, N_REQ = 2, 4
REPLAN = dict(enable_replan=True, replan_window=2, replan_threshold=1.01,
              replan_cooldown=2, replan_min_rows=1)


def variant_configs(name, mode="fairkv_dp", ch=4, **kw):
    """`configs` of the variant's arch with its model overrides, in both
    packages."""
    arch, over = VARIANTS[name]
    j, t = configs(arch, mode, ch, **kw)
    if over:
        j = dataclasses.replace(j, model=dataclasses.replace(j.model, **over))
        t = t.replace(model=dataclasses.replace(t.model, **over))
    return j, t


def perturbed_params(jcfg, seed=0):
    """The reference's weights for ``jcfg`` in both packages, with the SSD
    vectors and every norm scale drawn non-zero from ``seed``."""
    tree = jax.tree.map(np.asarray, JEngine.build(jcfg).params)
    rng = np.random.default_rng(seed)

    def draw(d):
        for key, (scale, off) in NONZERO.items():
            if key in d:
                d[key] = (scale * rng.standard_normal(d[key].shape) + off).astype(d[key].dtype)

    for pl in tree["layers"] + tree.get("enc_layers", []):
        draw(pl)
    for key in ("final_norm", "enc_final_norm"):
        if key in tree:
            tree[key] = (0.3 * rng.standard_normal(tree[key].shape)).astype(tree[key].dtype)
    return jax.tree.map(jnp.asarray, tree), interop.to_torch(tree)


def oneshot_pair(name, params, batch):
    """One-shot `generate` of ``batch`` (a numpy dict) in both packages under
    each planner → {mode: (reference result, port result)}."""
    out = {}
    for mode, ch in PLANNERS:
        jc, tc = variant_configs(name, mode, ch)
        je = JEngine.build(jc, params=params[0])
        te = Engine.build(tc, params=params[1],
                          profile=None if je.profile is None else np.asarray(je.profile))
        out[mode] = (je.generate({k: jnp.asarray(v) for k, v in batch.items()}, GEN),
                     te.generate(batch, GEN))
    return out


def check_oneshot(jr, tr):
    assert np.array_equal(jr.tokens, tr.tokens)
    assert np.array_equal(np.asarray(jr.lengths), tr.lengths)
    assert np.abs(np.asarray(jr.logits) - tr.logits).max() < TOL
    assert jr.efficiency == tr.efficiency


def trace_pair(name, params, backend, n_blocks=0, sched=None, n_req=N_REQ, gen=GEN):
    """The same seeded trace through both packages' `Engine.run_trace` →
    (reference summary, port summary, reference requests, port requests,
    port engine)."""
    sk = {**dict(max_rows=ROWS, collect_logits=True, enable_replan=False), **(sched or {})}
    jc, tc = variant_configs(
        name, cache_backend=(backend, backend),
        scheduler=(JScheduler(**sk), SchedulerConfig(**sk)),
        paging=(JPaging(block_size=8, n_blocks=n_blocks),
                PagingConfig(block_size=8, n_blocks=n_blocks)))
    trace = dict(min_prompt=12, max_prompt=24, max_new_tokens=gen, seed=0)
    jr = jsynth(n_req, 0.5, jc.model.vocab_size, **trace)
    tr = synthesize_requests(n_req, 0.5, tc.model.vocab_size, **trace)
    je = JEngine.build(jc, params=params[0])
    te = Engine.build(tc, params=params[1],
                      profile=None if je.profile is None else np.asarray(je.profile))
    return je.run_trace(jr, max_steps=500), te.run_trace(tr, max_steps=500), jr, tr, te


def check_trace(pair, n_req=N_REQ):
    jsum, tsum, jr, tr, te = pair
    assert tsum["finished"] == tsum["total"] == n_req
    for a, b in zip(jr, tr):
        assert a.generated == b.generated, a.req_id
        for la, lb in zip(a.logits, b.logits):
            assert np.abs(np.asarray(la) - lb).max() < TOL
    assert tsum["steps"] == jsum["steps"]
    assert tsum["preemptions"] == jsum["preemptions"]
    assert ([e["accepted"] for e in tsum["replan_log"]]
            == [e["accepted"] for e in jsum["replan_log"]])
    pool = getattr(te.scheduler.backend, "pool", None)
    if pool is not None:
        assert pool.blocks_in_use() == 0


@pytest.fixture(scope="module")
def params():
    return {name: perturbed_params(variant_configs(name)[0]) for name in NAMES}


@pytest.fixture(scope="module")
def oneshot(params):
    prompts = np.random.default_rng(1).integers(0, 256, (B, T)).astype(np.int32)
    return {name: oneshot_pair(name, params[name], {"tokens": prompts}) for name in NAMES}


@pytest.mark.parametrize("mode", [m for m, _ in PLANNERS])
@pytest.mark.parametrize("name", NAMES)
def test_generate_matches_reference(oneshot, name, mode):
    check_oneshot(*oneshot[name][mode])


@pytest.mark.parametrize("name", ["hymba", "hymba-g5"])
def test_plan_invariance(oneshot, name):
    base, other = oneshot[name]["sha"][1], oneshot[name]["fairkv_dp"][1]
    assert np.abs(other.logits - base.logits).max() < 1e-3
    assert np.array_equal(other.lengths, base.lengths)


def test_hymba_group_of_five(oneshot):
    """The override really runs 5 query heads per kv head, and its plan
    replicates the one kv head (the balanced-impossible case)."""
    tc = variant_configs("hymba-g5")[1]
    assert tc.model.q_per_kv == 5
    assert oneshot["hymba-g5"]["fairkv_dp"][1].lengths.shape[1] == 1


@pytest.mark.parametrize("backend", ["slot", "paged"])
def test_mamba2_trace_matches_reference(params, backend):
    check_trace(trace_pair("mamba2", params["mamba2"], backend))


@pytest.mark.parametrize("backend", ["slot", "paged"])
def test_hymba_trace_matches_reference(params, backend):
    """hymba with replanning on: the tokens across each accepted replan
    hold the rewritten slot weights and ``attn_out_norm_s``."""
    pair = trace_pair("hymba", params["hymba"], backend, sched=REPLAN)
    check_trace(pair)
    assert any(e["accepted"] for e in pair[1]["replan_log"])


def test_preemption_replay_matches_reference(params):
    """An undersized pool (29 usable blocks per layer) preempts hymba
    requests mid-decode; each replay (prefill of the prompt, then the
    earlier tokens fed back) gives the reference's tokens, so the row's SSD
    and conv state were rebuilt."""
    pair = trace_pair("hymba", params["hymba"], "paged", n_blocks=30, gen=16)
    assert pair[1]["preemptions"] > 0
    check_trace(pair)


def test_replan_rewrites_attn_out_norm(params):
    """`slotify_params(..., out=sp)` (a replan's rewrite) leaves the
    hybrid's ``attn_out_norm_s`` bitwise a fresh slotify's under the new
    plan, in the tensors ``sp`` held, and the plans differ where it does."""
    cfg = variant_configs("hymba")[1].model
    tparams = params["hymba"][1]
    prof = synthetic_profile(cfg.n_layers, cfg.n_kv_heads, budget=64, skew=2.0, seed=1)
    plan_a = build_plan(prof, 4, PlannerConfig(mode="sha"))
    plan_b = build_plan(prof, 4, PlannerConfig(mode="fairkv_dp", extra_copies=4))
    sp = slotify_params(tparams, plan_a, cfg)
    before = [pl["attn_out_norm_s"].clone() for pl in sp["layers"]]
    ptrs = [pl["attn_out_norm_s"].data_ptr() for pl in sp["layers"]]
    slotify_params(tparams, plan_b, cfg, out=sp)
    fresh = slotify_params(tparams, plan_b, cfg)
    assert [pl["attn_out_norm_s"].data_ptr() for pl in sp["layers"]] == ptrs
    for got, want, old in zip(sp["layers"], fresh["layers"], before):
        assert torch.equal(got["attn_out_norm_s"], want["attn_out_norm_s"])
    assert any(not torch.equal(g["attn_out_norm_s"], o)
               for g, o in zip(sp["layers"], before))


def test_mamba2_has_no_placement(params):
    """An attention-free engine: a trivial plan, no cache, a replan refused
    in both modes, imbalance 1.0, zero memory."""
    tc = variant_configs("mamba2")[1]
    te = Engine.build(tc, params=params["mamba2"][1])
    assert te.plan.n_shards == 1
    te.generate(np.zeros((1, 8), np.int32), 2)
    assert te.state.cache is None and te.memory_stats()["cache_bytes"] == 0
    with pytest.raises(ValueError, match="no head placement"):
        te.replan()
    reqs = synthesize_requests(2, 0.5, tc.model.vocab_size, min_prompt=8, max_prompt=12,
                               max_new_tokens=3, seed=0)
    assert te.run_trace(reqs)["finished"] == 2
    assert te.imbalance() == 1.0
    with pytest.raises(ValueError, match="no head placement"):
        te.replan()
