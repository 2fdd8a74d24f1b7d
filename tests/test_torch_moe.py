"""The port's MoE family against the JAX package, on the CPU: `moe_block`,
FairExpert, and granite-moe-1b-a400m / qwen3-moe-30b-a3b served end to end.

- `moe_block` on the same numpy inputs and weights (fp32) at capacity
  factor E (nothing dropped), 1.25 (the configs' default) and 0.25 (replicas
  dropped, and the test asserts some were): the same top-k expert ids, the
  same kept replicas (the reference's dispatch rebuilt in jnp from its own
  top-k), outputs within 1e-5 and the same aux loss.
- The top-k tie rule: router logits tied across experts pick the lower
  expert id first, as ``jax.lax.top_k``.
- `repro_torch.core.fairexpert`'s three functions bitwise the reference's.
- Both MoE smoke configs one-shot (sha and fairkv_dp) and through the
  continuous scheduler on paged pools, with the reference's own
  ``capacity_factor = num_experts`` override (`tests/test_serving.py`) and
  without it: identical tokens and retained lengths, logits within 1e-4.
- MoE's refusals: chunked prefill, speculation and the mesh executor, with
  the reference's messages.
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
from repro.api import synthesize_requests as jsynth
from repro.configs import get_smoke_config as jget_smoke
from repro.core import fairexpert as JFE
from repro.models import moe as JMoE
from repro_torch import interop
from repro_torch.api import (CompressionConfig, Engine, EngineConfig, PagingConfig,
                             PlannerConfig, SchedulerConfig, SpeculationConfig,
                             synthesize_requests)
from repro_torch.configs import get_smoke_config
from repro_torch.core import fairexpert as FE
from repro_torch.models import moe as MoE
from repro_torch.serving import engine as serve

torch.set_num_threads(2)

ARCHS = ["granite-moe-1b-a400m", "qwen3-moe-30b-a3b"]
B, T, GEN = 2, 24, 6
COMP = dict(policy="ada_snapkv", budget=12, alpha_max=2.0, obs_window=8, sink=2,
            decode_margin=8)


def _with_cf(cfg, cf):
    return cfg.with_overrides(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


# ---------------------------------------------------------------------------
# moe_block
# ---------------------------------------------------------------------------


def _moe_inputs(arch, seed=0, T_=24):
    cfg = get_smoke_config(arch)
    E, D, Fe = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_expert
    rng = np.random.default_rng(seed)
    pl = {"router": rng.standard_normal((D, E)) / np.sqrt(D),
          "we1": rng.standard_normal((E, D, Fe)) / np.sqrt(D),
          "we3": rng.standard_normal((E, D, Fe)) / np.sqrt(D),
          "we2": rng.standard_normal((E, Fe, D)) / np.sqrt(Fe)}
    pl = {k: v.astype(np.float32) for k, v in pl.items()}
    h = rng.standard_normal((2, T_ // 2, D)).astype(np.float32)
    return pl, h


def _reference_dispatch(pl, h, jcfg):
    """The reference's top-k and kept replicas (``src`` where ``valid``),
    rebuilt in jnp from `repro.models.moe.moe_block`'s own lines."""
    E, K = jcfg.moe.num_experts, jcfg.moe.top_k
    x = jnp.asarray(h).reshape(-1, h.shape[-1])
    n = x.shape[0]
    probs = jax.nn.softmax((x @ jnp.asarray(pl["router"])).astype(jnp.float32), axis=-1)
    _, top_idx = jax.lax.top_k(probs, K)
    flat_e = top_idx.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    counts = jnp.bincount(flat_e, length=E)
    starts = jnp.concatenate([jnp.zeros(1, counts.dtype), jnp.cumsum(counts)[:-1]])
    ce = min(int(max(K, round(n * K / E * jcfg.moe.capacity_factor))), n * K)
    pos = jnp.clip(starts[:, None] + jnp.arange(ce)[None, :], 0, n * K - 1)
    valid = jnp.arange(ce)[None, :] < counts[:, None]
    src = jnp.take(order, pos)
    kept = {(e, int(s)) for e in range(E) for c, s in enumerate(np.asarray(src[e]))
            if bool(valid[e, c])}
    return np.asarray(top_idx), kept


@pytest.mark.parametrize("cf", ["E", 1.25, 0.25])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_reference(arch, cf):
    jcfg, cfg = jget_smoke(arch), get_smoke_config(arch)
    cf = float(cfg.moe.num_experts) if cf == "E" else cf
    jcfg, cfg = _with_cf(jcfg, cf), _with_cf(cfg, cf)
    pl, h = _moe_inputs(arch)
    jout, jaux = JMoE.moe_block({k: jnp.asarray(v) for k, v in pl.items()},
                                jnp.asarray(h), jcfg)
    tpl = interop.to_torch(pl)
    tout, taux = MoE.moe_block(tpl, torch.as_tensor(h), cfg)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0, atol=1e-5)
    assert abs(float(taux) - float(jaux)) < 1e-6

    j_top, j_kept = _reference_dispatch(pl, h, jcfg)
    x = torch.as_tensor(h).reshape(-1, h.shape[-1])
    _, _, t_top = MoE.route(x, tpl["router"], cfg.moe.top_k)
    assert np.array_equal(t_top.numpy(), j_top)
    src, valid = MoE.dispatch(t_top, cfg)
    t_kept = {(e, int(src[e, c])) for e in range(src.shape[0])
              for c in range(src.shape[1]) if bool(valid[e, c])}
    assert t_kept == j_kept
    n_replicas = x.shape[0] * cfg.moe.top_k
    if cf < 1.0:
        assert len(t_kept) < n_replicas  # the low factor really drops
    elif cf >= cfg.moe.num_experts:
        assert len(t_kept) == n_replicas


def test_capacity_uses_bankers_rounding():
    """Python's round, as the reference's: 2.5 -> 2, 3.5 -> 4."""
    cfg = _with_cf(get_smoke_config("qwen3-moe-30b-a3b"), 1.0)  # E 8, K 2
    assert MoE.expert_capacity(10, cfg) == 2  # 10*2/8 = 2.5 -> 2
    assert MoE.expert_capacity(14, cfg) == 4  # 3.5 -> 4
    assert MoE.expert_capacity(1, cfg) == 2  # at most T*K, at least K


def test_top_k_ties_pick_lower_expert_first():
    """Experts with identical router columns tie exactly; the picks are
    the lower ids, in the reference's order."""
    cfg = get_smoke_config("qwen3-moe-30b-a3b")  # E 8, K 2
    D, E = cfg.d_model, cfg.moe.num_experts
    rng = np.random.default_rng(5)
    col = rng.standard_normal((D, 1)).astype(np.float32)
    router = np.concatenate([0.1 * rng.standard_normal((D, 2)).astype(np.float32),
                             np.repeat(col, E - 2, axis=1)], axis=1)
    router[:, [0, 1]] -= 10.0 * col  # both below the tied columns for x ~ col
    x = np.repeat(col.T, 4, axis=0) + 0.01 * rng.standard_normal((4, D)).astype(np.float32)
    _, _, t_top = MoE.route(torch.as_tensor(x), torch.as_tensor(router), cfg.moe.top_k)
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    assert bool((probs[:, 2] == probs[:, 3]).all())  # a real tie
    _, j_top = jax.lax.top_k(probs, cfg.moe.top_k)
    assert np.array_equal(t_top.numpy(), np.asarray(j_top))
    assert (t_top.numpy() == [[2, 3]] * 4).all()


# ---------------------------------------------------------------------------
# FairExpert
# ---------------------------------------------------------------------------


def test_fairexpert_matches_reference():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((512, 32)) * 2.0
    logits[:, :3] += 2.0  # hot experts
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    load = FE.expert_dispatch_stats(probs, 8)
    assert np.array_equal(load, JFE.expert_dispatch_stats(probs, 8))
    for mode in ("sha", "fairkv_nodp", "fairkv_dp"):
        a, b = FE.plan_experts(load, 8, mode=mode), JFE.plan_experts(load, 8, mode=mode)
        for key, arr in a.as_arrays().items():
            assert np.array_equal(arr, b.as_arrays()[key]), (mode, key)
    assert FE.simulate_expert_balance(probs, 8, 8) == JFE.simulate_expert_balance(probs, 8, 8)


# ---------------------------------------------------------------------------
# serving end to end
# ---------------------------------------------------------------------------


def _configs(arch, cf, mode="fairkv_dp", ch=4, backend="slot"):
    j = JEngineConfig.smoke(arch, n_shards=4, max_seq_len=T + GEN + 8)
    t = EngineConfig.smoke(arch, device="cpu", n_shards=4, max_seq_len=T + GEN + 8)
    sk = dict(max_rows=2, enable_replan=False, collect_logits=True)
    j = dataclasses.replace(
        j, model=j.model if cf is None else _with_cf(j.model, cf),
        compression=JCompression(**COMP), cache_backend=backend,
        planner=JPlanner(mode=mode, extra_copies=ch, batch_cap=B),
        scheduler=JScheduler(**sk), paging=JPaging(block_size=8))
    t = dataclasses.replace(
        t, model=t.model if cf is None else _with_cf(t.model, cf),
        compression=CompressionConfig(**COMP), cache_backend=backend,
        planner=PlannerConfig(mode=mode, extra_copies=ch, batch_cap=B),
        scheduler=SchedulerConfig(**sk), paging=PagingConfig(block_size=8))
    return j, t


CASES = [(a, cf) for a in ARCHS for cf in ("E", None)]


@pytest.fixture(scope="module")
def runs():
    out = {}
    prompts = np.random.default_rng(1).integers(0, 256, (B, T)).astype(np.int32)
    for arch, cf in CASES:
        c = None if cf is None else float(get_smoke_config(arch).moe.num_experts)
        jparams = JEngine.build(_configs(arch, c)[0]).params
        tparams = interop.to_torch(jax.tree.map(np.asarray, jparams))
        for mode, ch in (("sha", 0), ("fairkv_dp", 4)):
            jc, tc = _configs(arch, c, mode, ch)
            je = JEngine.build(jc, params=jparams)
            te = Engine.build(tc, params=tparams, profile=np.asarray(je.profile))
            out[arch, cf, mode] = (je.generate(prompts, GEN), te.generate(prompts, GEN))
        jc, tc = _configs(arch, c, backend="paged")
        trace = dict(min_prompt=12, max_prompt=24, max_new_tokens=GEN, seed=0)
        jr = jsynth(4, 0.5, jc.model.vocab_size, **trace)
        tr = synthesize_requests(4, 0.5, tc.model.vocab_size, **trace)
        je = JEngine.build(jc, params=jparams)
        te = Engine.build(tc, params=tparams, profile=np.asarray(je.profile))
        out[arch, cf, "trace"] = (je.run_trace(jr, max_steps=500),
                                  te.run_trace(tr, max_steps=500), jr, tr, te)
    return out


@pytest.mark.parametrize("mode", ["sha", "fairkv_dp"])
@pytest.mark.parametrize("arch,cf", CASES, ids=[f"{a}-cf{c}" for a, c in CASES])
def test_oneshot_matches_reference(runs, arch, cf, mode):
    jr, tr = runs[arch, cf, mode]
    assert np.array_equal(jr.tokens, tr.tokens)
    assert np.array_equal(np.asarray(jr.lengths), tr.lengths)
    assert np.abs(np.asarray(jr.logits) - tr.logits).max() < 1e-4
    other = runs[arch, cf, "sha"][1]
    assert np.abs(tr.logits - other.logits).max() < 1e-3  # plan invariance


@pytest.mark.parametrize("arch,cf", CASES, ids=[f"{a}-cf{c}" for a, c in CASES])
def test_continuous_matches_reference(runs, arch, cf):
    jsum, tsum, jr, tr, te = runs[arch, cf, "trace"]
    assert tsum["finished"] == tsum["total"] == 4
    for a, b in zip(jr, tr):
        assert a.generated == b.generated, a.req_id
        for la, lb in zip(a.logits, b.logits):
            assert np.abs(np.asarray(la) - lb).max() < 1e-4
    assert tsum["steps"] == jsum["steps"]
    assert te.scheduler.backend.pool.blocks_in_use() == 0


def test_moe_refusals():
    """MoE serves one-shot and continuous only: chunked prefill and
    speculation refuse it with the reference's messages, and the mesh
    executor refuses it."""
    cfg = get_smoke_config("granite-moe-1b-a400m")
    with pytest.raises(ValueError, match="chunked prefill supports dense attention"):
        serve.prefill_chunk({}, torch.zeros((1, 4), dtype=torch.long), cfg, None, None,
                            None, torch.zeros(1), torch.zeros(1), torch.ones(1), [4, 4])
    with pytest.raises(ValueError, match="speculative decoding supports dense attention"):
        EngineConfig.smoke("granite-moe-1b-a400m", device="cpu", cache_backend="paged",
                           speculation=SpeculationConfig(enabled=True, max_k=2))
    from repro_torch.exec.mesh import MeshExecutor
    from tests.test_torch_mesh import fake_mesh
    with pytest.raises(NotImplementedError, match="moe needs expert parallelism"):
        MeshExecutor(cfg, CompressionConfig(), mesh=fake_mesh(model=2))
