"""The port's six compression policies, their admission bounds and
`plan_kv_dtypes` against the JAX package, on the CPU.

- `streaming_llm`, `pyramidkv`, `h2o` and `headkv` (with and without
  ``head_importance``) give the reference's indices and lengths bitwise on
  max-pooled scores full of exact ties, over several layers (the two
  policies of earlier slices ride along);
- the partial last chunk: the chunk path pads scores with ``-inf``, and
  `h2o`'s recent-window ``+inf`` turns the pad into NaN; the port's rule
  (NaN ranks as ``-inf``, ties in index order) gives the reference's
  selection at the test shapes and at minitron-8b's chunk shape;
- ROADMAP C.6, in both packages: the chunk-boundary compression guarantees
  and keeps padding positions of a partial last chunk;
- `layer_keep_bound` bounds the realized Σ keep of every policy (a
  hypothesis property), except `ada_snapkv`'s scores tied with its pooled
  threshold (ROADMAP C.7, a fault of both packages, pinned here);
- `plan_kv_dtypes` returns the reference's tuple;
- the continuous scheduler under `headkv` (with importance) and
  `pyramidkv`, slot and paged, next to the JAX engine tick by tick: the
  same retained lengths, rows and queue every tick, the same tokens.
"""
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
from repro.compression import policies as jpol
from repro.compression.base import pool_scores as jpool_scores
from repro.core.planner import plan_kv_dtypes as jplan_kv_dtypes
from repro_torch.api import (CompressionConfig, Engine, EngineConfig, PagingConfig,
                             PlannerConfig, SchedulerConfig, plan_kv_dtypes, select_policy)
from repro_torch.compression import policies as tpol
from tests._hypothesis_compat import given, settings, st
from tests.test_torch_prefix import assert_same_run, drive, requests, shared_params

torch.set_num_threads(2)

ARCH = "minitron-8b"
NEW = ["streaming_llm", "pyramidkv", "h2o", "headkv"]
ALL = NEW + ["snapkv", "ada_snapkv"]


def _comp(**kw):
    base = dict(budget=10, obs_window=4, sink=2, pool=3, decode_margin=4,
                headkv_base_ratio=0.2, pyramid_beta=0.6)
    base.update(kw)
    return JCompression(**base), CompressionConfig(**base)


def _tied_scores(rng, B, H, T, pool=3):
    """Max-pooled scores on a coarse grid: exact ties everywhere."""
    raw = rng.integers(0, 5, size=(B, H, T)).astype(np.float32) / 4
    return np.asarray(jpool_scores(jnp.asarray(raw), pool))


def _both(policy, scores, jc, tc, layer, n_layers, imp=None):
    jkw = {} if imp is None else {"head_importance": jnp.asarray(imp)}
    tkw = {} if imp is None else {"head_importance": torch.as_tensor(imp)}
    ji, jl = jpol.select(policy, jnp.asarray(scores), jc, layer, n_layers, **jkw)
    ti, tl = select_policy(policy, torch.as_tensor(scores.copy()), tc, layer, n_layers, **tkw)
    return (np.asarray(ji), np.asarray(jl)), (ti.numpy(), tl.numpy())


def _assert_same(a, b, what):
    assert np.array_equal(a[0], b[0]), (what, "indices")
    assert np.array_equal(a[1], b[1]), (what, "lengths")


def test_six_policies_registered():
    assert set(ALL) <= set(tpol.POLICIES)
    assert tpol.BALANCED == jpol.BALANCED and tpol.IMBALANCED == jpol.IMBALANCED


@pytest.mark.parametrize("policy", NEW)
def test_policy_matches_reference(policy):
    """Bitwise indices and lengths over 4 layers and 12 seeded score sets
    (prompt lengths below, at and above the budget and the capacity)."""
    for seed in range(12):
        rng = np.random.default_rng(seed)
        T = [7, 10, 23, 41, 64, 90][seed % 6]
        jc, tc = _comp(budget=int(rng.integers(6, 24)))
        scores = _tied_scores(rng, 2, 4, T)
        for layer in range(4):
            a, b = _both(policy, scores, jc, tc, layer, 4)
            _assert_same(a, b, (policy, seed, layer))


def test_headkv_importance_bitwise():
    """Explicit per-head weights: random, tied, one dominant head, all but
    one zero, and a float64 profile (rounded to fp32 in both packages)."""
    rng = np.random.default_rng(5)
    H, L = 4, 3
    weights = [rng.random((L, H)).astype(np.float32),
               np.ones((L, H), np.float32),
               np.asarray([[8, 1, 1, 1]] * L, np.float32),
               np.asarray([[0, 0, 3, 0]] * L, np.float32),
               rng.random((L, H)) * 100]  # float64
    for k, imp in enumerate(weights):
        for T in (12, 30, 77):
            jc, tc = _comp(budget=9, headkv_base_ratio=[0.2, 0.0, 0.5][T % 3])
            scores = _tied_scores(rng, 3, H, T)
            for layer in range(L):
                a, b = _both("headkv", scores, jc, tc, layer, L,
                             imp=np.asarray(imp[layer]))
                _assert_same(a, b, (k, T, layer))


def test_headkv_default_importance_matches_reference():
    """Without ``head_importance`` the weights are the fp32 mean score per
    head; a different summation order could move one head's keep by one at
    an integer edge.  On these seeded scores it does not."""
    for seed in range(20):
        rng = np.random.default_rng(100 + seed)
        jc, tc = _comp(budget=int(rng.integers(4, 40)))
        scores = rng.random((2, 8, int(rng.integers(16, 300)))).astype(np.float32)
        a, b = _both("headkv", scores, jc, tc, 0, 1)
        _assert_same(a, b, seed)


def _chunk_scores(rng, B, H, Ck, valid):
    """Scores as the chunk path hands them to the policy: positions past
    ``valid`` (the padding of a partial last chunk) are ``-inf``."""
    s = rng.random((B, H, Ck)).astype(np.float32)
    s[..., valid:] = -np.inf
    return s


@pytest.mark.parametrize("valid", [3, 8, 10, 13, 15])
def test_h2o_partial_chunk_nan_rule(valid):
    """`h2o` on a partial chunk, where ``-inf + inf`` is NaN: the port's
    rule gives the reference's selection, and no pad outranks a real
    token."""
    rng = np.random.default_rng(valid)
    jc, tc = _comp(budget=8)
    scores = _chunk_scores(rng, 1, 2, 16, valid)
    with np.errstate(invalid="ignore"):
        boosted = scores + np.where(np.arange(16) >= 16 - 4, np.inf, 0.0)
    assert np.isnan(boosted).any() == (valid < 16)
    a, b = _both("h2o", scores, jc, tc, 0, 1)
    _assert_same(a, b, valid)
    kept = b[0][0, :, :8]
    assert (np.sort(kept, axis=-1)[:, :min(8, valid)] < valid).all()


def test_h2o_partial_chunk_at_minitron_shape():
    """minitron-8b's chunk shape (B = 1, Hkv = 8, Ck = 512 < capacity 576,
    so the selection orders all 512 positions) with 300 valid tokens."""
    rng = np.random.default_rng(0)
    jc, tc = _comp(budget=256, obs_window=32, sink=4, pool=7, decode_margin=64)
    scores = _chunk_scores(rng, 1, 8, 512, 300)
    _assert_same(*_both("h2o", scores, jc, tc, 0, 32), "minitron")


def test_h2o_nan_rule_is_sign_independent():
    """A CUDA ``-inf + inf`` is a positive NaN, which a plain descending
    sort would rank first; the rule ranks NaN of either sign as ``-inf``."""
    _, tc = _comp(budget=8)
    s = torch.rand((1, 2, 16))
    s[..., 10:] = float("-inf")
    ref = tpol.h2o(s, tc, 0, 1)
    pos_nan = s.clone()
    pos_nan[..., 12:] = float("nan")  # the recent-window pads, as +NaN
    out = tpol.h2o(pos_nan, tc, 0, 1)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])


# ---------------------------------------------------------------------------
# ROADMAP C.6: the chunk-boundary compression keeps padding positions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["streaming_llm", "snapkv", "h2o"])
def test_partial_chunk_keeps_pad_positions_in_both_packages(policy):
    """A 10-token prompt as one 16-wide chunk.  `streaming_llm`'s recent
    window and `snapkv`'s guaranteed observation window are placed at the
    chunk's last columns, padding included, and the pad keys are appended
    to the cache: both packages retain the same positions, among them
    positions past the prompt.  `h2o`'s recent half is NaN there and ranks
    last, so it keeps no pad.  Open decision for both packages: guarantee
    positions relative to ``valid``, never a pad."""
    import jax.numpy as jnp
    from repro.serving import engine as jserve
    from repro_torch.serving import engine as tserve
    jparams, tparams = shared_params()
    comp = dict(policy=policy, budget=8, alpha_max=2.0, obs_window=4, sink=2, pool=3,
                decode_margin=8)
    jc = JEngineConfig.smoke(ARCH, compression=JCompression(**comp))
    tc = EngineConfig.smoke(ARCH, device="cpu", compression=CompressionConfig(**comp))
    je, te = JEngine.build(jc, params=jparams), Engine.build(tc, params=tparams)
    m, L = jc.model, jc.model.n_layers
    Ck, valid = 16, 10
    chunk = np.zeros((1, Ck), np.int32)
    chunk[0, :valid] = np.random.default_rng(1).integers(1, m.vocab_size, size=valid)
    quota = np.full((L,), 16, np.int32)
    jst = jserve.init_serve_state(m, je.pa, 1, jc.compression, dtype=jnp.float32)
    tst = tserve.init_serve_state(m, te.pa, 1, tc.compression, dtype=torch.float32)
    jst, _, jlen = jserve.prefill_chunk(je.sp, jnp.asarray(chunk), m, je.pa, jc.compression,
                                        jst, jnp.asarray([0]), jnp.asarray([0]),
                                        jnp.asarray([valid]), jnp.asarray(quota))
    with torch.inference_mode():
        tst, _, tlen = te.executor.prefill_chunk(te.sp, chunk, te.pa, tst, [0], [0],
                                                 [valid], quota)
    assert np.array_equal(np.asarray(jlen), tlen.numpy())
    lens = tst.cache.lengths.numpy()
    pos = tst.cache.pos.numpy()
    assert np.array_equal(np.asarray(jst.cache.pos), pos)
    live = np.arange(pos.shape[-1])[None, None, None, :] < lens[..., None]
    kept = pos[live]
    pads = int((kept >= valid).sum())
    if policy == "h2o":
        assert pads == 0
    else:
        assert pads > 0  # the fault: padding positions retained
    if policy == "streaming_llm":  # sinks 0, 1 + the last 6 columns, all pads
        per_pair = np.sort(pos[0, 0, 0, :lens[0, 0, 0]]) if lens[0, 0, 0] else None
        assert per_pair is not None and (per_pair >= valid).sum() == 6


# ---------------------------------------------------------------------------
# admission bounds
# ---------------------------------------------------------------------------


def _threshold_ties(scores: np.ndarray, cfg, H: int) -> np.ndarray:
    """(B,) entries `ada_snapkv`'s pooled allocation counts beyond its pool
    of ``H·budget``: the scores tied with the top-k threshold (ROADMAP C.7)."""
    B, _, T = scores.shape
    pos = np.arange(T)
    boosted = np.where((pos < cfg.sink) | (pos >= T - cfg.obs_window), np.inf, scores)
    flat = boosted.reshape(B, -1)
    k = min(H * cfg.budget, flat.shape[1])
    thresh = -np.sort(-flat, axis=1)[:, k - 1]
    return (flat >= thresh[:, None]).sum(axis=1) - k


@settings(max_examples=60, deadline=None)
@given(policy=st.sampled_from(ALL), T=st.integers(1, 160), budget=st.integers(1, 48),
       sink=st.integers(0, 6), obs=st.integers(1, 12), H=st.integers(1, 6),
       layer=st.integers(0, 5), seed=st.integers(0, 2 ** 16))
def test_layer_keep_bound_holds(policy, T, budget, sink, obs, H, layer, seed):
    """``layer_keep_bound`` ≥ the realized Σ_h keep of every row, in both
    packages alike, and equal to the reference's bound.  One excess is
    allowed, and only for `ada_snapkv`: the scores tied with its pooled
    threshold, all of which it counts (C.7, a fault of both packages,
    pinned by `test_ada_snapkv_threshold_ties_exceed_the_bound`)."""
    rng = np.random.default_rng(seed)
    kw = dict(budget=budget, sink=sink, obs_window=obs, pool=3, decode_margin=4)
    jc, tc = _comp(**kw)
    scores = _tied_scores(rng, 2, H, T)
    imp = rng.random(H).astype(np.float32) if policy == "headkv" and seed % 2 else None
    a, b = _both(policy, scores, jc, tc, layer, 6, imp=imp)
    _assert_same(a, b, policy)
    realized = b[1].sum(axis=1)  # (B,)
    bound = tpol.layer_keep_bound(policy, tc, T, H, layer, 6)
    excess = _threshold_ties(scores, tc, H) if policy == "ada_snapkv" else 0
    assert (realized <= bound + excess).all(), (realized, bound, excess)
    assert bound == jpol.layer_keep_bound(policy, jc, T, H, layer, 6)
    assert (tpol.projected_request_tokens(policy, tc, T, 5, 6, H)
            == jpol.projected_request_tokens(policy, jc, T, 5, 6, H))


def test_ada_snapkv_threshold_ties_exceed_the_bound():
    """ROADMAP C.7, in both packages: `ada_snapkv` keeps every score tied
    with the layer-wide top-``H·budget`` threshold, so on tied (max-pooled)
    scores Σ keep can pass ``layer_keep_bound``'s ``H·(budget + sink +
    obs_window)``.  Four tied scores, budget 2, one guaranteed position:
    the pool is 2 entries, the threshold ties all 4, the bound is 3."""
    jc, tc = _comp(budget=2, sink=0, obs_window=1, pool=1, decode_margin=4)
    scores = np.ones((1, 1, 4), np.float32)
    a, b = _both("ada_snapkv", scores, jc, tc, 0, 1)
    _assert_same(a, b, "ties")
    bound = tpol.layer_keep_bound("ada_snapkv", tc, 4, 1, 0, 1)
    assert bound == jpol.layer_keep_bound("ada_snapkv", jc, 4, 1, 0, 1) == 3
    assert int(a[1].sum()) == int(b[1].sum()) == 4 > bound


def test_balanced_policies_keep_exactly_the_budget():
    """Balanced policies keep ``min(budget_l, T, C)`` per head."""
    _, tc = _comp(budget=12)
    cap = tc.static_capacity()
    rng = np.random.default_rng(3)
    for T in (5, 12, 40, 200):
        scores = torch.as_tensor(_tied_scores(rng, 2, 4, T))
        for policy in sorted(tpol.BALANCED):
            for layer in range(4):
                _, keep = select_policy(policy, scores, tc, layer, 4)
                b = tpol._pyramid_budget(tc, layer, 4) if policy == "pyramidkv" else 12
                assert (keep == min(b, T, cap)).all(), (policy, T, layer)


@pytest.mark.parametrize("low_fraction,base,low", [(0.5, "int8", "fp8"), (0.25, "int8", "fp8"),
                                                   (0.0, "int8", "fp8"), (1.0, "fp8", "int8"),
                                                   (0.5, "int8", "int8")])
def test_plan_kv_dtypes_matches_reference(low_fraction, base, low):
    rng = np.random.default_rng(7)
    profile = np.floor(rng.random((6, 8)) * 4)  # ties between heads
    got = plan_kv_dtypes(profile, base=base, low_dtype=low, low_fraction=low_fraction)
    assert got == jplan_kv_dtypes(profile, base=base, low_dtype=low,
                                  low_fraction=low_fraction)
    if got:
        PagingConfig(kv_dtype=base, kv_dtype_overrides=got)


def test_plan_kv_dtypes_rejects_bad_inputs():
    with pytest.raises(ValueError):
        plan_kv_dtypes(np.ones((2, 2)), base="fp32")
    with pytest.raises(ValueError):
        plan_kv_dtypes(np.ones((2, 2)), low_fraction=1.5)
    with pytest.raises(ValueError):
        plan_kv_dtypes(np.ones(4))


# ---------------------------------------------------------------------------
# the continuous scheduler under headkv and pyramidkv
# ---------------------------------------------------------------------------


def _sched_configs(policy, backend):
    comp = dict(policy=policy, budget=12, alpha_max=2.0, obs_window=8, sink=2,
                decode_margin=8)
    sk = dict(max_rows=2, enable_replan=False, collect_logits=True)
    plan = dict(mode="fairkv_dp", extra_copies=4, batch_cap=2)
    pg = dict(block_size=8)
    j = JEngineConfig.smoke(ARCH, n_shards=4, max_seq_len=64,
                            compression=JCompression(**comp), scheduler=JScheduler(**sk),
                            planner=JPlanner(**plan), cache_backend=backend,
                            paging=JPaging(**pg))
    t = EngineConfig.smoke(ARCH, n_shards=4, max_seq_len=64, device="cpu",
                           compression=CompressionConfig(**comp),
                           scheduler=SchedulerConfig(**sk), planner=PlannerConfig(**plan),
                           cache_backend=backend, paging=PagingConfig(**pg))
    return j, t


@pytest.mark.parametrize("policy,backend", [("headkv", "slot"), ("headkv", "paged"),
                                            ("pyramidkv", "slot"), ("pyramidkv", "paged")])
def test_scheduler_matches_reference(policy, backend):
    """A 5-request trace next to the JAX engine, tick by tick (lengths,
    rows, queue), then the same tokens and logits within 1e-4; `headkv`
    with per-head importance from a seeded (L, H) profile."""
    jparams, tparams = shared_params()
    jc, tc = _sched_configs(policy, backend)
    m = tc.model
    imp = None
    if policy == "headkv":
        imp = np.random.default_rng(9).random((m.n_layers, m.n_kv_heads)) + 0.1
    je = JEngine.build(jc, params=jparams, head_importance=imp)
    te = Engine.build(tc, params=tparams, head_importance=imp)
    rng = np.random.default_rng(4)
    specs = [(i, rng.integers(1, m.vocab_size, size=int(rng.integers(12, 30))), a, 5)
             for i, a in enumerate([0, 0, 1, 3, 4])]
    jr, tr = requests(specs, True), requests(specs, False)
    run = dict(je=je, te=te, jr=jr, tr=tr, js=drive(je, jr, True), ts=drive(te, tr, False))
    assert_same_run(run)
    admitted = [s["active"] for s in run["ts"]]
    assert len({tuple(a) for a in admitted}) > 1
