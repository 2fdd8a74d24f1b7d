"""The port's modules against the JAX reference, module by module.

Inputs are made with numpy from a seed and fed to both packages.  Layers
hold to 1e-5 (fp32); compression selections, the slot-cache fill/append and
the plan arrays must be identical (bitwise).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache import slot_cache as jsc
from repro.compression import base as jcb
from repro.compression import policies as jpol
from repro.configs import get_smoke_config as jget_smoke
from repro.core import PlannerConfig as JPlannerConfig
from repro.core import build_plan as jbuild_plan
from repro.models import layers as jL
from repro_torch import interop
from repro_torch.cache import slot_cache as tsc
from repro_torch.compression import base as tcb
from repro_torch.compression import policies as tpol
from repro_torch.core import PlannerConfig as TPlannerConfig
from repro_torch.core import build_plan as tbuild_plan
from repro_torch.core import synthetic_profile
from repro_torch.models import layers as tL
from repro_torch.training.data import SyntheticLM
from repro_torch.configs import InputShape, get_smoke_config
from tests._hypothesis_compat import given, settings, st

torch.set_num_threads(2)
TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_rms_norm_and_rope():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    pos = rng.integers(0, 500, size=(2, 5)).astype(np.int32)
    np.testing.assert_allclose(_n(tL.rms_norm(_t(x), _t(scale), 1e-6)),
                               np.asarray(jL.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)),
                               atol=TOL)
    np.testing.assert_allclose(_n(tL.apply_rope(_t(x), _t(pos), 10_000.0)),
                               np.asarray(jL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)),
                               atol=TOL)


@pytest.mark.parametrize("window,cap,masked", [(0, 0.0, False), (5, 0.0, False),
                                                (0, 30.0, True), (7, 20.0, True)])
def test_dense_attention(window, cap, masked):
    rng = np.random.default_rng(window + int(cap))
    B, Q, Hq, Hkv, Dh = 2, 12, 4, 2, 16
    q = rng.normal(size=(B, Q, Hq, Dh)).astype(np.float32)
    k = rng.normal(size=(B, Q, Hkv, Dh)).astype(np.float32)
    v = rng.normal(size=(B, Q, Hkv, Dh)).astype(np.float32)
    pos = np.broadcast_to(np.arange(Q, dtype=np.int32), (B, Q)).copy()
    kvm = rng.random((B, Q)) < 0.7 if masked else None
    out = tL.dense_attention(_t(q), _t(k), _t(v), _t(pos), _t(pos), window=window,
                             attn_cap=cap, kv_mask=None if kvm is None else _t(kvm))
    ref = jL.dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(pos), jnp.asarray(pos), window=window,
                             attn_cap=cap,
                             kv_mask=None if kvm is None else jnp.asarray(kvm))
    np.testing.assert_allclose(_n(out), np.asarray(ref), atol=TOL)


@pytest.mark.parametrize("K,chunk,window", [(40, 16, 0), (48, 16, 9), (33, 64, 0)])
def test_flash_attention_forward(K, chunk, window):
    rng = np.random.default_rng(K)
    B, Hq, Hkv, Dh = 2, 4, 2, 16
    q = rng.normal(size=(B, K, Hq, Dh)).astype(np.float32)
    k = rng.normal(size=(B, K, Hkv, Dh)).astype(np.float32)
    v = rng.normal(size=(B, K, Hkv, Dh)).astype(np.float32)
    pos = np.broadcast_to(np.arange(K, dtype=np.int32), (B, K)).copy()
    out = tL.flash_attention(_t(q), _t(k), _t(v), _t(pos), _t(pos), window=window,
                             attn_cap=25.0, chunk=chunk)
    jargs = [jnp.asarray(a) for a in (q, k, v, pos, pos)]
    ref = jL.flash_attention_vjp(*jargs, window, 25.0, True, chunk)
    dense = jL.dense_attention(*jargs, window=window, attn_cap=25.0)
    np.testing.assert_allclose(_n(out), np.asarray(ref), atol=TOL)
    np.testing.assert_allclose(_n(out), np.asarray(dense), atol=TOL)


def test_attention_dispatch_uses_flash_past_threshold():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(1, 20, 2, 8)).astype(np.float32)
    kv = rng.normal(size=(1, 20, 1, 8)).astype(np.float32)
    pos = np.arange(20, dtype=np.int32)[None]
    out = tL.attention(_t(q), _t(kv), _t(kv), _t(pos), _t(pos), flash_threshold=8, chunk=8)
    ref = jL.attention(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv), jnp.asarray(pos),
                       jnp.asarray(pos), flash_threshold=8, chunk=8)
    np.testing.assert_allclose(_n(out), np.asarray(ref), atol=TOL)


def test_swiglu_embed_unembed():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 3, 16)).astype(np.float32)
    w1, w3 = (rng.normal(size=(16, 32)).astype(np.float32) for _ in range(2))
    w2 = rng.normal(size=(32, 16)).astype(np.float32)
    table = rng.normal(size=(50, 16)).astype(np.float32)
    toks = rng.integers(0, 50, size=(2, 3))
    np.testing.assert_allclose(
        _n(tL.swiglu(_t(x), _t(w1), _t(w3), _t(w2))),
        np.asarray(jL.swiglu(*(jnp.asarray(a) for a in (x, w1, w3, w2)))), atol=1e-4)
    assert np.array_equal(_n(tL.embed(_t(toks), _t(table))),
                          np.asarray(jL.embed(jnp.asarray(toks), jnp.asarray(table))))
    np.testing.assert_allclose(
        _n(tL.unembed(_t(x), _t(table), 10.0)),
        np.asarray(jL.unembed(jnp.asarray(x), jnp.asarray(table), 10.0)), atol=TOL)


# ---------------------------------------------------------------------------
# compression: identical selections, ties included
# ---------------------------------------------------------------------------


def _selection_pair(scores, ccfg_kw, policy="ada_snapkv"):
    jc = jcb.CompressionConfig(policy=policy, **ccfg_kw)
    tc = tcb.CompressionConfig(policy=policy, **ccfg_kw)
    jidx, jkeep = jpol.select(policy, jnp.asarray(scores), jc, 0, 2)
    tidx, tkeep = tpol.select(policy, _t(scores), tc, 0, 2)
    return (np.asarray(jidx), np.asarray(jkeep)), (_n(tidx), _n(tkeep))


@pytest.mark.parametrize("policy", ["ada_snapkv", "snapkv"])
@pytest.mark.parametrize("ties", [False, True])
def test_selection_identical(policy, ties):
    rng = np.random.default_rng(11)
    B, H, T = 3, 4, 80
    raw = (rng.integers(0, 5, size=(B, H, T)).astype(np.float32) if ties
           else rng.random((B, H, T)).astype(np.float32))
    pooled_j = np.asarray(jcb.pool_scores(jnp.asarray(raw), 7))
    pooled_t = _n(tcb.pool_scores(_t(raw), 7))
    assert np.array_equal(pooled_j, pooled_t)
    kw = dict(budget=12, alpha_max=2.0, obs_window=6, sink=3, decode_margin=4)
    (ji, jk), (ti, tk) = _selection_pair(pooled_j, kw, policy)
    assert np.array_equal(jk, tk)
    assert np.array_equal(ji, ti)


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 10_000), st.integers(1, 4), st.integers(3, 9))
def test_topk_select_tie_order_matches_lax_top_k(seed, levels, cap):
    """Exact ties everywhere (few distinct values): the port's stable sort
    must pick the same indices as jax.lax.top_k (lower index first)."""
    rng = np.random.default_rng(seed)
    scores = rng.integers(0, levels, size=(2, 3, 17)).astype(np.float32)
    scores[..., :2] = np.inf  # guaranteed positions tie at +inf
    keep = rng.integers(1, cap + 1, size=(2, 3)).astype(np.int32)
    ji, jk = jcb.topk_select(jnp.asarray(scores), jnp.asarray(keep), cap)
    ti, tk = tcb.topk_select(_t(scores), _t(keep), cap)
    assert np.array_equal(np.asarray(ji), _n(ti))
    assert np.array_equal(np.asarray(jk), _n(tk))


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,ch", [("sha", 0), ("fairkv_nodp", 0), ("fairkv_dp", 4)])
@pytest.mark.parametrize("skew,n_heads,n_shards,slots", [
    (1.0, 2, 8, None), (0.5, 8, 8, 2), (1.5, 8, 4, None)])
def test_build_plan_identical(mode, ch, skew, n_heads, n_shards, slots):
    prof = synthetic_profile(3, n_heads, budget=64, skew=skew, seed=7)
    jp = jbuild_plan(prof, n_shards, JPlannerConfig(mode=mode, extra_copies=ch,
                                                    slots_per_shard=slots, batch_cap=8))
    tp = tbuild_plan(prof, n_shards, TPlannerConfig(mode=mode, extra_copies=ch,
                                                    slots_per_shard=slots, batch_cap=8))
    ja, ta = jp.as_arrays(), tp.as_arrays()
    assert ja.keys() == ta.keys()
    for key in ja:
        assert np.array_equal(ja[key], ta[key]), key
    assert jp.efficiency(prof) == tp.efficiency(prof)
    # runtime arrays and the strided owner rule
    jpa, tpa = jsc.PlanArrays.from_plan(jp), tsc.PlanArrays.from_plan(tp)
    for f in ("slot_head", "replica_idx", "replica_count", "first_slot"):
        assert np.array_equal(np.asarray(getattr(jpa, f)), _n(getattr(tpa, f))), f
    for layer in range(3):
        assert np.array_equal(np.asarray(jpa.owner_mask(layer, 8)),
                              _n(tpa.owner_mask(layer, 8)))
        rows = np.array([5, 2, 7], np.int32)
        assert np.array_equal(np.asarray(jpa.owner_mask_rows(layer, jnp.asarray(rows))),
                              _n(tpa.owner_mask_rows(layer, _t(rows))))


# ---------------------------------------------------------------------------
# slot cache: fill + append, bitwise against both reference append modes
# ---------------------------------------------------------------------------


def _plan_pair(n_heads=2, n_shards=4, mode="fairkv_dp"):
    prof = synthetic_profile(2, n_heads, budget=16, skew=1.0, seed=3)
    cfg = dict(mode=mode, extra_copies=2, batch_cap=4)
    jp = jbuild_plan(prof, n_shards, JPlannerConfig(**cfg))
    tp = tbuild_plan(prof, n_shards, TPlannerConfig(**cfg))
    return jsc.PlanArrays.from_plan(jp), tsc.PlanArrays.from_plan(tp)


def _cache_np(c):
    return {f: np.asarray(getattr(c, f)) if not isinstance(getattr(c, f), torch.Tensor)
            else _n(getattr(c, f)) for f in ("k", "v", "lengths", "pos", "positions")}


@pytest.mark.parametrize("mode", ["onehot", "scatter"])
def test_fill_and_append_bitwise(mode):
    jpa, tpa = _plan_pair()
    rng = np.random.default_rng(5)
    L_, S = 2, int(jpa.slot_head.shape[1])
    B, T, H, Dh, C, Csel = 4, 20, 2, 8, 10, 6
    jc = jsc.init_cache(L_, S, B, C, Dh, dtype=jnp.float32)
    tc = tsc.init_cache(L_, S, B, C, Dh, dtype=torch.float32)
    for layer in range(L_):
        kf = rng.normal(size=(B, T, H, Dh)).astype(np.float32)
        vf = rng.normal(size=(B, T, H, Dh)).astype(np.float32)
        idx = np.sort(rng.permuted(np.tile(np.arange(T), (B, H, 1)), axis=-1)[..., :Csel],
                      axis=-1).astype(np.int32)
        keep = rng.integers(1, Csel + 1, size=(B, H)).astype(np.int32)
        jc = jsc.fill_from_selection(jc, layer, jnp.asarray(kf), jnp.asarray(vf),
                                     jnp.asarray(idx), jnp.asarray(keep), jpa)
        tsc.fill_from_selection(tc, layer, _t(kf), _t(vf), _t(idx), _t(keep), tpa)
    jc = jsc.SlotCache(k=jc.k, v=jc.v, lengths=jc.lengths, pos=jc.pos,
                       positions=jnp.full((B,), T, jnp.int32))
    tc.positions.fill_(T)
    for f, a in _cache_np(jc).items():
        assert np.array_equal(a, _cache_np(tc)[f]), f
    # enough appends to fill every row and wrap the recency ring twice
    ring = 3
    for step in range(C + 2 * ring):
        for layer in range(L_):
            kn = rng.normal(size=(S, B, Dh)).astype(np.float32)
            vn = rng.normal(size=(S, B, Dh)).astype(np.float32)
            jown = jpa.owner_mask(layer, B)
            jc = jsc.append_token(jc, layer, jnp.asarray(kn), jnp.asarray(vn), jown,
                                  jnp.int32(step), ring=ring, mode=mode)
            tsc.append_token(tc, layer, _t(kn), _t(vn), tpa.owner_mask(layer, B),
                             step, ring=ring)
        jc = jsc.SlotCache(k=jc.k, v=jc.v, lengths=jc.lengths, pos=jc.pos,
                           positions=jc.positions + 1)
        tc.positions += 1
        for f, a in _cache_np(jc).items():
            assert np.array_equal(a, _cache_np(tc)[f]), (step, f)
    # the §2 ownership rule: unowned pairs never gained length
    own = np.stack([_n(tpa.owner_mask(layer, B)) for layer in range(L_)])
    assert (_n(tc.lengths)[~own] == 0).all()
    assert (_n(tc.lengths)[own] == C).all()


def test_init_serve_state_matches_reference():
    from repro.serving.engine import init_serve_state as jinit
    from repro_torch.serving.engine import init_serve_state as tinit
    jpa, tpa = _plan_pair()
    jcfg, tcfg = jget_smoke("minitron-8b"), get_smoke_config("minitron-8b")
    ccfg = dict(budget=8, obs_window=4, sink=2, decode_margin=4)
    js = jinit(jcfg, jpa, 3, jcb.CompressionConfig(**ccfg))
    ts = tinit(tcfg, tpa, 3, tcb.CompressionConfig(**ccfg))
    for f, a in _cache_np(js.cache).items():
        assert np.array_equal(a, _cache_np(ts.cache)[f]), f
    assert np.array_equal(np.asarray(js.last_tokens), _n(ts.last_tokens))
    assert int(js.decode_steps) == ts.decode_steps == 0


# ---------------------------------------------------------------------------
# interop, data
# ---------------------------------------------------------------------------


def test_interop_roundtrip_bf16_bitwise():
    rng = np.random.default_rng(9)
    tree = {"a": jnp.asarray(rng.normal(size=(3, 4)), jnp.bfloat16),
            "b": [jnp.asarray(rng.normal(size=(5,)), jnp.float32),
                  jnp.asarray(rng.integers(0, 9, size=(2,)), jnp.int32)]}
    npt = jax.tree.map(np.asarray, tree)
    tt = interop.to_torch(npt)
    assert tt["a"].dtype == torch.bfloat16 and tt["b"][0].dtype == torch.float32
    assert np.array_equal(tt["a"].float().numpy(), np.asarray(tree["a"], np.float32))
    back = interop.to_numpy(tt)
    assert back["a"].dtype == npt["a"].dtype
    assert np.array_equal(back["a"].view(np.uint16), npt["a"].view(np.uint16))
    assert np.array_equal(back["b"][1], npt["b"][1])


def test_synthetic_lm_deterministic():
    cfg = get_smoke_config("minitron-8b")
    data = SyntheticLM(cfg, InputShape("t", 64, 3, "prefill"))
    a, b = data.get_batch(4)["tokens"], data.get_batch(4)["tokens"]
    assert a.shape == (3, 64) and a.dtype == np.int32
    assert np.array_equal(a, b) and not np.array_equal(a, data.get_batch(5)["tokens"])
    assert a.min() >= 0 and a.max() < cfg.vocab_size
    assert jget_smoke("minitron-8b").vocab_size == cfg.vocab_size
