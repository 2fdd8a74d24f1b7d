"""The port's paged backend pieces against the JAX package, on the CPU.

Same numpy inputs through ``repro.paging`` and ``repro_torch.paging``:
the int8/fp8 codec (codes and scales bitwise), `BlockPool` (ids, free
lists, refcounts), `build_table`, `paginate_rows`, `paged_append_token`
(plain and quantize-on-write, recency ring included), `release_rows` and
`paged_to_slot` — tables, codes, scales and pool contents bitwise.  Then
the port against itself, mirroring the reference's own paging tests:
paged decode equals slot decode bit for bit, paged appends equal slot
appends, the scale of a recycled block is reset before its first
quantize-on-write append, and fp8 NaN codes decode to 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache.slot_cache import SlotCache as JSlotCache
from repro.paging import block_pool as jbp
from repro.paging import kvquant as jkv
from repro.paging import paged_cache as jpc
from repro_torch.cache.slot_cache import SlotCache, append_token
from repro_torch.kernels.ref import fairkv_decode_ref, paged_fairkv_decode_ref
from repro_torch.paging import block_pool as tbp
from repro_torch.paging import kvquant as tkv
from repro_torch.paging import paged_cache as tpc

from tests._hypothesis_compat import given, settings, st

torch.set_num_threads(2)


def _np(t):
    return t.numpy() if torch.is_tensor(t) else np.asarray(t)


def _random_slot(rng, L, S, B, C, Dh):
    """Random slot-layout contents with ragged lengths: an unowned slot
    (length 0) and, when S > 1, a full one (length C)."""
    k = rng.normal(size=(L, S, B, C, Dh)).astype(np.float32)
    v = rng.normal(size=(L, S, B, C, Dh)).astype(np.float32)
    lengths = rng.integers(0, C + 1, size=(L, S, B)).astype(np.int32)
    lengths[:, 0] = 0
    if S > 1:
        lengths[:, 1] = C
    pos = np.broadcast_to(np.arange(C, dtype=np.int32), (L, S, B, C)).copy()
    pos[lengths[..., None] <= np.arange(C)] = -1
    positions = np.full((B,), C, np.int32)
    j = JSlotCache(k=jnp.asarray(k), v=jnp.asarray(v), lengths=jnp.asarray(lengths),
                   pos=jnp.asarray(pos), positions=jnp.asarray(positions))
    t = SlotCache(k=torch.from_numpy(k), v=torch.from_numpy(v),
                  lengths=torch.from_numpy(lengths), pos=torch.from_numpy(pos),
                  positions=torch.from_numpy(positions))
    return j, t


def _kinds(mode, L, S):
    if mode == "fp32":
        return None, None
    k = {"int8": np.zeros((L, S)), "fp8": np.ones((L, S)),
         "mixed": np.broadcast_to(np.arange(S) % 2, (L, S))}[mode].astype(np.int32)
    return tkv.KVQuantSpec(base="int8" if mode == "int8" else "fp8"), k


def _paged_pair(rng, mode, L=2, S=4, B=3, C=20, Dh=8, bs=8, extra=0):
    """The same random slot cache paginated by both packages."""
    jslot, tslot = _random_slot(rng, L, S, B, C, Dh)
    spec, kinds = _kinds(mode, L, S)
    jspec = None if spec is None else jkv.KVQuantSpec(base=spec.base)
    M = tpc.max_blocks_per_row(C, bs)
    lens = np.asarray(jslot.lengths)
    alloc_for = np.minimum(lens + extra, C)
    own = lens > 0
    jc, jpool = jpc.init_paged_cache(L, S, B, C, Dh, jbp.PagingConfig(block_size=bs),
                                     dtype=jnp.float32, kv_quant=jspec)
    tc, tpool = tpc.init_paged_cache(L, S, B, C, Dh, tbp.PagingConfig(block_size=bs),
                                     dtype=torch.float32, kv_quant=spec)
    jt = jpc.build_table(alloc_for, jpool, bs, M, own=own)
    tt = tpc.build_table(alloc_for, tpool, bs, M, own=own)
    assert np.array_equal(jt, tt)
    jc = jpc.paginate_rows(jc, jslot, jnp.arange(B, dtype=jnp.int32), jt,
                           kinds=None if kinds is None else jnp.asarray(kinds))
    tpc.paginate_rows(tc, tslot, np.arange(B), tt, kinds=kinds)
    return (jslot, jc, jpool), (tslot, tc, tpool), kinds


def _assert_cache_equal(jc, tc):
    """Bitwise equality of every field; block 0 of layer 0 is excluded from
    the pools (the null block takes the redirected writes, whose order is
    unspecified)."""
    for name in ("block_table", "lengths", "positions"):
        assert np.array_equal(np.asarray(getattr(jc, name)), _np(getattr(tc, name))), name
    for name in ("k_pool", "v_pool", "pos_pool"):
        a, b = np.asarray(getattr(jc, name)), _np(getattr(tc, name))
        assert np.array_equal(a[1:], b[1:]) and np.array_equal(a[0, 1:], b[0, 1:]), name
    for name in ("k_scale", "v_scale"):
        a, b = getattr(jc, name), getattr(tc, name)
        assert (a is None) == (b is None), name
        if a is not None:
            a, b = np.asarray(a), _np(b)
            assert np.array_equal(a[:, 1:], b[:, 1:]) and np.array_equal(a[1:], b[1:]), name


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", [tkv.KIND_INT8, tkv.KIND_FP8])
def test_encode_decode_bitwise(kind):
    rng = np.random.default_rng(3 + kind)
    x = (rng.normal(size=(6, 8, 16)) * rng.uniform(0.01, 100, size=(6, 1, 1))
         ).astype(np.float32)
    x[0, 0, :4] = [0.5, -0.5, 1.5, 2.5]  # halves: round to even in both
    scale = (np.abs(x).max(axis=(1, 2)) / (448.0 if kind else 127.0)).astype(np.float32)
    scale[1] = 0.0  # empty block: everything encodes to 0
    jcodes = np.asarray(jkv.encode(jnp.asarray(x), jnp.asarray(scale)[:, None, None], kind))
    tcodes = tkv.encode(torch.from_numpy(x), torch.from_numpy(scale)[:, None, None], kind)
    assert np.array_equal(jcodes, tcodes.numpy())
    jdec = np.asarray(jkv.decode(jnp.asarray(jcodes), jnp.asarray(scale)[:, None, None], kind))
    tdec = tkv.decode(tcodes, torch.from_numpy(scale)[:, None, None], kind)
    assert np.array_equal(jdec, tdec.numpy())


@pytest.mark.parametrize("mode", ["int8", "fp8", "mixed"])
def test_quantize_blocks_bitwise(mode):
    rng = np.random.default_rng(11)
    L, S, B, C, Dh, bs = 2, 4, 3, 24, 8, 8
    jslot, tslot = _random_slot(rng, L, S, B, C, Dh)
    _, kinds = _kinds(mode, L, S)
    jc, js = jkv.quantize_blocks(jslot.k, jslot.pos, bs, jnp.asarray(kinds)[:, :, None, None])
    tc, ts = tkv.quantize_blocks(tslot.k, tslot.pos, bs, torch.from_numpy(kinds)[:, :, None, None])
    assert np.array_equal(np.asarray(jc), tc.numpy())
    assert np.array_equal(np.asarray(js), ts.numpy())
    je = jkv.roundtrip_error(jslot.k, jslot.pos, bs, jnp.asarray(kinds)[:, :, None, None])
    te = tkv.roundtrip_error(tslot.k, tslot.pos, bs, torch.from_numpy(kinds)[:, :, None, None])
    assert te == pytest.approx(je, rel=1e-5)


def test_fp8_nan_codes_decode_to_zero():
    """Every fp8 NaN pattern (0x7F, 0xFF) decodes to 0 in the codec and in
    the kernel oracle's dequant, as in the reference."""
    codes = np.asarray([0x7F, -1, 0x38, 0], np.int8)  # NaN, NaN, 1.0, 0
    scale = np.float32(2.0)
    j = np.asarray(jkv.decode(jnp.asarray(codes), scale, jkv.KIND_FP8))
    t = tkv.decode(torch.from_numpy(codes), torch.tensor(scale), tkv.KIND_FP8).numpy()
    from repro_torch.kernels.ref import dequant_block_codes
    o = dequant_block_codes(torch.from_numpy(codes), torch.tensor(scale), 1).numpy()
    assert np.array_equal(t, [0.0, 0.0, 2.0, 0.0])
    assert np.array_equal(j, t) and np.array_equal(o, t)


def test_interop_carries_int8_and_fp8_leaves():
    """Quantized pool leaves cross between the packages bit for bit: int8
    codes as they are, fp8-e4m3 values through an 8-bit view."""
    from repro_torch import interop
    rng = np.random.default_rng(2)
    codes = jnp.asarray(rng.integers(-128, 128, size=(3, 4, 8)), jnp.int8)
    f8 = jnp.asarray(rng.normal(size=(3, 4, 8)) * 10, jnp.float32).astype(jnp.float8_e4m3fn)
    t = interop.to_torch({"codes": codes, "fp8": [f8]})
    assert t["codes"].dtype == torch.int8 and t["fp8"][0].dtype == torch.float8_e4m3fn
    assert np.array_equal(t["codes"].numpy(), np.asarray(codes))
    assert np.array_equal(t["fp8"][0].float().numpy(), np.asarray(f8.astype(jnp.float32)))
    back = interop.to_numpy(t)
    assert back["fp8"][0].dtype == np.asarray(f8).dtype
    assert np.array_equal(back["fp8"][0].view(np.int8), np.asarray(f8).view(np.int8))
    assert np.array_equal(back["codes"], np.asarray(codes))


def test_spec_grid_and_slot_kinds_match_reference():
    ov = {(0, 1): "fp8", (1, 0): "int8"}
    tcfg = tbp.PagingConfig(kv_dtype="int8", kv_dtype_overrides=ov)
    jcfg = jbp.PagingConfig(kv_dtype="int8", kv_dtype_overrides=ov)
    assert tcfg.kv_dtype_overrides == jcfg.kv_dtype_overrides
    tg = tkv.kind_grid(tkv.spec_from_paging(tcfg), 2, 4)
    jg = jkv.kind_grid(jkv.spec_from_paging(jcfg), 2, 4)
    assert np.array_equal(tg, jg)
    sh = np.asarray([[0, 1, -1, 3, 2], [3, 2, 1, 0, -1]], np.int32)
    assert np.array_equal(tkv.slot_kinds(tg, sh), jkv.slot_kinds(jg, sh))
    assert tkv.spec_from_paging(tbp.PagingConfig()) is None


@pytest.mark.parametrize("kw,match", [
    (dict(block_size=0), "block_size"), (dict(n_blocks=-1), "n_blocks"),
    (dict(kv_dtype="int4"), "kv_dtype"),
    (dict(kv_dtype_overrides={(0, 0): "fp8"}), "quantized base"),
    (dict(kv_dtype="int8", kv_dtype_overrides={(0, 0): "bf16"}), "must be one of"),
    (dict(n_blocks=8, pool_hbm_bytes=1024), "mutually exclusive")])
def test_paging_config_validation_matches_reference(kw, match):
    with pytest.raises(ValueError, match=match):
        tbp.PagingConfig(**kw)
    with pytest.raises(ValueError, match=match):
        jbp.PagingConfig(**kw)
    assert not hasattr(tbp.PagingConfig(), "decode_impl")


# ---------------------------------------------------------------------------
# allocator
# ---------------------------------------------------------------------------


def test_block_pool_sequence_matches_reference():
    """A random alloc/free sequence hands out the same ids in the same
    order and leaves the same free lists and refcounts."""
    rng = np.random.default_rng(5)
    j, t = jbp.BlockPool(3, 24), tbp.BlockPool(3, 24)
    held = {0: [], 1: [], 2: []}
    peak = 0  # most blocks one layer held at once
    for _ in range(60):
        layer = int(rng.integers(3))
        if held[layer] and rng.random() < 0.45:
            k = int(rng.integers(1, len(held[layer]) + 1))
            drop = [held[layer].pop(int(rng.integers(len(held[layer])))) for _ in range(k)]
            j.decref(layer, drop)
            t.decref(layer, drop)
            continue
        n = int(rng.integers(1, 6))
        try:
            a = j.alloc(layer, n)
        except jbp.PoolExhausted:
            with pytest.raises(tbp.PoolExhausted):
                t.alloc(layer, n)
            continue
        assert t.alloc(layer, n) == a
        held[layer] += a
        peak = max(peak, max(len(h) for h in held.values()))
    assert np.array_equal(j.refcount, t.refcount)
    assert [fl[0] for fl in j._free] == t._free
    assert j.blocks_in_use() == t.blocks_in_use()
    assert t.peak_in_use == peak > 0
    t.check_invariants()
    with pytest.raises(ValueError, match="double free"):
        t.decref(0, [next(b for b in range(1, 24) if t.refcount[0, b] == 0)])
    with pytest.raises(ValueError, match="null block"):
        t.decref(0, [0])


def test_build_table_rolls_back_on_exhaustion():
    pool = tbp.BlockPool(2, 4)
    lengths = np.full((2, 1, 1), 10)  # 3 blocks per layer at bs 4
    pool.alloc(1, 2)  # layer 1 keeps 1 free
    with pytest.raises(tbp.PoolExhausted):
        tpc.build_table(lengths, pool, 4, 3)
    assert pool.free_blocks(0) == 3
    pool.check_invariants()


# ---------------------------------------------------------------------------
# cache ops: port vs reference, bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["fp32", "int8", "fp8", "mixed"])
def test_paginate_rows_bitwise(mode):
    rng = np.random.default_rng(21)
    (jslot, jc, jpool), (tslot, tc, tpool), kinds = _paged_pair(rng, mode)
    _assert_cache_equal(jc, tc)
    assert jpool.blocks_in_use() == tpool.blocks_in_use() > 0
    jback = jpc.paged_to_slot(jc, 20, kinds=None if kinds is None else jnp.asarray(kinds))
    tback = tpc.paged_to_slot(tc, 20, kinds=kinds)
    for name in ("k", "v", "lengths", "pos", "positions"):
        assert np.array_equal(np.asarray(getattr(jback, name)), _np(getattr(tback, name))), name
    if mode == "fp32":  # unquantized: the round trip is exact on valid entries
        valid = (np.arange(20) < np.asarray(jslot.lengths)[..., None])[..., None]
        assert np.array_equal(np.where(valid, np.asarray(jslot.k), 0), tback.k.numpy())


@pytest.mark.parametrize("mode", ["fp32", "int8", "fp8", "mixed"])
def test_paged_append_bitwise(mode):
    """Appends, the recency ring on full rows included, write the same
    pools, positions, scales and lengths as the reference."""
    rng = np.random.default_rng(31)
    steps, C, ring = 6, 20, 5
    (_, jc, _), (_, tc, _), kinds = _paged_pair(rng, mode, extra=steps)
    own = np.asarray(jc.lengths[0]) > 0
    for t in range(steps):
        k_new = rng.normal(size=(4, 3, 8)).astype(np.float32) * (1 + 5 * (t % 2))
        v_new = rng.normal(size=(4, 3, 8)).astype(np.float32)
        kl = None if kinds is None else kinds[0]
        jc = jpc.paged_append_token(jc, 0, jnp.asarray(k_new), jnp.asarray(v_new),
                                    jnp.asarray(own), jnp.int32(t), C, ring=ring,
                                    kinds=None if kl is None else jnp.asarray(kl))
        tpc.paged_append_token(tc, 0, torch.from_numpy(k_new), torch.from_numpy(v_new),
                               torch.from_numpy(own), t, C, ring=ring,
                               kinds=None if kl is None else torch.from_numpy(kl))
        jc.positions = jc.positions + 1
        tc.positions += 1
    _assert_cache_equal(jc, tc)


def test_release_rows_bitwise():
    rng = np.random.default_rng(41)
    (_, jc, _), (_, tc, _), _ = _paged_pair(rng, "int8")
    jc = jpc.release_rows(jc, jnp.asarray([0, 2], jnp.int32))
    tpc.release_rows(tc, [0, 2])
    _assert_cache_equal(jc, tc)
    assert int(tc.lengths[:, :, [0, 2]].sum()) == 0


# ---------------------------------------------------------------------------
# the port against itself: paged == slot (mirrors tests/test_paging.py)
# ---------------------------------------------------------------------------


@settings(max_examples=12, deadline=None)
@given(S=st.integers(2, 5), B=st.integers(1, 4), G=st.integers(1, 4),
       C=st.integers(5, 40), bs=st.integers(2, 16), seed=st.integers(0, 10))
def test_paged_decode_parity_bitwise(S, B, G, C, bs, seed):
    """Paged decode equals slot decode bit for bit over random placements,
    lengths, capacities and block sizes, with and without a window."""
    rng = np.random.default_rng(seed)
    _, slot = _random_slot(rng, 1, S, B, C, 8)
    paged, pool = tpc.init_paged_cache(1, S, B, C, 8, tbp.PagingConfig(block_size=bs),
                                       dtype=torch.float32)
    lens = slot.lengths.numpy()
    table = tpc.build_table(lens, pool, bs, tpc.max_blocks_per_row(C, bs), own=lens > 0)
    tpc.paginate_rows(paged, slot, np.arange(B), table)
    q = torch.from_numpy(rng.normal(size=(B, S, G, 8)).astype(np.float32))
    qpos = torch.full((B,), C + 3, dtype=torch.int32)
    for window in (0, max(2, C // 2)):
        ref = fairkv_decode_ref(q, slot.k[0], slot.v[0], slot.lengths[0],
                                k_pos=slot.pos[0], q_pos=qpos, window=window)
        out = paged_fairkv_decode_ref(q, paged.k_pool[0], paged.v_pool[0],
                                      paged.pos_pool[0], paged.block_table[0],
                                      paged.lengths[0], C, q_pos=qpos, window=window)
        assert torch.equal(ref, out), f"parity broke at window={window}"


@settings(max_examples=8, deadline=None)
@given(S=st.integers(2, 4), B=st.integers(1, 3), C=st.integers(6, 24),
       bs=st.integers(2, 8), steps=st.integers(1, 6), seed=st.integers(0, 10))
def test_paged_append_parity(S, B, C, bs, steps, seed):
    """Appends (ring overwrites on full rows included) leave the same
    lengths and the same valid-prefix contents as the slot cache."""
    rng = np.random.default_rng(100 + seed)
    ring = max(1, C // 3)
    _, slot = _random_slot(rng, 1, S, B, C, 4)
    paged, pool = tpc.init_paged_cache(1, S, B, C, 4, tbp.PagingConfig(block_size=bs),
                                       dtype=torch.float32)
    lens = slot.lengths.numpy()
    table = tpc.build_table(np.minimum(lens + steps, C), pool, bs,
                            tpc.max_blocks_per_row(C, bs), own=lens > 0)
    tpc.paginate_rows(paged, slot, np.arange(B), table)
    own = slot.lengths[0] > 0
    for t in range(steps):
        k_new = torch.from_numpy(rng.normal(size=(S, B, 4)).astype(np.float32))
        v_new = torch.from_numpy(rng.normal(size=(S, B, 4)).astype(np.float32))
        append_token(slot, 0, k_new, v_new, own, t, ring=ring)
        tpc.paged_append_token(paged, 0, k_new, v_new, own, t, C, ring=ring)
    assert torch.equal(slot.lengths, paged.lengths)
    back = tpc.paged_to_slot(paged, C)
    valid = torch.arange(C) < slot.lengths[..., None]
    assert torch.equal(torch.where(valid[..., None], slot.k, 0), back.k)
    assert torch.equal(torch.where(valid[..., None], slot.v, 0), back.v)
    assert torch.equal(torch.where(valid, slot.pos, -1), back.pos)


# ---------------------------------------------------------------------------
# stale scales on a recycled pool
# ---------------------------------------------------------------------------


def test_recycled_block_scale_reset_before_append():
    """A block freed by one request keeps its (large) scale in the pool.
    When `prepare_decode` hands it to another row as a growth block, the
    scale must be reset, or the running-max scale of the first append
    would inherit it and flush the new, small token to code 0.  On a fresh
    pool every test passes either way, so this one recycles first."""
    from repro_torch.api import CompressionConfig, PlannerConfig
    from repro_torch.cache.slot_cache import PlanArrays, init_cache
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.planner import build_plan
    from repro_torch.core.profiles import synthetic_profile
    from repro_torch.paging.backend import PagedBackend
    from repro_torch.serving.engine import ServeState

    cfg = get_smoke_config("minitron-8b")
    ccfg = CompressionConfig(budget=4, alpha_max=1.0, decode_margin=4)
    C, bs = ccfg.static_capacity(), 4
    plan = build_plan(synthetic_profile(cfg.n_layers, cfg.n_kv_heads, budget=4, seed=1),
                      2, PlannerConfig(mode="sha", batch_cap=2))
    pa = PlanArrays.from_plan(plan)
    be = PagedBackend(cfg, ccfg, paging=tbp.PagingConfig(block_size=bs, kv_dtype="int8"))
    state = be.init_state(pa, 2, torch.float32)
    L, S, Dh = cfg.n_layers, pa.slot_head.shape[1], cfg.head_dim
    own = pa.owner_mask_all(2)

    def sub_state(row, n, magnitude):
        c = init_cache(L, S, 1, C, Dh, dtype=torch.float32)
        o = own[:, :, row:row + 1]
        c.k[:, :, :, :n] = magnitude
        c.v[:, :, :, :n] = magnitude
        c.lengths[:] = torch.where(o, n, 0)
        c.pos[:, :, :, :n] = torch.where(o[..., None], torch.arange(n, dtype=torch.int32), -1)
        c.positions[:] = n
        return ServeState(cache=c, last_tokens=torch.zeros(1, dtype=torch.int64),
                          decode_steps=0)

    be.splice(state, sub_state(0, 2 * bs, 1000.0), [0])  # two blocks per pair
    big = state.cache.k_scale.clone()
    be.release_rows(state, [0])  # blocks back on the free list, scales stale
    be.splice(state, sub_state(0, bs, 0.01), [0])  # one full block per pair
    be.prepare_decode(state, [0])  # growth blocks: the recycled second blocks
    grown = torch.from_numpy(be.table[:, :, 0, 1]).long()  # (L, S)
    ids = grown[grown > 0]
    lyr = torch.arange(L)[:, None].expand_as(grown)[grown > 0]
    assert ids.numel() and bool((big[lyr, ids] > 1).all())  # recycled, stale
    assert bool((state.cache.k_scale[lyr, ids] == 0).all())
    tok = torch.full((S, 2, Dh), 0.01)
    tpc.paged_append_token(state.cache, 0, tok, tok, own[0] & (torch.arange(2) == 0),
                           0, C, ring=4, kinds=torch.zeros(S, dtype=torch.int32))
    back = tpc.paged_to_slot(state.cache, C)
    n = back.lengths[0, :, 0]
    got = back.k[0, :, 0][torch.arange(S), (n - 1).clamp(min=0)][n > 0]
    assert torch.allclose(got, torch.full_like(got, 0.01), rtol=1e-2)
