"""The port's plain paged decode against the JAX package, on the CPU.

`repro_torch.kernels.ref.paged_fairkv_decode_ref` is what the CUDA kernel
is held to on the card and what the CPU path runs.  Here the same numpy
layer (`paging.testing.make_paged_layer`, whose draws follow the
reference fixture's, checked below) goes through (a) the JAX oracle
``repro.kernels.ref.paged_fairkv_decode_ref`` and (b) the Pallas TPU
kernel in interpret mode: ragged lengths, shuffled block ids, empty and
all-null rows, partial last blocks, window and softcap, G in {1, 2, 4, 8},
and int8 / fp8 / mixed-kind pools quantized by both packages.  Tolerance
1e-5 with fp32 outputs (the reference's own bar for its kernel), 0.03
with bf16 outputs (one bf16 rounding).

The multi-query form (5-D q, the speculative-verify window, ragged
``q_lens`` with garbage lanes) is held the same way against the JAX
oracle with a 5-D q (``_paged_decode_pallas_mq``'s own oracle) and the
Pallas mq kernel in interpret mode: Q in {1, 3, 5}, G in {1, 4}, fp32 /
int8 / fp8 / mixed kinds, window, softcap, null-block tables and partial
last blocks; queries with no visible entry give exact zeros, and Q = 1
equals the 4-D path exactly.

Two contracts the card's bitwise checks rely on are pinned in the plain
versions of both packages: query i of the 5-D form is the 4-D form at the
query's causal length and position, and relabelling pool blocks (the
table remapped) changes no bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_fairkv_decode import paged_fairkv_decode_pallas
from repro.kernels.ref import paged_fairkv_decode_ref as jref
from repro.paging.testing import make_paged_layer as jmake
from repro.paging.testing import quantize_paged_layer as jquant
from repro_torch.kernels import build, ops
from repro_torch.kernels.ref import paged_fairkv_decode_ref as tref
from repro_torch.paging.testing import make_paged_layer as tmake
from repro_torch.paging.testing import quantize_paged_layer as tquant
from repro_torch.paging.testing import query_lengths, relabel_pool_blocks

from tests._hypothesis_compat import given, settings, st

torch.set_num_threads(2)
TOL = 1e-5


def _layers(seed, S, B, C, bs, Dh, lengths=None):
    j = jmake(np.random.default_rng(seed), S, B, C, bs, Dh, lengths=lengths)
    t = tmake(np.random.default_rng(seed), S, B, C, bs, Dh, lengths=lengths)
    for a, b in zip(j, t):  # one seed, one layer in both packages
        assert np.array_equal(np.asarray(a), b.numpy())
    return j, t


def _compare(seed, S, B, G, Dh, C, bs, window=0, cap=0.0, kinds=None, lengths=None,
             pallas=True):
    """Max |port − JAX oracle| and |port − Pallas interpret| for one layer;
    ``kinds`` (S,) quantizes the pools (both packages' codecs)."""
    (jk, jv, jp, jt, jl), (tk, tv, tp, tt, tl) = _layers(seed, S, B, C, bs, Dh, lengths)
    rng = np.random.default_rng(seed + 1)
    q = rng.normal(size=(B, S, G, Dh)).astype(np.float32)
    qpos = np.full((B,), C + 7, np.int32)
    jkw, tkw = {}, {}
    if kinds is not None:
        kinds = np.broadcast_to(np.asarray(kinds, np.int32), (S,)).copy()
        jk, jv, jks, jvs = jquant(jk, jv, jt, jnp.asarray(kinds))
        tk, tv, tks, tvs = tquant(tk, tv, tt, torch.from_numpy(kinds))
        assert np.array_equal(np.asarray(jk), tk.numpy())
        assert np.array_equal(np.asarray(jks), tks.numpy())
        jkw = dict(k_scale=jks, v_scale=jvs, kinds=jnp.asarray(kinds))
        tkw = dict(k_scale=tks, v_scale=tvs, kinds=torch.from_numpy(kinds))
    out = tref(torch.from_numpy(q), tk, tv, tp, tt, tl, C, cap,
               q_pos=torch.from_numpy(qpos), window=window, **tkw).numpy()
    oracle = np.asarray(jref(jnp.asarray(q), jk, jv, jp, jt, jl, C, cap,
                             q_pos=jnp.asarray(qpos), window=window, **jkw))
    errs = [float(np.abs(out - oracle).max())]
    if pallas:
        kern = np.asarray(paged_fairkv_decode_pallas(
            jnp.asarray(q), jk, jv, jp, jt, jl, C, attn_cap=cap,
            q_pos=jnp.asarray(qpos), window=window, interpret=True, **jkw))
        errs.append(float(np.abs(out - kern).max()))
    empty = (tl.numpy() == 0).T  # (B, S): empty pairs give exact zeros
    assert not np.any(out[empty])
    return max(errs)


@settings(max_examples=6, deadline=None)
@given(S=st.integers(2, 5), B=st.integers(1, 4), G=st.sampled_from([1, 2, 4, 8]),
       C=st.integers(6, 200), bs=st.sampled_from([2, 8, 16, 32, 64]),
       seed=st.integers(0, 10))
def test_paged_ref_ragged_lengths(S, B, G, C, bs, seed):
    """Ragged lengths, empty rows, shuffled blocks, partial last blocks."""
    assert _compare(seed, S, B, G, 32, C, bs) < TOL


@pytest.mark.parametrize("S,B,G,Dh,C,bs", [
    (4, 3, 4, 64, 96, 16),    # several blocks, ragged
    (2, 2, 8, 64, 256, 32),   # GQA 8:1
    (3, 2, 1, 128, 200, 64),  # MHA, capacity not a block multiple
    (2, 2, 2, 16, 16, 16),    # one block per row
])
def test_paged_ref_shapes(S, B, G, Dh, C, bs):
    assert _compare(S * 10 + C, S, B, G, Dh, C, bs) < TOL


@pytest.mark.parametrize("window,cap", [(40, 0.0), (0, 30.0), (40, 30.0)])
def test_paged_ref_window_softcap(window, cap):
    assert _compare(5, 3, 2, 4, 32, 96, 16, window=window, cap=cap) < TOL


def test_paged_ref_null_block_tables():
    """All-null tables (every length 0) decode to exact zeros."""
    assert _compare(6, 3, 2, 4, 32, 96, 16, lengths=np.zeros((3, 2))) == 0.0


def test_paged_ref_partial_last_blocks():
    lengths = np.asarray([[1, 17], [31, 33], [16, 47]])  # every partial case at bs 16
    assert _compare(7, 3, 2, 2, 32, 48, 16, lengths=lengths) < TOL


@pytest.mark.parametrize("kinds", [0, 1, [0, 1, 0, 1]], ids=["int8", "fp8", "mixed"])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (40, 30.0)])
def test_paged_ref_quantized(kinds, window, cap):
    """int8 / fp8 / mixed-kind pools: codes and scales from both codecs are
    identical, and the dequantizing decode matches oracle and kernel."""
    assert _compare(8, 4, 3, 4, 32, 96, 16, window=window, cap=cap, kinds=kinds) < TOL


@settings(max_examples=4, deadline=None)
@given(S=st.integers(2, 5), B=st.integers(1, 4), C=st.integers(6, 120),
       bs=st.sampled_from([2, 8, 16]), kind=st.sampled_from([0, 1]),
       seed=st.integers(0, 10))
def test_paged_ref_quantized_ragged(S, B, C, bs, kind, seed):
    assert _compare(seed, S, B, 4, 32, C, bs, kinds=kind, pallas=False) < TOL


def test_paged_ref_quantized_null_tables():
    assert _compare(9, 3, 2, 4, 32, 96, 16, kinds=1, lengths=np.zeros((3, 2))) == 0.0


def test_paged_ref_bf16():
    """bf16 pools and queries (0.03: one bf16 rounding of the output)."""
    (jk, jv, jp, jt, jl), (tk, tv, tp, tt, tl) = _layers(10, 3, 2, 96, 16, 64)
    q = np.random.default_rng(11).normal(size=(2, 3, 4, 64)).astype(np.float32)
    out = tref(torch.from_numpy(q).bfloat16(), tk.bfloat16(), tv.bfloat16(), tp, tt, tl,
               96).float().numpy()
    oracle = np.asarray(jref(jnp.asarray(q, jnp.bfloat16), jk.astype(jnp.bfloat16),
                             jv.astype(jnp.bfloat16), jp, jt, jl, 96).astype(jnp.float32))
    assert np.abs(out - oracle).max() < 0.03


# ---------------------------------------------------------------------------
# multi-query (speculative verify): 5-D q, ragged q_lens
# ---------------------------------------------------------------------------


def _compare_mq(seed, S, B, Q, G, Dh, C, bs, window=0, cap=0.0, kinds=None,
                lengths=None, q_lens=None, pallas=False):
    """Max |port − JAX oracle| (and |port − Pallas mq interpret|) for one
    layer and a 5-D q.  ``lengths`` count the cache after the window's
    appends (drawn >= Q by default, as the reference's own test does);
    ``q_lens`` defaults to a ragged draw in [1, Q]."""
    rng = np.random.default_rng(seed + 100)
    if lengths is None:
        lengths = rng.integers(Q, C + 1, size=(S, B)).astype(np.int32)
    if q_lens is None:
        q_lens = rng.integers(1, Q + 1, size=(B,))
    q_lens = np.asarray(q_lens, np.int32)
    (jk, jv, jp, jt, jl), (tk, tv, tp, tt, tl) = _layers(seed, S, B, C, bs, Dh, lengths)
    jkw, tkw = {}, {}
    if kinds is not None:
        kinds = np.broadcast_to(np.asarray(kinds, np.int32), (S,)).copy()
        jk, jv, jks, jvs = jquant(jk, jv, jt, jnp.asarray(kinds))
        tk, tv, tks, tvs = tquant(tk, tv, tt, torch.from_numpy(kinds))
        assert np.array_equal(np.asarray(jk), tk.numpy())
        jkw = dict(k_scale=jks, v_scale=jvs, kinds=jnp.asarray(kinds))
        tkw = dict(k_scale=tks, v_scale=tvs, kinds=torch.from_numpy(kinds))
    q = rng.normal(size=(B, S, Q, G, Dh)).astype(np.float32)
    qpos = np.full((B,), C + 7, np.int32)  # query 0's absolute position
    out = tref(torch.from_numpy(q), tk, tv, tp, tt, tl, C, cap,
               q_pos=torch.from_numpy(qpos), window=window,
               q_lens=torch.from_numpy(q_lens), **tkw).numpy()
    assert out.shape == (B, S, Q, G, Dh)
    oracle = np.asarray(jref(jnp.asarray(q), jk, jv, jp, jt, jl, C, cap,
                             q_pos=jnp.asarray(qpos), window=window,
                             q_lens=jnp.asarray(q_lens), **jkw))
    errs = [float(np.abs(out - oracle).max())]
    if pallas:
        kern = np.asarray(paged_fairkv_decode_pallas(
            jnp.asarray(q), jk, jv, jp, jt, jl, C, attn_cap=cap,
            q_pos=jnp.asarray(qpos), window=window, interpret=True,
            q_lens=jnp.asarray(q_lens), **jkw))
        errs.append(float(np.abs(out - kern).max()))
    # a query with no visible entry (empty pair, or a causal limit <= 0)
    # gives exact zeros
    ln = tl.numpy().T[:, :, None]  # (B, S, 1)
    limit = np.minimum(ln - (q_lens[:, None, None] - 1 - np.arange(Q)), ln)
    assert not np.any(out[limit <= 0])
    return max(errs)


@pytest.mark.parametrize("Q", [1, 3, 5])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("kinds", [None, 0, 1, [0, 1, 0, 1]],
                         ids=["fp32", "int8", "fp8", "mixed"])
def test_paged_ref_mq(Q, G, kinds):
    """Ragged q_lens with garbage lanes over ragged lengths, every pool kind;
    the Pallas mq kernel beside the oracle on the fp32 pools."""
    assert _compare_mq(40 + Q + G, 4, 3, Q, G, 32, 96, 16, kinds=kinds,
                       pallas=kinds is None) < TOL


@pytest.mark.parametrize("window,cap", [(40, 0.0), (0, 30.0), (40, 30.0)])
@pytest.mark.parametrize("kinds", [None, 1], ids=["fp32", "fp8"])
def test_paged_ref_mq_window_softcap(window, cap, kinds):
    """The window test uses q_pos + i per query."""
    assert _compare_mq(50, 3, 2, 5, 4, 32, 96, 16, window=window, cap=cap,
                       kinds=kinds, pallas=kinds is None) < TOL


def test_paged_ref_mq_null_tables_and_partial_blocks():
    """All-null tables give exact zeros; lengths below the window (limits
    <= 0) zero exactly those queries; partial last blocks of every kind."""
    assert _compare_mq(51, 3, 2, 3, 4, 32, 96, 16, lengths=np.zeros((3, 2))) == 0.0
    assert _compare_mq(51, 3, 2, 3, 4, 32, 96, 16, kinds=1,
                       lengths=np.zeros((3, 2))) == 0.0
    lengths = np.asarray([[1, 17], [2, 33], [16, 47]])  # partial blocks at bs 16
    assert _compare_mq(52, 3, 2, 5, 4, 32, 48, 16, lengths=lengths,
                       q_lens=[5, 3], pallas=True) < TOL
    assert _compare_mq(53, 3, 2, 5, 4, 32, 48, 16, lengths=lengths, kinds=[0, 1, 0],
                       q_lens=[4, 5]) < TOL


def test_paged_ref_mq_q1_equals_4d():
    """A 5-D q with Q = 1 is the 4-D path exactly."""
    _, (tk, tv, tp, tt, tl) = _layers(54, 3, 2, 96, 16, 32)
    q = torch.from_numpy(np.random.default_rng(55).normal(size=(2, 3, 4, 32))
                         .astype(np.float32))
    qpos = torch.full((2,), 103, dtype=torch.int32)
    for window in (0, 40):
        a = tref(q, tk, tv, tp, tt, tl, 96, 30.0, q_pos=qpos, window=window)
        b = tref(q[:, :, None], tk, tv, tp, tt, tl, 96, 30.0, q_pos=qpos,
                 window=window, q_lens=torch.ones((2,), dtype=torch.int32))
        assert torch.equal(a, b[:, :, 0])


@settings(max_examples=4, deadline=None)
@given(S=st.integers(2, 4), B=st.integers(1, 4), Q=st.integers(1, 5),
       G=st.sampled_from([1, 2, 4, 8]), C=st.integers(8, 128),
       bs=st.sampled_from([2, 8, 16, 32]), seed=st.integers(0, 10))
def test_paged_ref_mq_ragged(S, B, Q, G, C, bs, seed):
    assert _compare_mq(seed, S, B, Q, G, 32, max(C, Q), bs) < TOL


# ---------------------------------------------------------------------------
# the contracts the card's bitwise checks rely on, pinned in the plain
# versions of both packages
# ---------------------------------------------------------------------------


def _mq_layer(seed, S, B, Q, G, Dh, C, bs, kinds):
    """One layer in both packages (lengths >= Q, ragged q_lens) with a 5-D
    q; ``kinds`` quantizes the pools.  Returns (jax args, jax kw, port
    args, port kw, q_lens, lengths)."""
    rng = np.random.default_rng(seed + 200)
    lengths = rng.integers(Q, C + 1, size=(S, B)).astype(np.int32)
    q_lens = rng.integers(1, Q + 1, size=(B,)).astype(np.int32)
    (jk, jv, jp, jt, jl), (tk, tv, tp, tt, tl) = _layers(seed, S, B, C, bs, Dh, lengths)
    jkw, tkw = {}, {}
    if kinds is not None:
        kinds = np.broadcast_to(np.asarray(kinds, np.int32), (S,)).copy()
        jk, jv, jks, jvs = jquant(jk, jv, jt, jnp.asarray(kinds))
        tk, tv, tks, tvs = tquant(tk, tv, tt, torch.from_numpy(kinds))
        jkw = dict(k_scale=jks, v_scale=jvs, kinds=jnp.asarray(kinds))
        tkw = dict(k_scale=tks, v_scale=tvs, kinds=torch.from_numpy(kinds))
    q = rng.normal(size=(B, S, Q, G, Dh)).astype(np.float32)
    return (q, jk, jv, jp, jt), jkw, (q, tk, tv, tp, tt), tkw, q_lens, lengths


@pytest.mark.parametrize("window,cap", [(0, 0.0), (40, 30.0)])
@pytest.mark.parametrize("kinds", [None, 0, 1, [0, 1, 0]],
                         ids=["fp32", "int8", "fp8", "mixed"])
def test_paged_ref_mq_query_is_single_query(kinds, window, cap):
    """Query i of the 5-D form is, bitwise, the 4-D form at lengths
    min(len - (qn - 1 - i), len) clamped at 0 and q_pos + i, in the port
    and in the JAX package (the multi-query kernel is held to the
    single-query one this way on the card); the two packages agree within
    TOL."""
    S, B, Q, G, Dh, C, bs = 3, 2, 5, 4, 32, 96, 16
    (q, jk, jv, jp, jt), jkw, (_, tk, tv, tp, tt), tkw, q_lens, lengths = _mq_layer(
        60, S, B, Q, G, Dh, C, bs, kinds)
    qpos = np.full((B,), C + 7, np.int32)
    jout = np.asarray(jref(jnp.asarray(q), jk, jv, jp, jt, jnp.asarray(lengths), C, cap,
                           q_pos=jnp.asarray(qpos), window=window,
                           q_lens=jnp.asarray(q_lens), **jkw))
    tout = tref(torch.from_numpy(q), tk, tv, tp, tt, torch.from_numpy(lengths), C, cap,
                q_pos=torch.from_numpy(qpos), window=window,
                q_lens=torch.from_numpy(q_lens), **tkw).numpy()
    assert np.abs(tout - jout).max() < TOL
    for i in range(Q):
        lim = query_lengths(torch.from_numpy(lengths), torch.from_numpy(q_lens), i).numpy()
        qi = np.ascontiguousarray(q[:, :, i])
        j1 = np.asarray(jref(jnp.asarray(qi), jk, jv, jp, jt, jnp.asarray(lim), C, cap,
                             q_pos=jnp.asarray(qpos + i), window=window, **jkw))
        t1 = tref(torch.from_numpy(qi), tk, tv, tp, tt, torch.from_numpy(lim), C, cap,
                  q_pos=torch.from_numpy(qpos + i), window=window, **tkw).numpy()
        assert np.array_equal(j1, jout[:, :, i])
        assert np.array_equal(t1, tout[:, :, i])


@pytest.mark.parametrize("mq", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("kinds", [None, [0, 1, 0]], ids=["fp32", "mixed"])
def test_paged_ref_permuted_pools(mq, kinds):
    """Relabelling the pool blocks and remapping the table leaves the
    output bitwise unchanged, in the port and in the JAX package (the card
    holds both kernels to this); the packages agree within TOL."""
    S, B, Q, G, Dh, C, bs = 3, 2, 3, 4, 32, 96, 16
    (q, jk, jv, jp, jt), jkw, (_, tk, tv, tp, tt), tkw, q_lens, lengths = _mq_layer(
        61, S, B, Q, G, Dh, C, bs, kinds)
    if not mq:
        q = np.ascontiguousarray(q[:, :, 0])
    qpos = np.full((B,), C + 7, np.int32)
    extra = dict(q_lens=q_lens) if mq else {}
    scale_keys = ["k_scale", "v_scale"] if kinds is not None else []
    *layer, pscales = relabel_pool_blocks(tk, tv, tp, tt, [tkw[k] for k in scale_keys], seed=62)
    pk, pv, pp, ptab = (x.numpy() for x in layer)
    pscales = [x.numpy() for x in pscales]

    def port(k, v, p, t, scales):
        kw = dict(tkw, **{n: torch.from_numpy(np.asarray(x)) for n, x in zip(scale_keys, scales)})
        kw.update({n: torch.from_numpy(x) for n, x in extra.items()})
        return tref(torch.from_numpy(q), *(torch.from_numpy(np.asarray(a)) for a in (k, v, p, t)),
                    torch.from_numpy(lengths), C, 30.0, q_pos=torch.from_numpy(qpos),
                    window=40, **kw).numpy()

    def jax_(k, v, p, t, scales):
        kw = dict(jkw, **{n: jnp.asarray(x) for n, x in zip(scale_keys, scales)})
        kw.update({n: jnp.asarray(x) for n, x in extra.items()})
        return np.asarray(jref(jnp.asarray(q), *(jnp.asarray(a) for a in (k, v, p, t)),
                               jnp.asarray(lengths), C, 30.0, q_pos=jnp.asarray(qpos),
                               window=40, **kw))

    base = [tkw[k] for k in scale_keys]
    t0, t1 = port(tk, tv, tp, tt, base), port(pk, pv, pp, ptab, pscales)
    j0, j1 = jax_(jk, jv, jp, jt, [jkw[k] for k in scale_keys]), jax_(pk, pv, pp, ptab, pscales)
    assert not np.array_equal(ptab, np.asarray(tt))
    assert np.array_equal(t0, t1)
    assert np.array_equal(j0, j1)
    assert np.abs(t0 - j0).max() < TOL


def test_ops_dispatch_cpu_runs_plain_version():
    """On CPU tensors `ops.paged_fairkv_decode` is the plain version, and
    no kernel launch is counted."""
    _, (tk, tv, tp, tt, tl) = _layers(12, 3, 2, 64, 16, 32)
    q = torch.randn(2, 3, 2, 32, generator=torch.Generator().manual_seed(0))
    before = build.LAUNCHES["paged_fairkv_decode"]
    a = ops.paged_fairkv_decode(q, tk, tv, tp, tt, tl, 64)
    assert torch.equal(a, tref(q, tk, tv, tp, tt, tl, 64))
    assert build.LAUNCHES["paged_fairkv_decode"] == before
    assert "paged_fairkv_decode" in build.KERNELS


def test_ops_dispatch_cpu_runs_plain_mq_version():
    """A 5-D q on the CPU runs the plain multi-query version; no launch."""
    _, (tk, tv, tp, tt, tl) = _layers(13, 3, 2, 64, 16, 32)
    q = torch.randn(2, 3, 4, 2, 32, generator=torch.Generator().manual_seed(1))
    ql = torch.tensor([4, 2], dtype=torch.int32)
    before = dict(build.LAUNCHES)
    a = ops.paged_fairkv_decode(q, tk, tv, tp, tt, tl, 64, q_lens=ql)
    assert torch.equal(a, tref(q, tk, tv, tp, tt, tl, 64, q_lens=ql))
    assert build.LAUNCHES == before
    assert "paged_fairkv_decode_mq" in build.KERNELS


@pytest.mark.parametrize("S,B,G,Dh,C,bs,window,cap", [
    (3, 2, 4, 32, 100, 16, 0, 0.0), (2, 5, 1, 16, 64, 8, 20, 30.0),
    (4, 2, 8, 64, 33, 16, 0, 50.0)])
def test_slot_layer_as_pool_matches_slot_decode(S, B, G, Dh, C, bs, window, cap):
    """A slot cache laid out as pools with an identity table
    (`paging.testing.slot_layer_as_pool`, the layout the card uses to hold
    the slot kernel bitwise to the paged one) gives, through the port's
    plain paged decode, the JAX package's slot decode oracle."""
    from repro.kernels.ref import fairkv_decode_ref as jslot
    from repro_torch.paging.testing import slot_layer_as_pool
    rng = np.random.default_rng(S * 1000 + C)
    q = rng.normal(size=(B, S, G, Dh)).astype(np.float32)
    k = rng.normal(size=(S, B, C, Dh)).astype(np.float32)
    v = rng.normal(size=(S, B, C, Dh)).astype(np.float32)
    ln = rng.integers(0, C + 1, size=(S, B)).astype(np.int32)
    kpos = np.broadcast_to(np.arange(C, dtype=np.int32), (S, B, C)).copy()
    qpos = np.full((B,), C + 3, np.int32)
    kp, vp, pp, tbl = slot_layer_as_pool(torch.from_numpy(k), torch.from_numpy(v),
                                         torch.from_numpy(kpos), bs)
    assert tbl.shape == (S, B, -(-C // bs)) and kp.shape[0] == 1 + tbl.numel()
    out = tref(torch.from_numpy(q), kp, vp, pp, tbl, torch.from_numpy(ln), C, cap,
               q_pos=torch.from_numpy(qpos), window=window).numpy()
    oracle = np.asarray(jslot(*(jnp.asarray(a) for a in (q, k, v, ln)), cap,
                              k_pos=jnp.asarray(kpos), q_pos=jnp.asarray(qpos),
                              window=window))
    assert np.abs(out - oracle).max() < TOL
