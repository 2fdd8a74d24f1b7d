"""Split-S decode's pieces (long_500k's step: the cache's columns split over
the batch axes) against the JAX package, on the CPU.

- `fairkv_decode_partial_ref` on every shard of the columns, then
  `merge_partials` in shard order, against the reference's
  `fairkv_decode_ref` over the whole cache: 1 to 4 shards, softcap, a
  global and a sliding-window layer, (slot, row) pairs that are empty,
  that end before a shard boundary (empty later shards), whose window
  masks whole shards, and that sit at capacity; fp32, within 1e-5.
- The split `append_token` over 2 and 4 shards, step by step past the
  ring's wrap at capacity: the shards put together equal the reference's
  `append_token` on the whole cache bitwise, at every step.

The cell step itself runs on gloo ranks in `tests/test_torch_mesh.py`
(``long_rank``), held to the reference's single-device decode steps by
`tests/test_torch_tp.py`'s `check_long`.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache import slot_cache as jsc
from repro.kernels import ref as jref
from repro_torch.cache.slot_cache import SlotCache, append_token, shard_lengths
from repro_torch.kernels.ref import fairkv_decode_partial_ref, merge_partials

B, S, G, Dh, C = 3, 4, 2, 16, 48
CAP = 50.0


def _inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, G, Dh)).astype(np.float32)
    k = rng.standard_normal((S, B, C, Dh)).astype(np.float32)
    v = rng.standard_normal((S, B, C, Dh)).astype(np.float32)
    # (slot, row) lengths: empty, inside the first shard at every split,
    # across shard boundaries, and at capacity
    lengths = np.array([[0, 5, 48], [11, 48, 1], [23, 30, 0], [48, 12, 37]], np.int32)
    k_pos = np.broadcast_to(np.arange(C, dtype=np.int32), (S, B, C)).copy()
    k_pos[0, 2] = np.roll(k_pos[0, 2], 7)  # a wrapped ring: positions out of column order
    q_pos = np.array([60, 48, 52], np.int32)
    return q, k, v, lengths, k_pos, q_pos


@pytest.mark.parametrize("window", [0, 8], ids=["global", "window"])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_partials_merge_to_the_reference(n, window):
    """Each shard's (o, lse), merged in shard order, is the reference's
    decode over the whole cache; nothing is NaN, and an empty (slot, row)
    gives exact zeros.  With the window of 8 at positions 48-60 every
    shard but the last is all masked (n >= 2)."""
    q, k, v, lengths, k_pos, q_pos = _inputs()
    want = np.asarray(jref.fairkv_decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             jnp.asarray(lengths), CAP,
                                             k_pos=jnp.asarray(k_pos), q_pos=jnp.asarray(q_pos),
                                             window=window))
    t = {name: torch.from_numpy(a) for name, a in
         zip(("q", "k", "v", "lengths", "k_pos", "q_pos"), (q, k, v, lengths, k_pos, q_pos))}
    cl = C // n
    parts = []
    for r in range(n):
        cols = slice(r * cl, (r + 1) * cl)
        o, lse = fairkv_decode_partial_ref(
            t["q"], t["k"][:, :, cols].contiguous(), t["v"][:, :, cols].contiguous(),
            shard_lengths(t["lengths"], r * cl, cl), CAP,
            k_pos=t["k_pos"][:, :, cols].contiguous(), q_pos=t["q_pos"], window=window)
        assert o.dtype == lse.dtype == torch.float32
        assert not torch.isnan(o).any() and not torch.isnan(lse).any()
        empty = shard_lengths(t["lengths"], r * cl, cl).T == 0  # (B, S)
        assert torch.all(lse[empty] == float("-inf")) and torch.all(o[empty] == 0)
        parts.append((o, lse))
    got = merge_partials(parts, torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.all(got[:, 0][lengths[0] == 0] == 0)  # slot 0, row 0: length 0
    if window and n >= 2:
        live = shard_lengths(t["lengths"], 0, cl).T > 0  # (B, S)
        live[2, 0] = False  # the wrapped ring holds positions 41-47 in its first columns
        # columns below 40 lie outside every row's window: the first shard is masked
        assert live.any() and torch.all(parts[0][1][live] == float("-inf"))


def test_merge_of_all_empty_shards_is_exact_zeros():
    """Every shard empty: zeros in q's dtype, no NaN (the reference's
    ``nonempty`` rule)."""
    o = torch.zeros((1, 2, 2, 4))
    lse = torch.full((1, 2, 2), float("-inf"))
    out = merge_partials([(o, lse), (o, lse)], torch.bfloat16)
    assert out.dtype == torch.bfloat16 and torch.equal(out, torch.zeros_like(out))


def _reference_cache(k, v, lengths, pos, positions):
    return jsc.SlotCache(k=jnp.asarray(k), v=jnp.asarray(v), lengths=jnp.asarray(lengths),
                         pos=jnp.asarray(pos), positions=jnp.asarray(positions))


@pytest.mark.parametrize("n", [2, 4])
def test_split_append_matches_reference(n):
    """Twelve appends to layer 1 of a (2, S, B, 48, Dh) cache split into
    ``n`` column shards, starting near capacity so that rows reach it and
    the ring (the last 8 columns, on the last shard) wraps, with an owner
    mask that leaves some pairs out: the shards put together equal the
    reference's `append_token` bitwise after every step, and the whole
    ``lengths`` agree on every rank."""
    rng = np.random.default_rng(1)
    L, ring, steps = 2, 8, 12
    k = rng.standard_normal((L, S, B, C, Dh)).astype(np.float32)
    v = rng.standard_normal((L, S, B, C, Dh)).astype(np.float32)
    lengths = np.array([[[40, 45, 3], [48, 20, 0], [44, 47, 23], [0, 48, 31]]] * L, np.int32)
    pos = np.where(np.arange(C) < lengths[..., None], np.arange(C), -1).astype(np.int32)
    positions = np.array([50, 60, 70], np.int32)
    own = np.array([[1, 1, 1], [1, 1, 0], [1, 0, 1], [0, 1, 1]], bool)
    jc = _reference_cache(k, v, lengths, pos, positions)
    cl = C // n
    shards = [SlotCache(k=torch.from_numpy(k[..., r * cl:(r + 1) * cl, :].copy()),
                        v=torch.from_numpy(v[..., r * cl:(r + 1) * cl, :].copy()),
                        lengths=torch.from_numpy(lengths.copy()),
                        pos=torch.from_numpy(pos[..., r * cl:(r + 1) * cl].copy()),
                        positions=torch.from_numpy(positions.copy())) for r in range(n)]
    wrapped = False
    for step in range(steps):
        k_new = rng.standard_normal((S, B, Dh)).astype(np.float32)
        v_new = rng.standard_normal((S, B, Dh)).astype(np.float32)
        jc = jsc.append_token(jc, 1, jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(own),
                              jnp.int32(step), ring=ring)
        for r, sh in enumerate(shards):
            append_token(sh, 1, torch.from_numpy(k_new), torch.from_numpy(v_new),
                         torch.from_numpy(own), step, ring=ring, offset=r * cl, capacity=C)
        for f in ("k", "v", "pos"):
            got = np.concatenate([getattr(sh, f).numpy() for sh in shards], axis=3)
            assert np.array_equal(got, np.asarray(getattr(jc, f))), (step, f)
        for sh in shards:
            assert np.array_equal(sh.lengths.numpy(), np.asarray(jc.lengths)), step
        wrapped |= bool((np.asarray(jc.lengths)[1][own] == C).sum() > 3)
    assert wrapped  # the ring wrapped on several pairs
