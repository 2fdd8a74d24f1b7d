"""The port's plain kernel versions against the JAX reference.

Same numpy inputs through (a) the JAX Pallas kernels in interpret mode,
(b) the JAX ``kernels.ref`` oracles and (c) the port's
``repro_torch.kernels.ref``, which is what the CUDA kernels are held to on
the card and what the CPU path runs.  Tolerance 1e-5 (fp32; the three
differ only in summation order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.fairkv_decode import fairkv_decode_pallas
from repro.kernels.snapkv_select import snapkv_scores_pallas
from repro_torch.kernels import build, ops
from repro_torch.kernels import ref as tref

torch.set_num_threads(2)
TOL = 1e-5


def _decode_inputs(seed, B, S, G, Dh, C, empty_rows=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, G, Dh)).astype(np.float32)
    k = rng.normal(size=(S, B, C, Dh)).astype(np.float32)
    v = rng.normal(size=(S, B, C, Dh)).astype(np.float32)
    lengths = rng.integers(0 if empty_rows else 1, C + 1, size=(S, B)).astype(np.int32)
    if empty_rows:
        lengths[0] = 0  # a fully-empty slot
    kpos = np.broadcast_to(np.arange(C, dtype=np.int32), (S, B, C)).copy()
    qpos = np.full((B,), C + 7, np.int32)
    return q, k, v, lengths, kpos, qpos


@pytest.mark.parametrize("B,S,G,Dh,C,block", [
    (4, 8, 8, 64, 256, 128),   # GQA 8:1
    (2, 16, 1, 128, 200, 64),  # MHA, ragged capacity
    (3, 5, 4, 32, 96, 32),     # odd slot count
    (2, 4, 2, 16, 64, 64),     # single block
])
@pytest.mark.parametrize("window,cap,empty", [
    (0, 0.0, False), (0, 0.0, True), (40, 0.0, False), (0, 50.0, True)])
def test_fairkv_decode_ref_matches_jax(B, S, G, Dh, C, block, window, cap, empty):
    q, k, v, ln, kpos, qpos = _decode_inputs(B * 100 + C, B, S, G, Dh, C, empty)
    out = tref.fairkv_decode_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(ln), cap, k_pos=torch.from_numpy(kpos),
        q_pos=torch.from_numpy(qpos), window=window).numpy()
    jargs = [jnp.asarray(a) for a in (q, k, v, ln)]
    oracle = np.asarray(jref.fairkv_decode_ref(
        *jargs, cap, k_pos=jnp.asarray(kpos), q_pos=jnp.asarray(qpos),
        window=window))
    pallas = np.asarray(fairkv_decode_pallas(
        *jargs, attn_cap=cap, k_pos=jnp.asarray(kpos), q_pos=jnp.asarray(qpos),
        window=window, block_c=block, interpret=True))
    assert np.abs(out - oracle).max() < TOL
    assert np.abs(out - pallas).max() < TOL
    if empty:  # unowned rows give exactly 0 (the slot-sum reassembly rule)
        assert np.abs(out[:, 0]).max() == 0.0


def test_fairkv_decode_all_empty_is_exact_zero():
    q, k, v, _, _, _ = _decode_inputs(7, 2, 4, 4, 32, 64)
    ln = torch.zeros((4, 2), dtype=torch.int32)
    out = tref.fairkv_decode_ref(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), ln)
    assert out.abs().max().item() == 0.0


def _scores_inputs(seed, B, W, Hq, Hkv, Dh, T):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, W, Hq, Dh)).astype(np.float32)
    k = rng.normal(size=(B, T, Hkv, Dh)).astype(np.float32)
    kpos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    opos = np.broadcast_to(np.arange(T - W, T, dtype=np.int32), (B, W)).copy()
    return q, k, opos, kpos


@pytest.mark.parametrize("B,W,Hq,Hkv,Dh,T,block", [
    (2, 8, 8, 2, 64, 256, 128),
    (1, 4, 4, 4, 32, 100, 32),   # MHA, ragged T
    (2, 16, 8, 8, 64, 128, 128),  # single block
])
@pytest.mark.parametrize("cap", [0.0, 50.0])
def test_snapkv_scores_ref_matches_jax(B, W, Hq, Hkv, Dh, T, block, cap):
    q, k, opos, kpos = _scores_inputs(B * 1000 + T, B, W, Hq, Hkv, Dh, T)
    out = tref.snapkv_scores_ref(*(torch.from_numpy(a) for a in (q, k, opos, kpos)),
                                 cap).numpy()
    jargs = [jnp.asarray(a) for a in (q, k, opos, kpos)]
    oracle = np.asarray(jref.snapkv_scores_ref(*jargs, cap))
    pallas = np.asarray(snapkv_scores_pallas(*jargs, attn_cap=cap,
                                             block_t=block, interpret=True))
    assert np.abs(out - oracle).max() < TOL
    assert np.abs(out - pallas).max() < TOL
    # each query spreads probability mass 1 over its causal prefix
    np.testing.assert_allclose(out.sum(-1), W * (Hq // Hkv), rtol=1e-4)


def test_ops_dispatch_cpu_runs_plain_and_launches_nothing():
    build.reset_launches()
    q, k, v, ln, kpos, qpos = _decode_inputs(3, 2, 4, 2, 16, 64)
    t = [torch.from_numpy(a) for a in (q, k, v, ln, kpos, qpos)]
    out = ops.fairkv_decode(*t[:4], 0.0, k_pos=t[4], q_pos=t[5], window=8)
    ref = tref.fairkv_decode_ref(*t[:4], 0.0, k_pos=t[4], q_pos=t[5], window=8)
    assert torch.equal(out, ref)
    sq, sk, so, sp = (torch.from_numpy(a) for a in _scores_inputs(4, 1, 4, 4, 2, 16, 40))
    assert torch.equal(ops.snapkv_scores(sq, sk, so, sp),
                       tref.snapkv_scores_ref(sq, sk, so, sp))
    assert build.LAUNCHES == {"fairkv_decode": 0, "snapkv_scores": 0,
                              "paged_fairkv_decode": 0,
                              "paged_fairkv_decode_mq": 0}


def test_cuda_wrappers_reject_cpu_tensors():
    from repro_torch.kernels.fairkv_decode import fairkv_decode_cuda
    from repro_torch.kernels.snapkv_select import snapkv_scores_cuda
    q, k, v, ln, _, _ = (torch.from_numpy(a) for a in _decode_inputs(5, 2, 4, 2, 16, 64))
    with pytest.raises(ValueError, match="CUDA"):
        fairkv_decode_cuda(q, k, v, ln)
    sq, sk, so, sp = (torch.from_numpy(a) for a in _scores_inputs(6, 1, 4, 4, 2, 16, 40))
    with pytest.raises(ValueError, match="CUDA"):
        snapkv_scores_cuda(sq, sk, so, sp)


def test_lib_path_follows_sources_and_headers(tmp_path, monkeypatch):
    """A kernel's library path hashes its source and every shared header, so
    an edited header rebuilds the kernels (no nvcc needed to check)."""
    import shutil
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "the kernels share at least one header"
    before = {name: build.lib_path(name) for name in build.KERNELS}
    assert before == {name: build.lib_path(name) for name in build.KERNELS}
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    after = {name: build.lib_path(name) for name in build.KERNELS}
    assert all(after[name] != before[name] for name in build.KERNELS)
    src = csrc / "snapkv_scores.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert build.lib_path("snapkv_scores") != after["snapkv_scores"]
    assert build.lib_path("fairkv_decode") == after["fairkv_decode"]
