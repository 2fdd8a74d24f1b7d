"""The port's CUDA kernels and CUDA path on the card (marker ``cuda``).

Skipped without a CUDA device; on the GPU machine run
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
Each kernel is held against its plain PyTorch version on the same inputs:
1e-4 absolute in fp32 (the summation order differs), plus one bf16 rounding
step relative for bf16 outputs (both sides round an fp32 result once); the
paged kernel to the reference's own bars for its TPU kernel, 1e-5 with
fp32 outputs and 0.03 with bf16 outputs; the multi-query paged kernel to
1e-4 with fp32 outputs and one bf16 step with bf16 outputs, and bitwise to
the single-query kernel at Q = 1.  The slot kernel is also held bitwise
to the paged kernel over an identity block table.  The paged kernels share
one body: every query of the multi-query kernel is held bitwise to the
single-query kernel at its causal length and position (all pool kinds,
window and softcap, query chunks, lengths up to 1600 at block sizes 8, 16
and 32), and both kernels bitwise to themselves on relabelled pool blocks.  The
score kernel is also held at the chunked-prefill shape, and a shared-prefix
trace on the card gives the CPU path's tokens.  The HTTP front end over a
graphed engine gives `Engine.stream`'s tokens and captures nothing.  The
mesh executor on one NCCL rank captures its decode step with the
all-reduces inside and gives the local executor's tokens and logits
bitwise; two gloo ranks sharing the card give its tokens.
"""
import numpy as np
import pytest
import torch

from repro_torch.api import (CompressionConfig, Engine, EngineConfig, PagingConfig,
                             PlannerConfig, SchedulerConfig, SpeculationConfig,
                             synthesize_requests)
from repro_torch.kernels import build
from repro_torch.kernels.ref import (fairkv_decode_ref, paged_fairkv_decode_ref,
                                     snapkv_scores_ref)
from repro_torch.paging.testing import (make_paged_layer, quantize_paged_layer, query_lengths,
                                        relabel_pool_blocks)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,G,Dh,C,window,cap", [
    (4, 8, 8, 64, 256, 0, 0.0), (3, 5, 4, 32, 96, 40, 0.0),
    (8, 16, 4, 128, 576, 0, 50.0),
    # head_dim 256 (gemma2-9b's main-path shape with its window and softcap)
    (4, 16, 2, 256, 576, 200, 50.0), (3, 4, 8, 256, 300, 0, 0.0), (2, 5, 1, 256, 150, 0, 30.0)])
def test_fairkv_decode_kernel(gen, dtype, B, S, G, Dh, C, window, cap):
    from repro_torch.kernels.fairkv_decode import fairkv_decode_cuda
    q = torch.randn((B, S, G, Dh), generator=gen, device="cuda").to(dtype)
    k = torch.randn((S, B, C, Dh), generator=gen, device="cuda").to(dtype)
    v = torch.randn((S, B, C, Dh), generator=gen, device="cuda").to(dtype)
    ln = torch.randint(0, C + 1, (S, B), generator=gen, device="cuda", dtype=torch.int32)
    ln[0] = 0
    kp = torch.arange(C, dtype=torch.int32, device="cuda").expand(S, B, C).contiguous()
    qp = torch.full((B,), C + 7, dtype=torch.int32, device="cuda")
    before = build.LAUNCHES["fairkv_decode"]
    out = fairkv_decode_cuda(q, k, v, ln, cap, k_pos=kp, q_pos=qp, window=window)
    torch.cuda.synchronize()
    assert build.LAUNCHES["fairkv_decode"] == before + 1
    ref = fairkv_decode_ref(q, k, v, ln, cap, k_pos=kp, q_pos=qp, window=window)
    rel = 0.0 if dtype == torch.float32 else 2.0 ** -7
    err = (out.float() - ref.float()).abs()
    assert bool((err <= 1e-4 + rel * ref.float().abs()).all())
    assert out[:, 0].abs().max().item() == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,W,Hq,Hkv,Dh,T,cap", [
    (2, 8, 8, 2, 64, 256, 0.0), (1, 4, 4, 4, 32, 100, 50.0), (2, 32, 32, 8, 128, 512, 0.0),
    # B = 1 with T tails off the 64-key tile; G = 1, 2, 8 at W = 32 (R = 32 ... 256)
    (1, 32, 32, 8, 128, 63, 0.0), (1, 32, 32, 8, 128, 1000, 50.0),
    (1, 32, 32, 8, 128, 2047, 0.0), (1, 32, 32, 8, 128, 2048, 0.0),
    (1, 32, 8, 8, 128, 1000, 0.0), (1, 32, 16, 8, 128, 1000, 0.0),
    (1, 32, 64, 8, 128, 1000, 50.0),
    # head_dim 256 (gemma2-9b: G = 2, softcap 50) and 192
    (1, 32, 16, 8, 256, 1000, 50.0), (2, 32, 16, 8, 256, 300, 0.0), (1, 8, 8, 2, 192, 130, 0.0)])
def test_snapkv_scores_kernel(gen, dtype, B, W, Hq, Hkv, Dh, T, cap):
    from repro_torch.kernels.snapkv_select import snapkv_scores_cuda
    q = torch.randn((B, W, Hq, Dh), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, T, Hkv, Dh), generator=gen, device="cuda").to(dtype)
    kp = torch.arange(T, dtype=torch.int32, device="cuda").expand(B, T).contiguous()
    op = kp[:, T - W:].contiguous()
    out = snapkv_scores_cuda(q, k, op, kp, cap)
    torch.cuda.synchronize()
    ref = snapkv_scores_ref(q, k, op, kp, cap)
    assert bool(((out - ref).abs() <= 1e-4 + 1e-5 * ref.abs()).all())
    mass = out.sum(-1)
    assert torch.allclose(mass, torch.full_like(mass, W * Hq // Hkv), rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("start,valid,cap", [
    (0, 512, 0.0), (1024, 512, 0.0), (1024, 300, 50.0), (1536, 20, 0.0)])
def test_snapkv_scores_kernel_chunk_shape(gen, dtype, start, valid, cap):
    """Kernel 2 as chunked prefill calls it: B = 1, 512 chunk keys at
    absolute positions from ``start``, the last 32 valid queries (clipped
    at the chunk's first token when fewer than 32 are valid); the padding
    keys of a last chunk are scored exactly 0."""
    from repro_torch.kernels.snapkv_select import snapkv_scores_cuda
    Ck, W, Hq, Hkv, Dh = 512, 32, 32, 8, 128
    q_all = torch.randn((1, Ck, Hq, Dh), generator=gen, device="cuda").to(dtype)
    k = torch.randn((1, Ck, Hkv, Dh), generator=gen, device="cuda").to(dtype)
    kp = (start + torch.arange(Ck, dtype=torch.int32, device="cuda"))[None].contiguous()
    ix = torch.clamp(valid - W + torch.arange(W, device="cuda"), 0, Ck - 1)
    q, op = q_all[:, ix].contiguous(), kp[:, ix].contiguous()
    before = build.LAUNCHES["snapkv_scores"]
    out = snapkv_scores_cuda(q, k, op, kp, cap)
    torch.cuda.synchronize()
    assert build.LAUNCHES["snapkv_scores"] == before + 1
    ref = snapkv_scores_ref(q, k, op, kp, cap)
    assert bool(((out - ref).abs() <= 1e-4 + 1e-5 * ref.abs()).all())
    mass = out.sum(-1)
    assert torch.allclose(mass, torch.full_like(mass, W * Hq // Hkv), rtol=1e-4)
    assert not bool(out[..., valid:].any())


def test_prefix_run_trace_cuda_matches_cpu():
    """Chunked prefill with prefix sharing on the card: the CPU path's
    tokens, hits and CoW-free topology (fp32 weights); kernel 2 runs once
    per layer per chunk."""
    from repro_torch.api import PrefixConfig
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernels have no CPU mode)")
    kw = dict(max_seq_len=256, cache_backend="paged", paging=PagingConfig(block_size=16),
              compression=CompressionConfig(policy="none", budget=128, capacity=128,
                                            decode_margin=8, obs_window=8),
              planner=PlannerConfig(batch_cap=3),
              scheduler=SchedulerConfig(max_rows=3, enable_replan=False),
              prefix=PrefixConfig(enabled=True, chunk_tokens=16))
    cpu = Engine.build(EngineConfig.smoke("minitron-8b", device="cpu", **kw))
    params = {"embed": cpu.params["embed"].cuda(), "head": cpu.params["head"].cuda(),
              "final_norm": cpu.params["final_norm"].cuda(),
              "layers": [{k: v.cuda() for k, v in pl.items()} for pl in cpu.params["layers"]]}
    gpu = Engine.build(EngineConfig.smoke("minitron-8b", device="cuda", **kw), params=params)
    traces = [synthesize_requests(6, 0.4, cpu.cfg.model.vocab_size, min_prompt=36,
                                  max_prompt=56, max_new_tokens=5, seed=1,
                                  prefix_templates=2, prefix_len=32, shared_fraction=0.8)
              for _ in range(2)]
    cpu.run_trace(traces[0])
    build.reset_launches()
    gpu.run_trace(traces[1])
    assert [r.generated for r in traces[0]] == [r.generated for r in traces[1]]
    assert gpu.prefix_stats() == cpu.prefix_stats() and gpu.prefix_stats()["hits"] >= 1
    chunks = len(gpu.scheduler.chunk_s)
    assert build.LAUNCHES["snapkv_scores"] == cpu.cfg.model.n_layers * chunks > 0
    assert [r.prefix_hit_tokens for r in traces[0]] == [r.prefix_hit_tokens for r in traces[1]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,G,Dh,C,window,cap", [
    (2, 5, 4, 128, 1600, 0, 0.0), (2, 5, 4, 128, 1600, 500, 30.0),
    (8, 16, 4, 128, 576, 0, 0.0), (3, 5, 8, 32, 96, 40, 50.0),
    (2, 5, 2, 256, 1600, 500, 50.0), (4, 16, 2, 256, 576, 0, 0.0), (2, 3, 8, 256, 200, 0, 0.0)])
def test_fairkv_decode_kernel_bitwise_paged(gen, dtype, B, S, G, Dh, C, window, cap):
    """The slot kernel equals the paged kernel bitwise on the same cache
    laid out as pools with an identity block table, at lengths from one
    entry to one to many ring stages per block."""
    from repro_torch.kernels.fairkv_decode import fairkv_decode_cuda
    from repro_torch.kernels.paged_fairkv_decode import paged_fairkv_decode_cuda
    from repro_torch.paging.testing import slot_layer_as_pool
    q = torch.randn((B, S, G, Dh), generator=gen, device="cuda").to(dtype)
    k = torch.randn((S, B, C, Dh), generator=gen, device="cuda").to(dtype)
    v = torch.randn((S, B, C, Dh), generator=gen, device="cuda").to(dtype)
    if S * B == 10 and C == 1600:
        ln = torch.tensor([1, 7, 32, 33, 128, 129, 577, 1000, 1599, 1600],
                          dtype=torch.int32, device="cuda").reshape(S, B)
    else:
        ln = torch.randint(0, C + 1, (S, B), generator=gen, device="cuda", dtype=torch.int32)
    kp = torch.arange(C, dtype=torch.int32, device="cuda").expand(S, B, C).contiguous()
    qp = torch.full((B,), C + 7, dtype=torch.int32, device="cuda")
    out = fairkv_decode_cuda(q, k, v, ln, cap, k_pos=kp, q_pos=qp, window=window)
    pools = slot_layer_as_pool(k, v, kp, 16)
    paged = paged_fairkv_decode_cuda(q, *pools, ln, C, cap, q_pos=qp, window=window)
    torch.cuda.synchronize()
    assert torch.equal(out, paged)


def test_engine_cuda_matches_cpu(gen):
    comp = CompressionConfig(policy="ada_snapkv", budget=24, alpha_max=2.0,
                             obs_window=8, sink=2, decode_margin=8)
    plan = PlannerConfig(mode="fairkv_dp", extra_copies=4, batch_cap=2)
    prompts = np.random.default_rng(0).integers(0, 256, size=(2, 96)).astype(np.int32)
    cpu = Engine.build(EngineConfig.smoke("minitron-8b", n_shards=8, device="cpu",
                                          compression=comp, planner=plan))
    params = {"embed": cpu.params["embed"].cuda(), "head": cpu.params["head"].cuda(),
              "final_norm": cpu.params["final_norm"].cuda(),
              "layers": [{k: v.cuda() for k, v in pl.items()} for pl in cpu.params["layers"]]}
    gpu = Engine.build(EngineConfig.smoke("minitron-8b", n_shards=8, device="cuda",
                                          compression=comp, planner=plan), params=params)
    build.reset_launches()
    a, b = cpu.generate(prompts, 8), gpu.generate(prompts, 8)
    assert build.LAUNCHES == {"fairkv_decode": 2 * 8, "snapkv_scores": 2,
                              "paged_fairkv_decode": 0, "paged_fairkv_decode_mq": 0}
    assert np.array_equal(a.tokens, b.tokens)
    assert np.array_equal(a.lengths, b.lengths)
    assert np.abs(a.logits - b.logits).max() < 1e-3


@pytest.mark.parametrize("mode", ["fp32", "bf16", "int8", "fp8", "mixed"])
@pytest.mark.parametrize("S,B,G,Dh,C,bs,window,cap", [
    (3, 2, 1, 64, 96, 16, 0, 0.0), (4, 3, 8, 32, 200, 8, 60, 0.0),
    (16, 8, 4, 128, 576, 16, 0, 30.0), (16, 4, 2, 256, 576, 16, 200, 50.0),
    (3, 2, 8, 256, 96, 8, 0, 0.0)])
def test_paged_fairkv_decode_kernel(gen, mode, S, B, G, Dh, C, bs, window, cap):
    from repro_torch.kernels.paged_fairkv_decode import paged_fairkv_decode_cuda
    rng = np.random.default_rng(S * 100 + C)
    pool_dt = torch.bfloat16 if mode == "bf16" else torch.float32
    q_dt = torch.bfloat16 if mode in ("bf16", "mixed") else torch.float32
    kp, vp, pp, tbl, ln = make_paged_layer(rng, S, B, C, bs, Dh, dtype=pool_dt, device="cuda")
    q = torch.from_numpy(rng.normal(size=(B, S, G, Dh)).astype(np.float32)).to("cuda", q_dt)
    qpos = torch.full((B,), C + 7, dtype=torch.int32, device="cuda")
    kw = {}
    if mode in ("int8", "fp8", "mixed"):
        kinds = {"int8": np.zeros(S), "fp8": np.ones(S), "mixed": np.arange(S) % 2}[mode]
        kinds = torch.from_numpy(kinds.astype(np.int32)).cuda()
        kp, vp, ks, vs = quantize_paged_layer(kp, vp, tbl, kinds)
        kw = dict(k_scale=ks, v_scale=vs, kinds=kinds)
    before = build.LAUNCHES["paged_fairkv_decode"]
    out = paged_fairkv_decode_cuda(q, kp, vp, pp, tbl, ln, C, cap, q_pos=qpos,
                                   window=window, **kw)
    torch.cuda.synchronize()
    assert build.LAUNCHES["paged_fairkv_decode"] == before + 1
    ref = paged_fairkv_decode_ref(q, kp, vp, pp, tbl, ln, C, cap, q_pos=qpos,
                                  window=window, **kw)
    tol = 1e-5 if q_dt == torch.float32 else 0.03
    assert (out.float() - ref.float()).abs().max().item() < tol
    empty = (ln == 0).T
    assert not bool(empty.any()) or out[empty].abs().max().item() == 0.0


@pytest.mark.parametrize("kv", ["fp32", "int8"])
def test_paged_run_trace_cuda_matches_cpu(gen, kv):
    """A short continuous trace on paged pools: the card's tokens equal the
    CPU path's (fp32 weights), the paged kernel carries every decode step,
    and the pool ends empty."""
    comp = CompressionConfig(policy="ada_snapkv", budget=12, alpha_max=2.0,
                             obs_window=8, sink=2, decode_margin=8)
    kw = dict(n_shards=4, compression=comp, cache_backend="paged",
              paging=PagingConfig(block_size=8, kv_dtype=kv),
              planner=PlannerConfig(mode="fairkv_dp", extra_copies=4, batch_cap=2),
              scheduler=SchedulerConfig(max_rows=2, replan_window=2,
                                        replan_threshold=1.01, replan_cooldown=2,
                                        replan_min_rows=1))
    cpu = Engine.build(EngineConfig.smoke("minitron-8b", device="cpu", **kw))
    params = {"embed": cpu.params["embed"].cuda(), "head": cpu.params["head"].cuda(),
              "final_norm": cpu.params["final_norm"].cuda(),
              "layers": [{k: v.cuda() for k, v in pl.items()} for pl in cpu.params["layers"]]}
    gpu = Engine.build(EngineConfig.smoke("minitron-8b", device="cuda", **kw), params=params)
    traces = [synthesize_requests(5, 0.5, cpu.cfg.model.vocab_size, min_prompt=12,
                                  max_prompt=24, max_new_tokens=6, seed=0) for _ in range(2)]
    a = cpu.run_trace(traces[0])
    build.reset_launches()
    b = gpu.run_trace(traces[1])
    assert a["finished"] == b["finished"] == 5
    assert [r.generated for r in traces[0]] == [r.generated for r in traces[1]]
    # one launch per layer per decode tick
    assert build.LAUNCHES["paged_fairkv_decode"] == cpu.cfg.model.n_layers * b["decode_ticks"] > 0
    assert build.LAUNCHES["fairkv_decode"] == 0
    assert gpu.scheduler.backend.pool.blocks_in_use() == 0


@pytest.mark.parametrize("mode", ["fp32", "bf16", "int8", "fp8", "mixed"])
@pytest.mark.parametrize("Q", [1, 3, 5])
@pytest.mark.parametrize("S,B,G,Dh,C,bs,window,cap", [
    (3, 2, 1, 64, 96, 16, 0, 0.0), (4, 3, 4, 32, 200, 8, 60, 30.0),
    (16, 8, 4, 128, 576, 16, 0, 0.0), (4, 3, 2, 256, 200, 16, 60, 50.0)])
def test_paged_fairkv_decode_mq_kernel(gen, mode, Q, S, B, G, Dh, C, bs, window, cap):
    from repro_torch.kernels.paged_fairkv_decode import (paged_fairkv_decode_cuda,
                                                         paged_fairkv_decode_mq_cuda)
    rng = np.random.default_rng(S * 100 + C + Q)
    pool_dt = torch.bfloat16 if mode == "bf16" else torch.float32
    q_dt = torch.bfloat16 if mode in ("bf16", "mixed") else torch.float32
    kp, vp, pp, tbl, ln = make_paged_layer(rng, S, B, C, bs, Dh, dtype=pool_dt, device="cuda")
    q = torch.from_numpy(rng.normal(size=(B, S, Q, G, Dh)).astype(np.float32)).to("cuda", q_dt)
    q_lens = torch.from_numpy(rng.integers(1, Q + 1, size=B).astype(np.int32)).cuda()
    qpos = torch.full((B,), C + 7, dtype=torch.int32, device="cuda")
    kw = {}
    if mode in ("int8", "fp8", "mixed"):
        kinds = {"int8": np.zeros(S), "fp8": np.ones(S), "mixed": np.arange(S) % 2}[mode]
        kinds = torch.from_numpy(kinds.astype(np.int32)).cuda()
        kp, vp, ks, vs = quantize_paged_layer(kp, vp, tbl, kinds)
        kw = dict(k_scale=ks, v_scale=vs, kinds=kinds)
    args = (q, kp, vp, pp, tbl, ln, C, cap)
    before = build.LAUNCHES["paged_fairkv_decode_mq"]
    out = paged_fairkv_decode_mq_cuda(*args, q_pos=qpos, window=window, q_lens=q_lens, **kw)
    torch.cuda.synchronize()
    assert build.LAUNCHES["paged_fairkv_decode_mq"] == before + 1
    ref = paged_fairkv_decode_ref(*args, q_pos=qpos, window=window, q_lens=q_lens, **kw)
    rel = 0.0 if q_dt == torch.float32 else 2.0 ** -7
    err = (out.float() - ref.float()).abs()
    assert bool((err <= 1e-4 + rel * ref.float().abs()).all())
    empty = (ln == 0).T
    assert not bool(empty.any()) or out[empty].abs().max().item() == 0.0
    if Q == 1:  # the single-query kernel's arithmetic, bit for bit
        single = paged_fairkv_decode_cuda(q[:, :, 0].contiguous(), kp, vp, pp, tbl, ln, C,
                                          cap, q_pos=qpos, window=window, **kw)
        assert torch.equal(single, out[:, :, 0])


def _quant_layer(rng, mode, S, B, C, bs, Dh, lengths=None):
    """A paged layer for the card checks: pools in ``mode`` (fp32, bf16, or
    int8 / fp8 / mixed codes with their scales and kinds) and q's dtype."""
    pool_dt = torch.bfloat16 if mode == "bf16" else torch.float32
    q_dt = torch.bfloat16 if mode in ("bf16", "mixed") else torch.float32
    kp, vp, pp, tbl, ln = make_paged_layer(rng, S, B, C, bs, Dh, dtype=pool_dt,
                                           lengths=lengths, device="cuda")
    kw = {}
    if mode in ("int8", "fp8", "mixed"):
        kinds = {"int8": np.zeros(S), "fp8": np.ones(S), "mixed": np.arange(S) % 2}[mode]
        kinds = torch.from_numpy(kinds.astype(np.int32)).cuda()
        kp, vp, ks, vs = quantize_paged_layer(kp, vp, tbl, kinds)
        kw = dict(k_scale=ks, v_scale=vs, kinds=kinds)
    return kp, vp, pp, tbl, ln, kw, q_dt


def _single_per_query(q, kp, vp, pp, tbl, ln, C, cap, qpos, window, q_lens, kw):
    """Kernel 3 run once per query i of a 5-D q, at the query's causal
    lengths and q_pos + i."""
    from repro_torch.kernels.paged_fairkv_decode import paged_fairkv_decode_cuda
    return torch.stack([paged_fairkv_decode_cuda(q[:, :, i].contiguous(), kp, vp, pp, tbl,
                                                 query_lengths(ln, q_lens, i), C, cap,
                                                 q_pos=qpos + i, window=window, **kw)
                        for i in range(q.shape[2])], dim=2)


@pytest.mark.parametrize("mode", ["fp32", "bf16", "int8", "fp8", "mixed"])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (60, 0.0), (0, 30.0), (60, 30.0)])
@pytest.mark.parametrize("G,Dh", [(4, 128), (2, 256)])
def test_paged_fairkv_decode_mq_query_is_single_query(gen, mode, window, cap, G, Dh):
    """Query i of the multi-query kernel is, bitwise, the single-query
    kernel at the query's causal length and position."""
    from repro_torch.kernels.paged_fairkv_decode import paged_fairkv_decode_mq_cuda
    S, B, C, bs, Q = 4, 3, 200, 16, 5
    rng = np.random.default_rng(70)
    kp, vp, pp, tbl, ln, kw, q_dt = _quant_layer(rng, mode, S, B, C, bs, Dh)
    q = torch.from_numpy(rng.normal(size=(B, S, Q, G, Dh)).astype(np.float32)).to("cuda", q_dt)
    q_lens = torch.tensor([5, 2, 4], dtype=torch.int32, device="cuda")
    qpos = torch.full((B,), C + 7, dtype=torch.int32, device="cuda")
    out = paged_fairkv_decode_mq_cuda(q, kp, vp, pp, tbl, ln, C, cap, q_pos=qpos,
                                      window=window, q_lens=q_lens, **kw)
    single = _single_per_query(q, kp, vp, pp, tbl, ln, C, cap, qpos, window, q_lens, kw)
    torch.cuda.synchronize()
    assert torch.equal(out, single)


def _permute(kp, vp, pp, tbl, kw, seed):
    keys = [k for k in ("k_scale", "v_scale") if k in kw]
    *layer, scales = relabel_pool_blocks(kp, vp, pp, tbl, [kw[k] for k in keys], seed=seed)
    return (*layer, dict(kw, **dict(zip(keys, scales))))


@pytest.mark.parametrize("mode", ["bf16", "int8", "mixed"])
@pytest.mark.parametrize("Q", [1, 5])
@pytest.mark.parametrize("G,Dh", [(4, 128), (2, 256)])
def test_paged_kernels_permuted_pools(gen, mode, Q, G, Dh):
    """Kernels 3 and 4 on pools whose blocks are relabelled, through the
    remapped table, give bitwise the output of the original layer."""
    from repro_torch.kernels.paged_fairkv_decode import (paged_fairkv_decode_cuda,
                                                         paged_fairkv_decode_mq_cuda)
    S, B, C, bs = 16, 8, 576, 16
    rng = np.random.default_rng(71 + Q)
    kp, vp, pp, tbl, ln, kw, q_dt = _quant_layer(rng, mode, S, B, C, bs, Dh)
    kp2, vp2, pp2, tbl2, kw2 = _permute(kp, vp, pp, tbl, kw, 72)
    qpos = torch.full((B,), C + 7, dtype=torch.int32, device="cuda")
    q = torch.from_numpy(rng.normal(size=(B, S, Q, G, Dh)).astype(np.float32)).to("cuda", q_dt)
    q_lens = torch.from_numpy(rng.integers(1, Q + 1, size=B).astype(np.int32)).cuda()
    for window, cap in ((0, 0.0), (C // 3, 30.0)):
        a = paged_fairkv_decode_mq_cuda(q, kp, vp, pp, tbl, ln, C, cap, q_pos=qpos,
                                        window=window, q_lens=q_lens, **kw)
        b = paged_fairkv_decode_mq_cuda(q, kp2, vp2, pp2, tbl2, ln, C, cap, q_pos=qpos,
                                        window=window, q_lens=q_lens, **kw2)
        q3 = q[:, :, -1].contiguous()
        c = paged_fairkv_decode_cuda(q3, kp, vp, pp, tbl, ln, C, cap, q_pos=qpos,
                                     window=window, **kw)
        d = paged_fairkv_decode_cuda(q3, kp2, vp2, pp2, tbl2, ln, C, cap, q_pos=qpos,
                                     window=window, **kw2)
        torch.cuda.synchronize()
        assert not torch.equal(tbl, tbl2)
        assert torch.equal(a, b) and torch.equal(c, d)


@pytest.mark.parametrize("mode", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("G,Q", [(1, 9), (1, 40), (8, 5), (2, 7)])
@pytest.mark.parametrize("Dh", [64, 256])
def test_paged_fairkv_decode_mq_query_chunks(gen, mode, G, Q, Dh):
    """Shapes whose queries split over several chunks of the grid (and the
    widest tile, G = 8 at Q = 5): within the plain version's tolerance, and
    every query bitwise equal to the single-query kernel."""
    from repro_torch.kernels.paged_fairkv_decode import paged_fairkv_decode_mq_cuda
    S, B, C, bs = 3, 4, 300, 16
    rng = np.random.default_rng(73 + G * 100 + Q)
    kp, vp, pp, tbl, ln, kw, q_dt = _quant_layer(rng, mode, S, B, C, bs, Dh)
    q = torch.from_numpy(rng.normal(size=(B, S, Q, G, Dh)).astype(np.float32)).to("cuda", q_dt)
    q_lens = torch.from_numpy(rng.integers(1, Q + 1, size=B).astype(np.int32)).cuda()
    q_lens[0] = Q
    qpos = torch.full((B,), C + 7, dtype=torch.int32, device="cuda")
    for window, cap in ((0, 0.0), (C // 3, 30.0)):
        args = (q, kp, vp, pp, tbl, ln, C, cap)
        out = paged_fairkv_decode_mq_cuda(*args, q_pos=qpos, window=window, q_lens=q_lens, **kw)
        ref = paged_fairkv_decode_ref(*args, q_pos=qpos, window=window, q_lens=q_lens, **kw)
        single = _single_per_query(q, kp, vp, pp, tbl, ln, C, cap, qpos, window, q_lens, kw)
        torch.cuda.synchronize()
        rel = 0.0 if q_dt == torch.float32 else 2.0 ** -7
        err = (out.float() - ref.float()).abs()
        assert bool((err <= 1e-4 + rel * ref.float().abs()).all())
        assert torch.equal(out, single)


@pytest.mark.parametrize("mode", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("bs", [8, 16, 32])
def test_paged_kernels_many_ring_stages(gen, mode, bs):
    """Lengths up to 1600 (up to 50 ring stages per block at G = 1, 13 at
    G = 4): both kernels within the plain version's tolerance, kernel 4's
    queries bitwise equal to kernel 3."""
    from repro_torch.kernels.paged_fairkv_decode import (paged_fairkv_decode_cuda,
                                                         paged_fairkv_decode_mq_cuda)
    C = 1600
    lengths = np.array([[1, 7, 32, 33, 128], [129, 577, 1000, 1599, 1600]], np.int32)
    S, B = lengths.shape
    for G, Dh in ((1, 128), (4, 128)):
        rng = np.random.default_rng(74 + bs + G)
        kp, vp, pp, tbl, ln, kw, q_dt = _quant_layer(rng, mode, S, B, C, bs, Dh, lengths)
        q = torch.from_numpy(rng.normal(size=(B, S, 3, G, Dh)).astype(np.float32)).to(
            "cuda", q_dt)
        q_lens = torch.full((B,), 3, dtype=torch.int32, device="cuda")
        qpos = torch.full((B,), C + 7, dtype=torch.int32, device="cuda")
        for window, cap in ((0, 0.0), (500, 30.0)):
            args = (q, kp, vp, pp, tbl, ln, C, cap)
            out = paged_fairkv_decode_mq_cuda(*args, q_pos=qpos, window=window,
                                              q_lens=q_lens, **kw)
            ref = paged_fairkv_decode_ref(*args, q_pos=qpos, window=window, q_lens=q_lens,
                                          **kw)
            one = paged_fairkv_decode_cuda(q[:, :, -1].contiguous(), kp, vp, pp, tbl, ln, C,
                                           cap, q_pos=qpos + 2, window=window, **kw)
            single = _single_per_query(q, kp, vp, pp, tbl, ln, C, cap, qpos, window,
                                       q_lens, kw)
            torch.cuda.synchronize()
            rel = 0.0 if q_dt == torch.float32 else 2.0 ** -7
            err = (out.float() - ref.float()).abs()
            assert bool((err <= 1e-4 + rel * ref.float().abs()).all())
            assert torch.equal(out, single) and torch.equal(one, out[:, :, -1])


def test_spec_run_trace_cuda_matches_cpu(gen):
    """A short speculative trace (1-layer draft) on paged fp32 pools: the
    card's tokens equal the CPU path's and the plain run's; the mq kernel
    carries every verify and the paged kernel every draft step."""
    comp = CompressionConfig(policy="none", budget=64, capacity=64, alpha_max=1.0,
                             obs_window=8, sink=2, decode_margin=8)
    kw = dict(n_shards=4, max_seq_len=38, compression=comp, cache_backend="paged",
              paging=PagingConfig(block_size=8),
              planner=PlannerConfig(mode="fairkv_dp", extra_copies=6, batch_cap=4),
              scheduler=SchedulerConfig(max_rows=4, enable_replan=False))
    spec = SpeculationConfig(enabled=True, max_k=3, draft_layers=1)
    cpu = Engine.build(EngineConfig.smoke("minitron-8b", device="cpu", speculation=spec, **kw))
    params = {"embed": cpu.params["embed"].cuda(), "head": cpu.params["head"].cuda(),
              "final_norm": cpu.params["final_norm"].cuda(),
              "layers": [{k: v.cuda() for k, v in pl.items()} for pl in cpu.params["layers"]]}
    gpu = Engine.build(EngineConfig.smoke("minitron-8b", device="cuda", speculation=spec,
                                          **kw), params=params)
    plain = Engine.build(EngineConfig.smoke("minitron-8b", device="cuda", **kw), params=params)
    traces = [synthesize_requests(6, 0.5, cpu.cfg.model.vocab_size, min_prompt=8,
                                  max_prompt=20, max_new_tokens=10, seed=3) for _ in range(3)]
    a = cpu.run_trace(traces[0])
    plain.run_trace(traces[2])
    build.reset_launches()
    b = gpu.run_trace(traces[1])
    assert a["finished"] == b["finished"] == 6
    assert [r.generated for r in traces[0]] == [r.generated for r in traces[1]]
    assert [r.generated for r in traces[2]] == [r.generated for r in traces[1]]
    nL = cpu.cfg.model.n_layers
    assert build.LAUNCHES["paged_fairkv_decode_mq"] == nL * b["decode_ticks"] > 0
    assert build.LAUNCHES["paged_fairkv_decode"] == 1 * 3 * b["decode_ticks"]
    assert gpu.scheduler.backend.pool.blocks_in_use() == 0


# ---------------------------------------------------------------------------
# CUDA-graph execution against eager execution
# ---------------------------------------------------------------------------

# a build profile that misplaces heads for the realized lengths, so the
# first replan of the trace is accepted (see tests/test_torch_executor.py)
_SKEWED = np.array([[100.0, 1.0], [1.0, 1.0]])


def _graph_cfg(mode, device="cuda"):
    """Smoke config with replanning that fires: ``mode`` "spec"
    (speculation), "chunked" (paged, chunked prefill with sharing) or
    "slot" (slot backend, chunked prefill without sharing)."""
    from repro_torch.api import PrefixConfig
    kw = dict(n_shards=2, max_seq_len=128, cache_backend="paged",
              paging=PagingConfig(block_size=8),
              compression=CompressionConfig(policy="ada_snapkv", budget=16, obs_window=8,
                                            sink=2, decode_margin=8),
              planner=PlannerConfig(mode="fairkv_dp", batch_cap=3, slots_per_shard=2,
                                    r_max=1),
              scheduler=SchedulerConfig(max_rows=3, collect_logits=True, replan_window=2,
                                        replan_threshold=1.01, replan_cooldown=4,
                                        replan_min_rows=1))
    if mode == "spec":
        kw["speculation"] = SpeculationConfig(enabled=True, max_k=3, draft_layers=1)
    else:
        kw["prefix"] = PrefixConfig(enabled=mode == "chunked", chunk_tokens=16)
    if mode == "slot":
        kw["cache_backend"] = "slot"
    return EngineConfig.smoke("minitron-8b", device=device, **kw)


def _mixed_trace(vocab):
    return synthesize_requests(6, 0.5, vocab, min_prompt=36, max_prompt=56,
                               max_new_tokens=12, seed=4, prefix_templates=1,
                               prefix_len=32, shared_fraction=0.7)


def mixed_run(eng, reqs, prompts, tick=3, new_tokens=4):
    """Both modes on one engine: `warmup`, a one-shot `generate` before the
    first tick and another after tick ``tick`` while requests are live,
    the trace streamed to its end.  Returns the two results and the plan
    each ran under."""
    eng.warmup()
    outs, plans = [eng.generate(prompts, new_tokens)], [eng.plan]
    for ev in eng.stream(reqs):
        if ev.step >= tick and len(outs) == 1:
            assert eng.scheduler.active
            outs.append(eng.generate(prompts, new_tokens))
            plans.append(eng.plan)
    return outs, plans


def _eager(eng):
    from repro_torch.exec.local import LocalExecutor
    c = eng.cfg
    eng.executor = LocalExecutor(c.model, c.compression, paging=c.paging, device=eng.device,
                                 graphs=False)
    return eng


@pytest.mark.parametrize("mode", ["chunked", "spec"])
def test_graphs_match_eager_trace(gen, mode):
    """A continuous trace with replanning, through CUDA graphs and eagerly:
    bitwise the same logits and tokens, the same replan decisions and
    prefix hits.  ``Engine.warmup`` captures every step the trace runs
    (decode, and prefill_chunk or propose + verify); the trace, with its
    replans, splices, retirements and copy-on-write, captures nothing more
    (graphs are keyed by the storage they run on, so a moved tensor would
    show as a capture)."""
    cfg = _graph_cfg(mode)
    graphed = Engine.build(cfg, profile=_SKEWED)
    eager = _eager(Engine.build(cfg, params=graphed.params, profile=_SKEWED))
    traces = [synthesize_requests(6, 0.5, cfg.model.vocab_size, min_prompt=36,
                                  max_prompt=56, max_new_tokens=12, seed=4,
                                  prefix_templates=1, prefix_len=32, shared_fraction=0.7)
              for _ in range(2)]
    graphed.warmup()
    ex = graphed.executor
    captured = dict(ex.step_traces)
    expect = {"prefill": 0, "decode": 1, "prefill_chunk": int(mode == "chunked"),
              "propose": int(mode == "spec"), "verify": int(mode == "spec")}
    assert captured == expect
    a = graphed.run_trace(traces[0])
    b = eager.run_trace(traces[1])
    assert ex.step_traces == captured
    assert eager.executor.step_traces == {k: 0 for k in captured}
    assert a["replans"] >= 1
    assert [e["accepted"] for e in a["replan_log"]] == [e["accepted"] for e in b["replan_log"]]
    assert a["finished"] == b["finished"] == 6
    for x, y in zip(traces[0], traces[1]):
        assert x.generated == y.generated
        assert all(np.array_equal(p, q) for p, q in zip(x.logits, y.logits))
    assert graphed.prefix_stats() == eager.prefix_stats()


def test_graphs_match_eager_generate(gen):
    """One-shot generate: the captured decode step gives the eager step's
    logits bit for bit; a second generate and a replan between them
    capture nothing more."""
    from repro_torch.api import PrefixConfig
    cfg = _graph_cfg("chunked").replace(cache_backend="slot", prefix=PrefixConfig())
    graphed = Engine.build(cfg)
    eager = _eager(Engine.build(cfg, params=graphed.params))
    prompts = np.random.default_rng(2).integers(0, 256, size=(3, 40))
    a, b = graphed.generate(prompts, 6), eager.generate(prompts, 6)
    assert np.array_equal(a.tokens, b.tokens) and np.array_equal(a.logits, b.logits)
    assert np.array_equal(a.lengths, b.lengths)
    flipped = np.ascontiguousarray(graphed.profile[:, ::-1])
    graphed.replan(profile=flipped)
    eager.replan(profile=flipped)
    a, b = graphed.generate(prompts, 6), eager.generate(prompts, 6)
    assert np.array_equal(a.tokens, b.tokens) and np.array_equal(a.logits, b.logits)
    assert graphed.executor.step_traces["decode"] == 1
    assert graphed.executor.replays["decode"] == 2 * 6 - 1


@pytest.mark.parametrize("mode", ["slot", "chunked"])
def test_graphs_generate_between_ticks(gen, mode):
    """One engine serving a one-shot `generate` beside its live scheduler,
    whose state has the one-shot state's layout: the two states get a
    decode graph each, and neither run disturbs the other.  The graphed
    engine gives the eager engine's one-shot logits and the trace's
    tokens and logits bit for bit; the second generate and the ticks
    capture nothing more."""
    cfg = _graph_cfg(mode)
    graphed = Engine.build(cfg, profile=_SKEWED)
    eager = _eager(Engine.build(cfg, params=graphed.params, profile=_SKEWED))
    prompts = np.random.default_rng(2).integers(0, 256, size=(3, 40))
    traces = [_mixed_trace(cfg.model.vocab_size) for _ in range(2)]
    a, _ = mixed_run(graphed, traces[0], prompts)
    from repro_torch.serving.engine import state_layout
    assert state_layout(graphed._live) == state_layout(graphed.scheduler.state)
    b, _ = mixed_run(eager, traces[1], prompts)
    for x, y in zip(a, b):
        assert np.array_equal(x.tokens, y.tokens) and np.array_equal(x.logits, y.logits)
    for x, y in zip(traces[0], traces[1]):
        assert x.generated == y.generated
        assert all(np.array_equal(p, q) for p, q in zip(x.logits, y.logits))
    ex = graphed.executor
    assert ex.step_traces == {"prefill": 0, "decode": 2, "prefill_chunk": 1,
                              "propose": 0, "verify": 0}
    assert graphed.prefix_stats() == eager.prefix_stats()


@pytest.mark.parametrize("policy", ["headkv", "h2o"])
def test_graphs_policy_chunks_with_obs(gen, policy):
    """The chunked trace under `headkv` (per-head importance as a step
    input of the captured chunk step) and `h2o` (partial last chunks:
    the NaN rule inside a captured step), graphed with obs on against
    eager with obs off: bitwise the same tokens and logits, and
    ``stepfn_compiles_total`` equal to the executor's captures after
    `warmup` and unchanged by the trace."""
    import dataclasses
    from repro_torch.api import ObsConfig
    base = _graph_cfg("chunked")
    cfg = base.replace(compression=dataclasses.replace(base.compression, policy=policy))
    imp = np.array([[3.0, 1.0], [1.0, 2.0]]) if policy == "headkv" else None
    graphed = Engine.build(cfg, profile=_SKEWED, head_importance=imp)
    eager = _eager(Engine.build(cfg.replace(obs=ObsConfig(enabled=False)),
                                params=graphed.params, profile=_SKEWED, head_importance=imp))
    traces = [_mixed_trace(cfg.model.vocab_size) for _ in range(2)]
    graphed.warmup()
    ex, m = graphed.executor, graphed.obs.metrics

    def compiles():
        return {k: m.counter_value("stepfn_compiles_total", kind=k, executor="local")
                for k in ex.step_traces}
    warm = compiles()
    assert warm == {k: float(v) for k, v in ex.step_traces.items()}
    assert warm["decode"] == warm["prefill_chunk"] == 1
    a = graphed.run_trace(traces[0])
    b = eager.run_trace(traces[1])
    assert compiles() == warm
    assert a["finished"] == b["finished"] == 6
    for x, y in zip(traces[0], traces[1]):
        assert x.generated == y.generated
        assert all(np.array_equal(p, q) for p, q in zip(x.logits, y.logits))
    assert eager.metrics() == {}
    assert m.get("stepfn_wall_s").count(kind="prefill_chunk", executor="local") > 0


# ---------------------------------------------------------------------------
# the HTTP front end over a graphed engine
# ---------------------------------------------------------------------------


def test_http_over_graphs_matches_stream(gen):
    """`FrontendServer` over a graphed engine (paged pools, two rows): one
    prompt through ``/v1/generate`` and the SSE route gives `Engine.stream`'s
    tokens on that engine bitwise (one live row under the same graphs);
    three concurrent requests over three tenants all finish; the session
    captures nothing (the loop replays the warmup's graphs), and the pool
    ends empty."""
    import asyncio
    import json

    from repro_torch.api import Request
    from repro_torch.frontend import FrontendConfig, FrontendServer
    from repro_torch.api import PrefixConfig
    cfg = _graph_cfg("chunked").replace(
        prefix=PrefixConfig(), scheduler=SchedulerConfig(max_rows=2, enable_replan=False))
    eng = Engine.build(cfg)
    eng.warmup()
    prompt = np.random.default_rng(5).integers(1, 256, size=40).tolist()
    ref = [e.token for e in eng.stream([Request(req_id=10_000, prompt=np.asarray(
        prompt, np.int32), max_new_tokens=12)])]
    ex, m = eng.executor, eng.obs.metrics
    captured = dict(ex.step_traces)
    compiles = m.counter_value("stepfn_compiles_total", kind="decode", executor="local")

    async def call(host, port, path, payload):
        reader, writer = await asyncio.open_connection(host, port)
        body = json.dumps(payload).encode()
        writer.write(f"POST {path} HTTP/1.1\r\nContent-Length: {len(body)}\r\n\r\n".encode()
                     + body)
        await writer.drain()
        raw = await reader.read()
        writer.close()
        head, _, data = raw.partition(b"\r\n\r\n")
        return int(head.split()[1]), data

    async def session():
        server = FrontendServer(eng, FrontendConfig(port=0))
        await server.start()
        try:
            payload = {"prompt": prompt, "max_new_tokens": 12}
            status, data = await call(server.host, server.port, "/v1/generate", payload)
            assert status == 200
            via_json = json.loads(data)["tokens"]
            status, data = await call(server.host, server.port, "/v1/stream", payload)
            events = [json.loads(b.split(b"\ndata: ")[1]) for b in data.strip().split(b"\n\n")]
            via_sse = [e["token"] for e in events if e["type"] == "token"]
            assert [e["index"] for e in events[:-1]] == list(range(12))
            assert events[-1]["type"] == "end"
            rng = np.random.default_rng(6)
            many = await asyncio.gather(*[call(server.host, server.port, "/v1/generate", {
                "prompt": rng.integers(1, 256, size=30 + i).tolist(), "max_new_tokens": 8,
                "tenant": t}) for i, t in enumerate("abc")])
            assert all(s == 200 for s, _ in many)
            return via_json, via_sse
        finally:
            await server.shutdown(drain=True)

    via_json, via_sse = asyncio.run(session())
    assert via_json == ref and via_sse == ref
    assert ex.step_traces == captured
    assert m.counter_value("stepfn_compiles_total", kind="decode", executor="local") == compiles
    pool = eng.scheduler.backend.pool
    pool.check_invariants()
    assert pool.blocks_in_use() == 0


def _mesh_ranks():
    """`tests/_torch_mesh_ranks.py`, imported by its own name (the ranks
    import it so too; ``tests`` may name another installed package)."""
    import importlib
    import sys
    from pathlib import Path
    here = str(Path(__file__).resolve().parent)
    if here not in sys.path:
        sys.path.insert(0, here)
    return importlib.import_module("_torch_mesh_ranks")


@pytest.mark.parametrize("backend", ["slot", "paged"])
def test_mesh_nccl_graph_matches_local(gen, backend):
    """One NCCL rank: the mesh executor's decode is a CUDA graph with its
    all-reduce inside (one per layer per replay, counted from the
    capture), and its tokens and logits are the local executor's bitwise
    (an all-reduce over one rank is the identity)."""
    from repro_torch.launch.mesh import spawn
    R = _mesh_ranks()
    (out,) = spawn(R.card_rank, backend="nccl", args=(backend,), timeout=600)
    assert out["graphs"] and out["captures"]["decode"] == 1 and out["replays"]["decode"] >= 5
    assert np.array_equal(out["local"][0], out["mesh"][0])
    assert np.array_equal(out["local"][1], out["mesh"][1])
    assert out["collectives"] == {"model": {"all_reduce": {
        "calls": out["n_layers"], "elements": out["n_layers"] * 4 * 64,
        "bytes": out["n_layers"] * 4 * 64 * 4}}}


def test_mesh_gloo_shared_card_matches_local(gen):
    """Two gloo ranks sharing the card (model = 2): eager, gloo taking the
    CUDA tensors and copying them through host memory itself; each rank's
    tokens equal the local executor's, and the ranks agree bitwise."""
    from repro_torch.launch.mesh import spawn
    R = _mesh_ranks()
    outs = spawn(R.card_rank, model=2, backend="gloo", device="cuda", args=("paged",),
                 timeout=600)
    for out in outs:
        assert not out["graphs"] and set(out["captures"].values()) == {0}
        assert np.array_equal(out["local"][0], out["mesh"][0])
        np.testing.assert_allclose(out["mesh"][1], out["local"][1], rtol=1e-4, atol=1e-4)
        assert np.array_equal(out["mesh"][1], outs[0]["mesh"][1])


def test_moe_block_graph_equals_eager(gen):
    """`moe_block` at granite-moe-1b-a400m's width, bf16: captured in a CUDA
    graph it gives the eager result bitwise (the dispatch has no host sync
    and no data-dependent shape, and the combine no atomics), and two eager
    runs agree bitwise."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import init_moe_params, moe_block
    cfg = get_config("granite-moe-1b-a400m")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    pl = init_moe_params(cfg, g, torch.bfloat16, "cuda")
    h = torch.randn((8, 1, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    with torch.inference_mode():
        eager, _ = moe_block(pl, h, cfg)
        again, _ = moe_block(pl, h, cfg)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            moe_block(pl, h, cfg)  # warm the allocator outside the capture
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out, _ = moe_block(pl, h, cfg)
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(eager, again)
    assert torch.equal(out, eager)


@pytest.mark.parametrize("Dh", [192, 320])
def test_decode_kernels_refuse_other_head_dims(gen, Dh):
    """The decode kernels are built for head dims up to 128 and for 256; any
    other raises on the card (nothing falls back to the plain version),
    and the score kernel raises above 256."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.snapkv_select import snapkv_scores_cuda
    q = torch.randn((2, 4, 2, Dh), generator=gen, device="cuda")
    k = torch.randn((4, 2, 16, Dh), generator=gen, device="cuda")
    ln = torch.full((4, 2), 8, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        ops.fairkv_decode(q, k, k, ln)
    kp = torch.randn((5, 8, Dh), generator=gen, device="cuda")
    pp = torch.zeros((5, 8), dtype=torch.int32, device="cuda")
    tbl = torch.ones((4, 2, 2), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        ops.paged_fairkv_decode(q, kp, kp, pp, tbl, ln, 16)
    if Dh > 256:
        qo = torch.randn((1, 4, 2, Dh), generator=gen, device="cuda")
        ko = torch.randn((1, 16, 1, Dh), generator=gen, device="cuda")
        pos = torch.arange(16, dtype=torch.int32, device="cuda")[None]
        with pytest.raises(ValueError, match="head_dim"):
            snapkv_scores_cuda(qo, ko, pos[:, -4:].contiguous(), pos)
