"""The port's CUDA kernels and CUDA path on the card (marker ``cuda``).

Skipped without a CUDA device; on the GPU machine run
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
Each kernel is held against its plain PyTorch version on the same inputs:
1e-4 absolute in fp32 (the summation order differs), plus one bf16 rounding
step relative for bf16 outputs (both sides round an fp32 result once).
"""
import numpy as np
import pytest
import torch

from repro_torch.api import CompressionConfig, Engine, EngineConfig, PlannerConfig
from repro_torch.kernels import build
from repro_torch.kernels.ref import fairkv_decode_ref, snapkv_scores_ref

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
    (8, 16, 4, 128, 576, 0, 50.0)])
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
    (2, 8, 8, 2, 64, 256, 0.0), (1, 4, 4, 4, 32, 100, 50.0), (2, 32, 32, 8, 128, 512, 0.0)])
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
    assert build.LAUNCHES == {"fairkv_decode": 2 * 8, "snapkv_scores": 2}
    assert np.array_equal(a.tokens, b.tokens)
    assert np.array_equal(a.lengths, b.lengths)
    assert np.abs(a.logits - b.logits).max() < 1e-3
