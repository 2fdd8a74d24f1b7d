"""Weight-only int8 serving in the port against the JAX package, on the CPU.

Required:
- `quantize_weight`: codes bitwise, scales equal and the dequantized bf16
  weight bitwise, for every channel axis of 2-D to 4-D weights, with ties
  at half a step (round half to even) and an all-zero channel (the scale
  floor);
- `quantize_serve_params` quantizes the same leaves with the same codes as
  the reference on a slotified tree wide enough that the weights cross the
  2^16-element threshold (d_model 256, vocab 512: the embedding and head
  too); `embed` / `unembed` through an int8 table bitwise;
- one-shot prefill plus 4 decode steps on int8 serve params, dense, MoE and
  hybrid, under sha and fairkv_dp: identical tokens and retained lengths,
  logits within 1e-4 (fp32).  In these runs the embedding and head stay
  under the threshold (vocab 128): a quantized embedding turns the
  activations bf16, where the reference's CPU backend fuses elementwise
  chains in fp32 and the packages part by bf16 steps (checked separately,
  at the embedding);
- a replan of a quantized engine leaves the serve tree in bf16 in both
  packages (the reference re-slotifies the original weights), and the
  next generate agrees;
- the mesh executor refuses a quantized tree with the reference's error.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Engine as JEngine
from repro.exec.mesh import MeshExecutor as JMeshExecutor
from repro.models import layers as jL
from repro.serving import quant as jq
from repro_torch import interop
from repro_torch.api import Engine
from repro_torch.exec.mesh import MeshExecutor
from repro_torch.models import layers as tL
from repro_torch.serving import quant as tq
from tests.test_torch_families import B, T, configs
from tests.test_torch_mesh import fake_mesh

torch.set_num_threads(2)
TOL = 1e-4
GEN = 4  # prefill, then 4 decode steps
# widths at which the projections cross 2^16 elements (the embedding and
# head too at vocab 512; at 128 they stay plain)
WIDE = {"dense": ("minitron-8b", dict(d_model=256, d_ff=512, head_dim=64)),
        "moe": ("granite-moe-1b-a400m", dict(d_model=256)),
        "hybrid": ("hymba-1.5b", dict(d_model=256, d_ff=512))}
MOE_D_EXPERT = 256


def wide_configs(name, vocab, mode="fairkv_dp", ch=4):
    """The smoke EngineConfig of ``name`` widened, in both packages."""
    arch, over = WIDE[name]
    out = []
    for cfg in configs(arch, mode, ch):
        m = dataclasses.replace(cfg.model, vocab_size=vocab, **over)
        if m.moe.num_experts:
            m = dataclasses.replace(m, moe=dataclasses.replace(m.moe, d_expert=MOE_D_EXPERT))
        out.append(cfg.replace(model=m))
    return out


def _bits(x):
    """The bits of a tensor / array (bf16 as int16)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


# ---------------------------------------------------------------------------
# quantize_weight / deq / embed
# ---------------------------------------------------------------------------


WEIGHTS = [(64, 48), (6, 32, 2, 16), (4, 20, 24), (8, 2, 16, 40)]


@pytest.mark.parametrize("shape", WEIGHTS, ids=[str(s) for s in WEIGHTS])
def test_quantize_weight_every_axis(shape):
    rng = np.random.default_rng(len(shape))
    w = (0.05 * rng.standard_normal(shape)).astype(np.float32)
    w[(0,) * (len(shape) - 1) + (slice(None),)] = 0.0  # a zero row: the scale floor
    for axis in range(-1, len(shape)):
        got = tq.quantize_weight(torch.from_numpy(w), axis)
        want = jq.quantize_weight(jnp.asarray(w), axis)
        assert got.q.dtype == torch.int8 and got.dtype == torch.bfloat16
        assert np.array_equal(got.q.numpy(), np.asarray(want.q))
        assert np.array_equal(got.scale.numpy(), np.asarray(want.scale))
        assert np.array_equal(_bits(tq.deq(got)), _bits(jq.deq(want)))
        assert got.shape == tuple(want.shape)


def test_quantize_weight_rounds_half_to_even():
    w = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -127.0]], np.float32)
    got = tq.quantize_weight(torch.from_numpy(w), 0)
    want = jq.quantize_weight(jnp.asarray(w), 0)
    assert got.q.tolist() == [[127, 0, 2, 2, 0, -2, 4, -127]]
    assert np.array_equal(got.q.numpy(), np.asarray(want.q))


def test_deq_passes_plain_tensors_and_operands_promote():
    w = torch.randn(4, 3)
    assert tq.deq(w) is w
    qt = tq.quantize_weight(torch.randn(4, 3), 1)
    x, wd = tq.operands(torch.randn(2, 4), qt)
    assert x.dtype == wd.dtype == torch.float32
    assert torch.equal(wd, tq.deq(qt).float())
    xb = torch.randn(2, 4).bfloat16()
    x2, w2 = tq.operands(xb, qt)
    assert x2 is xb and w2.dtype == torch.bfloat16


def test_embed_unembed_through_int8_tables():
    rng = np.random.default_rng(5)
    table = (0.02 * rng.standard_normal((300, 64))).astype(np.float32)
    tokens = rng.integers(0, 300, (2, 7)).astype(np.int32)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    jt, tt = jq.quantize_weight(jnp.asarray(table), 0), tq.quantize_weight(torch.from_numpy(table), 0)
    assert np.array_equal(_bits(tL.embed(torch.from_numpy(tokens), tt)),
                          _bits(jL.embed(jnp.asarray(tokens), jt)))
    got = tL.unembed(torch.from_numpy(x), tt, cap=30.0)
    want = jL.unembed(jnp.asarray(x), jt, cap=30.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# quantize_serve_params on slotified trees
# ---------------------------------------------------------------------------


def _quantized_leaves(tree, is_q, path=""):
    """{path: leaf} of the quantized leaves of a serve tree."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            if is_q(v):
                out[f"{path}/{k}"] = v
            else:
                out.update(_quantized_leaves(v, is_q, f"{path}/{k}"))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_quantized_leaves(v, is_q, f"{path}/{i}"))
    return out


@pytest.fixture(scope="module", params=sorted(WIDE))
def engines(request):
    """Both packages' engines on the reference's weights (vocab 512), serve
    trees quantized."""
    jc, tc = wide_configs(request.param, vocab=512)
    je = JEngine.build(jc)
    te = Engine.build(tc, params=interop.to_torch(jax.tree.map(np.asarray, je.params)),
                      profile=np.asarray(je.profile))
    return jq.quantize_serve_params(je.sp), tq.quantize_serve_params(te.sp)


def test_quantize_serve_params_same_leaves(engines):
    jsp, tsp = engines
    jl = _quantized_leaves(jsp, lambda v: isinstance(v, jq.QTensor))
    tl = _quantized_leaves(tsp, lambda v: isinstance(v, tq.QTensor))
    assert sorted(jl) == sorted(tl)
    keys = {p.rsplit("/", 1)[1] for p in tl}
    assert {"embed", "w1" if "/layers/0/w1" in tl else "we1"} <= keys
    for p, want in jl.items():
        got = tl[p]
        assert np.array_equal(got.q.numpy(), np.asarray(want.q)), p
        assert np.array_equal(got.scale.numpy(), np.asarray(want.scale)), p


# ---------------------------------------------------------------------------
# one-shot serving on int8 weights
# ---------------------------------------------------------------------------


def _oneshot_pair(name, mode, ch):
    jc, tc = wide_configs(name, vocab=128, mode=mode, ch=ch)
    je = JEngine.build(jc)
    te = Engine.build(tc, params=interop.to_torch(jax.tree.map(np.asarray, je.params)),
                      profile=np.asarray(je.profile))
    je.sp, te.sp = jq.quantize_serve_params(je.sp), tq.quantize_serve_params(te.sp)
    assert tq.has_qtensor(te.sp)
    prompts = np.random.default_rng(1).integers(0, 128, (B, T)).astype(np.int32)
    return je, te, prompts


def _same_run(jr, tr):
    assert np.array_equal(np.asarray(jr.tokens), tr.tokens)
    assert np.array_equal(np.asarray(jr.lengths), tr.lengths)
    np.testing.assert_allclose(tr.logits, np.asarray(jr.logits), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mode,ch", [("sha", 0), ("fairkv_dp", 4)])
@pytest.mark.parametrize("name", sorted(WIDE))
def test_int8_oneshot_matches_reference(name, mode, ch):
    je, te, prompts = _oneshot_pair(name, mode, ch)
    _same_run(je.generate(jnp.asarray(prompts), GEN), te.generate(prompts, GEN))


def test_int8_replan_returns_bf16_tree():
    """A one-shot replan re-slotifies the original-layout weights in both
    packages: the serve tree comes back unquantized and the next generate
    agrees with the reference's."""
    je, te, prompts = _oneshot_pair("dense", "fairkv_dp", 4)
    _same_run(je.generate(jnp.asarray(prompts), GEN), te.generate(prompts, GEN))
    sp = te.sp
    prof = np.asarray(je.profile)[:, ::-1].copy()
    je.replan(profile=prof)
    te.replan(profile=prof)
    assert te.sp is sp and not tq.has_qtensor(te.sp)
    assert not any(isinstance(v, jq.QTensor) for v in jax.tree.leaves(
        je.sp, is_leaf=lambda t: isinstance(t, jq.QTensor)))
    _same_run(je.generate(jnp.asarray(prompts), GEN), te.generate(prompts, GEN))


def test_mesh_refuses_quantized_tree():
    _, te, _ = _oneshot_pair("dense", "fairkv_dp", 4)
    msg = "mesh executor does not support quantized slot weights yet"
    with pytest.raises(NotImplementedError) as want:
        JMeshExecutor._check_quant(None, jq.quantize_serve_params(
            {"layers": [{"w1": jnp.ones((256, 512))}]}))
    assert str(want.value) == msg
    cfg = te.cfg
    ex = MeshExecutor(cfg.model, cfg.compression, mesh=fake_mesh())
    with pytest.raises(NotImplementedError) as got:
        ex._check(te.sp, te.pa)
    assert str(got.value) == msg
