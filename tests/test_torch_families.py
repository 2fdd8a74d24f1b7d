"""The port's dense family beyond minitron-8b against the JAX package, on the
CPU: gemma2-9b (sliding window on alternate layers, attention and logit
softcaps, the sqrt(d_model) embedding scale, tied embeddings), granite-3-2b
and qwen1.5-110b (qkv bias), one-shot.

Smoke configs in fp32 (4 shards, Ada-SnapKV budget 12, B=2 prompts of
T=24, 6 new tokens; gemma2's smoke window of 16 binds at T=24), the
reference's weights carried across with `repro_torch.interop`.  qwen1.5's
biases are drawn non-zero (the reference initialises them to zero, which
would hide a bias that never reaches the slot layout).  Required under
sha and fairkv_dp: identical greedy tokens and retained lengths, logits
within 1e-4 (fp32, summation order), and the port's plan invariance below
1e-3.  Also the init trees' shapes and the gemma2 embedding scale in fp32
and bf16, bitwise.  The continuous, chunked, speculative and replan runs
are in `tests/test_torch_families_trace.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import CompressionConfig as JCompression
from repro.api import Engine as JEngine
from repro.api import EngineConfig as JEngineConfig
from repro.api import PlannerConfig as JPlanner
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.models import transformer as JM
from repro_torch import interop
from repro_torch.api import CompressionConfig, Engine, EngineConfig, PlannerConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import transformer as M

torch.set_num_threads(2)

ARCHS = ["gemma2-9b", "granite-3-2b", "qwen1.5-110b"]
ALL_ARCHS = ARCHS + ["granite-moe-1b-a400m", "qwen3-moe-30b-a3b"]
B, T, GEN = 2, 24, 6
PLANNERS = [("sha", 0), ("fairkv_dp", 4)]
COMP = dict(policy="ada_snapkv", budget=12, alpha_max=2.0, obs_window=8, sink=2,
            decode_margin=8)
TOL = 1e-4


def configs(arch, mode="fairkv_dp", ch=4, **kw):
    """The same smoke EngineConfig in both packages (extra sections by
    keyword, each given as a (reference, port) pair)."""
    jkw = {k: v[0] for k, v in kw.items()}
    tkw = {k: v[1] for k, v in kw.items()}
    common = dict(n_shards=4, max_seq_len=T + GEN + 8)
    j = JEngineConfig.smoke(arch, compression=JCompression(**COMP),
                            planner=JPlanner(mode=mode, extra_copies=ch, batch_cap=B),
                            **common, **jkw)
    t = EngineConfig.smoke(arch, device="cpu", compression=CompressionConfig(**COMP),
                           planner=PlannerConfig(mode=mode, extra_copies=ch, batch_cap=B),
                           **common, **tkw)
    return j, t


def shared_params(jcfg, seed=0):
    """The reference's weights for ``jcfg`` in both packages; q/k/v biases,
    where the model has them, drawn non-zero from ``seed``."""
    tree = jax.tree.map(np.asarray, JEngine.build(jcfg).params)
    rng = np.random.default_rng(seed)
    for pl in tree["layers"]:
        for key in ("bq", "bk", "bv"):
            if key in pl:
                pl[key] = (0.5 * rng.standard_normal(pl[key].shape)).astype(pl[key].dtype)
    return jax.tree.map(jnp.asarray, tree), interop.to_torch(tree)


@pytest.fixture(scope="module")
def runs():
    out = {}
    for arch in ARCHS:
        jparams, tparams = shared_params(configs(arch)[0])
        prompts = np.random.default_rng(1).integers(0, 256, (B, T)).astype(np.int32)
        for mode, ch in PLANNERS:
            jc, tc = configs(arch, mode, ch)
            je = JEngine.build(jc, params=jparams)
            te = Engine.build(tc, params=tparams, profile=np.asarray(je.profile))
            out[arch, mode] = (je.generate(prompts, GEN), te.generate(prompts, GEN))
    return out


@pytest.mark.parametrize("mode", [m for m, _ in PLANNERS])
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference(runs, arch, mode):
    jr, tr = runs[arch, mode]
    assert np.array_equal(jr.tokens, tr.tokens)
    assert np.array_equal(np.asarray(jr.lengths), tr.lengths)
    assert np.abs(np.asarray(jr.logits) - tr.logits).max() < TOL
    assert jr.efficiency == tr.efficiency


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_invariance(runs, arch):
    base = runs[arch, "sha"][1]
    other = runs[arch, "fairkv_dp"][1]
    assert np.abs(other.logits - base.logits).max() < 1e-3
    assert np.array_equal(other.lengths, base.lengths)


def test_gemma2_window_binds(runs):
    """The smoke window (16) is shorter than the prompt, so the local
    layers' retained lengths stay inside it while a global layer's need
    not: the window rule is exercised, not vacuous."""
    cfg = get_smoke_config("gemma2-9b")
    assert cfg.sliding_window < T
    lens = runs["gemma2-9b", "sha"][1].lengths
    for i in range(cfg.n_layers):
        if cfg.layer_is_local(i):
            assert lens[i].max() <= cfg.sliding_window


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_init_params_shapes_match_reference(arch):
    """The port's init tree has the reference's keys and shapes (smoke
    widths): biases with qkv_bias, router and expert weights for MoE."""
    jcfg = jget_smoke(arch)
    jtree = jax.tree.map(np.shape, JM.init_params(jcfg, jax.random.PRNGKey(0),
                                                  dtype=jnp.float32))
    ttree = jax.tree.map(lambda t: tuple(t.shape),
                         M.init_params(get_smoke_config(arch), 0, torch.float32, "cpu"))
    assert jax.tree.structure(jtree) == jax.tree.structure(ttree)
    assert jax.tree.leaves(jtree) == jax.tree.leaves(ttree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemma2_embedding_scale(dtype):
    """`embed_tokens` scales by sqrt(d_model) cast to the activation dtype
    first (in bf16 the factor itself rounds), bitwise the reference's
    `embed_inputs`; the other archs are not scaled.  Full-width configs:
    the smoke width's factor, sqrt(64), is exact in any dtype."""
    tokens = np.random.default_rng(3).integers(0, 256, (2, 5)).astype(np.int32)
    table = np.random.default_rng(4).standard_normal((256, 64)).astype(np.float32)
    for arch, scaled in (("gemma2-9b", True), ("granite-3-2b", False)):
        jcfg = jget_config(arch)
        jt = jnp.asarray(table, getattr(jnp, dtype))
        jh, _ = JM.embed_inputs({"embed": jt}, {"tokens": jnp.asarray(tokens)}, jcfg)
        tt = interop.to_torch(np.asarray(jt))
        th = M.embed_tokens(torch.as_tensor(tokens).long(), {"embed": tt},
                            get_config(arch))
        assert th.dtype == tt.dtype
        assert np.array_equal(interop.to_numpy(th).view(np.uint8),
                              np.asarray(jh).view(np.uint8))
        assert scaled == (not torch.equal(th, tt[torch.as_tensor(tokens).long()]))
        if scaled and dtype == "bfloat16":  # the factor rounded before the product
            exact = (tt[torch.as_tensor(tokens).long()].float() * 3584 ** 0.5).bfloat16()
            assert not torch.equal(th, exact)
