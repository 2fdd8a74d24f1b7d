"""The port's training path against the JAX package, on the CPU: the
optimizer, the flash-attention backward, the dense attention's gradients,
`forward_train` per family and three train steps.

Inputs are made with numpy from a seed and fed to both packages; the
weights are the reference's (`repro_torch.interop`), fp32, with every norm
scale, bias and SSD vector drawn non-zero (the reference initialises them
to 0 or 1, values that hide a wrong sign or a dropped term).  Required:
- `lr_schedule` and `adamw_update` within 1e-6 relative;
- `flash_attention_vjp`'s dq / dk / dv against ``jax.grad`` of the
  reference's custom VJP over GQA, windows, softcap, K off the chunk and
  non-causal attention (1e-4), and `dense_attention`'s (1e-4), which
  stays bitwise the same with autograd off (its in-place serving path);
- `forward_train` logits and aux loss per family (dense with bias and
  softcaps, MoE, SSM, hybrid, encoder-decoder, VLM) within 1e-4, remat on
  and off bitwise equal in the port, and the loss's gradients within 1e-4,
  once past ``flash_threshold``;
- three train steps from the reference's init on granite and MoE smoke:
  losses, grad norms and params within 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import forward_train as jforward_train
from repro.models import init_params as jinit_params
from repro.models import layers as jL
from repro.training import optimizer as jopt
from repro.training import train_loop as jtl
from repro_torch import interop
from repro_torch.configs import InputShape, get_smoke_config
from repro_torch.models import forward_train
from repro_torch.models import layers as tL
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop as ttl
from repro_torch.training.data import SyntheticLM

torch.set_num_threads(2)
TOL = 1e-4

# drawn non-zero where present: 0.3 N(0, 1) + offset
NONZERO = {"ln1": 0.0, "ln2": 0.0, "ln_cross": 0.0, "attn_out_norm": 0.0, "ssm_norm": 0.0,
           "ssm_out_norm": 0.0, "bq": 0.0, "bk": 0.0, "bv": 0.0, "c_bq": 0.0, "c_bk": 0.0,
           "c_bv": 0.0, "A_log": 0.0, "dt_bias": 0.0, "ssm_D": 1.0}
FAMILIES = {  # name: (arch, overrides)
    "dense-bias": ("qwen1.5-110b", {}),
    "gemma2-softcap": ("gemma2-9b", {}),
    "moe": ("granite-moe-1b-a400m", {}),
    "ssm": ("mamba2-1.3b", {}),
    "hybrid": ("hymba-1.5b", {}),
    "encdec": ("whisper-small", {}),
    "vlm": ("llava-next-34b", {}),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def configs(arch, **over):
    """The arch's smoke config in both packages, with ``over`` applied."""
    return (dataclasses.replace(jget_smoke(arch), **over),
            dataclasses.replace(get_smoke_config(arch), **over))


def ref_params(jcfg, seed=0):
    """The reference's fp32 init as a numpy tree, the zero / one leaves
    drawn non-zero."""
    tree = jax.tree.map(np.asarray, jinit_params(jcfg, jax.random.PRNGKey(seed),
                                                 dtype=jnp.float32))
    rng = np.random.default_rng(seed + 1)

    def draw(d):
        for key, off in NONZERO.items():
            if key in d:
                d[key] = (0.3 * rng.standard_normal(d[key].shape) + off).astype(d[key].dtype)

    for pl in tree["layers"] + tree.get("enc_layers", []):
        draw(pl)
    for key in ("final_norm", "enc_final_norm"):
        if key in tree:
            tree[key] = (0.3 * rng.standard_normal(tree[key].shape)).astype(np.float32)
    return tree


def batch_of(tcfg, B, S, step=0):
    """A `SyntheticLM` batch (numpy) for the port's config."""
    return SyntheticLM(tcfg, InputShape("test", S, B, "train")).get_batch(step)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_n(got), np.asarray(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def _tree(rng):
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "layers": [{"w": rng.standard_normal((5,)).astype(np.float32)},
                       {"w": rng.standard_normal((2, 2)).astype(np.float32)}]}


@pytest.mark.parametrize("step", [0, 1, 5, 99, 100, 101, 5000, 10_000, 12_000])
def test_lr_schedule(step):
    cfg = topt.OptimizerConfig(lr=3e-4, warmup_steps=100, total_steps=10_000)
    jcfg = jopt.OptimizerConfig(lr=3e-4, warmup_steps=100, total_steps=10_000)
    got = topt.lr_schedule(cfg, torch.tensor(step, dtype=torch.int32))
    want = jopt.lr_schedule(jcfg, jnp.asarray(step, jnp.int32))
    np.testing.assert_allclose(_n(got), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("clip", [1.0, 0.0, 1e-3])
def test_adamw_update(clip):
    rng = np.random.default_rng(1)
    params = _tree(rng)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=clip)
    cfg, jcfg = topt.OptimizerConfig(**kw), jopt.OptimizerConfig(**kw)
    tstate = topt.init_optimizer(interop.to_torch(params))
    jstate = jopt.init_optimizer(jax.tree.map(jnp.asarray, params))
    for _ in range(3):
        grads = _tree(rng)
        tmaster, tstate, tm = topt.adamw_update(interop.to_torch(grads), tstate, cfg)
        jmaster, jstate, jm = jopt.adamw_update(jax.tree.map(jnp.asarray, grads), jstate, jcfg)
        for a, b in zip(topt.tree_leaves(tstate), jax.tree.leaves(jstate)):
            np.testing.assert_allclose(_n(a), np.asarray(b), rtol=1e-6, atol=1e-7)
        for a, b in zip(topt.tree_leaves(tmaster), jax.tree.leaves(jmaster)):
            np.testing.assert_allclose(_n(a), np.asarray(b), rtol=1e-6, atol=1e-7)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(_n(tm[key]), np.asarray(jm[key]), rtol=1e-6)
    assert int(tstate.step) == 3


def test_cast_like_and_leaf_order():
    rng = np.random.default_rng(2)
    tree = interop.to_torch(_tree(rng))
    assert [tuple(x.shape) for x in topt.tree_leaves(tree)] == [
        tuple(x.shape) for x in jax.tree.leaves(_tree(np.random.default_rng(2)))]
    live = topt.cast_like(tree, {"a": tree["a"].bfloat16(), "layers": tree["layers"]})
    assert live["a"].dtype == torch.bfloat16
    assert live["layers"][0]["w"].data_ptr() != tree["layers"][0]["w"].data_ptr()


# ---------------------------------------------------------------------------
# attention gradients
# ---------------------------------------------------------------------------


def _attn_inputs(seed, B, Q, K, Hq, Hkv, Dh):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Q, Hq, Dh)).astype(np.float32)
    k = rng.normal(size=(B, K, Hkv, Dh)).astype(np.float32)
    v = rng.normal(size=(B, K, Hkv, Dh)).astype(np.float32)
    w = rng.normal(size=(B, Q, Hq, Dh)).astype(np.float32)  # the loss's weights
    qpos = np.broadcast_to(np.arange(K - Q, K, dtype=np.int32), (B, Q)).copy()
    kpos = np.broadcast_to(np.arange(K, dtype=np.int32), (B, K)).copy()
    return q, k, v, w, qpos, kpos


def _port_grads(fn, q, k, v, w, qpos, kpos):
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    out = fn(tq, tk, tv, _t(qpos), _t(kpos))
    (out * _t(w)).sum().backward()
    return out.detach(), (tq.grad, tk.grad, tv.grad)


def _ref_grads(fn, q, k, v, w, qpos, kpos):
    def loss(q_, k_, v_):
        return jnp.sum(fn(q_, k_, v_, jnp.asarray(qpos), jnp.asarray(kpos)) * jnp.asarray(w))

    args = [jnp.asarray(x) for x in (q, k, v)]
    out = jax.jit(fn)(*args, jnp.asarray(qpos), jnp.asarray(kpos))
    return out, jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)


FLASH_CASES = [  # (B, Q, K, Hq, Hkv, Dh, window, cap, causal, chunk)
    (2, 40, 40, 4, 2, 16, 0, 0.0, True, 16),  # GQA, K off the chunk
    (1, 48, 48, 4, 1, 8, 9, 0.0, True, 16),  # window
    (2, 33, 33, 2, 2, 16, 0, 30.0, True, 64),  # softcap, one padded chunk
    (1, 24, 56, 6, 2, 8, 20, 25.0, True, 16),  # queries at the tail, window + softcap
    (2, 20, 36, 4, 2, 8, 0, 0.0, False, 16),  # non-causal (cross-attention)
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=[str(i) for i in range(len(FLASH_CASES))])
def test_flash_attention_vjp_grads(case):
    B, Q, K, Hq, Hkv, Dh, window, cap, causal, chunk = case
    inputs = _attn_inputs(sum(case[:6]), B, Q, K, Hq, Hkv, Dh)
    out, grads = _port_grads(
        lambda *a: tL.flash_attention_vjp(*a, window, cap, causal, chunk), *inputs)
    jout, jgrads = _ref_grads(
        lambda *a: jL.flash_attention_vjp(*a, window, cap, causal, chunk), *inputs)
    _close(out, jout)
    for g, jg in zip(grads, jgrads):
        _close(g, jg)
    # the forward is flash_attention's (no autograd), bitwise
    with torch.no_grad():
        plain = tL.flash_attention(*(_t(x) for x in inputs[:3]), _t(inputs[4]), _t(inputs[5]),
                                   window=window, attn_cap=cap, causal=causal, chunk=chunk)
    assert torch.equal(plain, out)


DENSE_CASES = [  # (B, Q, K, Hq, Hkv, Dh, window, cap, causal)
    (2, 12, 12, 4, 2, 8, 0, 0.0, True),
    (1, 16, 16, 4, 2, 8, 5, 30.0, True),
    (2, 6, 14, 2, 1, 16, 0, 0.0, False),
]


@pytest.mark.parametrize("case", DENSE_CASES, ids=[str(i) for i in range(len(DENSE_CASES))])
def test_dense_attention_grads(case):
    B, Q, K, Hq, Hkv, Dh, window, cap, causal = case
    inputs = _attn_inputs(7 + sum(case[:6]), B, Q, K, Hq, Hkv, Dh)
    kw = dict(window=window, attn_cap=cap, causal=causal)
    out, grads = _port_grads(lambda *a: tL.dense_attention(*a, **kw), *inputs)
    jout, jgrads = _ref_grads(lambda *a: jL.dense_attention(*a, **kw), *inputs)
    _close(out, jout)
    for g, jg in zip(grads, jgrads):
        _close(g, jg)
    with torch.inference_mode():  # the copy-free serving path: same numbers
        served = tL.dense_attention(*(_t(x) for x in inputs[:3]), _t(inputs[4]),
                                    _t(inputs[5]), **kw)
    assert torch.equal(served, out)


# ---------------------------------------------------------------------------
# forward_train per family
# ---------------------------------------------------------------------------


def _family_batch(tcfg, B, S):
    batch = batch_of(tcfg, B, S)
    return batch, {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    arch, over = FAMILIES[request.param]
    jcfg, tcfg = configs(arch, **over)
    tree = ref_params(jcfg)
    batch, jbatch = _family_batch(tcfg, 2, 24)
    jparams = jax.tree.map(jnp.asarray, tree)

    def ref(p):
        grads = jax.value_and_grad(jtl.loss_fn, has_aux=True)(p, jbatch, jcfg, False)
        return grads, jforward_train(p, jbatch, jcfg, remat=False)

    ((jl, _), jgrads), (jlogits, jaux) = jax.jit(ref)(jparams)
    return {"name": request.param, "tcfg": tcfg, "tree": tree, "batch": batch,
            "ref": (jlogits, jaux, jl, jgrads)}


def test_forward_train_matches_reference(family):
    tcfg, batch = family["tcfg"], interop.to_torch(family["batch"])
    params = interop.to_torch(family["tree"])
    jlogits, jaux, _, _ = family["ref"]
    with torch.no_grad():
        logits, aux = forward_train(params, batch, tcfg, remat=False)
        logits_r, aux_r = forward_train(params, batch, tcfg, remat=True)
    assert logits.shape == jlogits.shape
    _close(logits, jlogits)
    _close(aux, jaux)
    assert torch.equal(logits, logits_r) and torch.equal(aux, aux_r)
    if family["name"] == "moe":
        assert float(aux) > 0  # the Switch loss is kept for training


def test_forward_train_grads_match_reference(family):
    """The loss's gradients, with remat (the recomputing backward) and
    without, against ``jax.grad``: every leaf within 1e-4 (a leaf the
    forward never reads gets zeros in both)."""
    tcfg, batch = family["tcfg"], interop.to_torch(family["batch"])
    _, _, jl, jgrads = family["ref"]
    flat_ref = jax.tree.leaves(jgrads)
    for remat in (False, True):
        live = topt.tree_map(lambda x: x.requires_grad_(True),
                             interop.to_torch(family["tree"]))
        loss, _ = ttl.loss_fn(live, batch, tcfg, remat=remat)
        loss.backward()
        _close(loss, jl)
        grads = topt.tree_leaves(topt.tree_map(
            lambda x: x.grad if x.grad is not None else torch.zeros_like(x), live))
        assert len(grads) == len(flat_ref)
        for g, jg in zip(grads, flat_ref):
            _close(g, jg)


def test_forward_train_flash_past_threshold():
    """T = 2056 keys pass ``flash_threshold`` (2048): the forward and the
    loss's gradients run through `flash_attention_vjp` in both packages."""
    jcfg, tcfg = configs("granite-3-2b", n_layers=1)
    tree = ref_params(jcfg)
    batch, jbatch = _family_batch(tcfg, 1, 2056)
    jparams = jax.tree.map(jnp.asarray, tree)
    (jl, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtl.loss_fn(p, jbatch, jcfg, remat=False), has_aux=True))(jparams)
    live = topt.tree_map(lambda x: x.requires_grad_(True), interop.to_torch(tree))
    loss, _ = ttl.loss_fn(live, interop.to_torch(batch), tcfg, remat=True)
    loss.backward()
    _close(loss, jl)
    for g, jg in zip(topt.tree_leaves(topt.tree_map(lambda x: x.grad, live)),
                     jax.tree.leaves(jgrads)):
        _close(g, jg)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["granite-3-2b", "granite-moe-1b-a400m"])
def test_three_train_steps_match_reference(arch):
    jcfg, tcfg = configs(arch)
    tree = ref_params(jcfg)
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=3)
    jstep = jax.jit(jtl.make_train_step(jcfg, jopt.OptimizerConfig(**kw), remat=True))
    tstep = ttl.make_train_step(tcfg, topt.OptimizerConfig(**kw), remat=True)
    jp = jax.tree.map(jnp.asarray, tree)
    jo = jopt.init_optimizer(jp)
    tp = interop.to_torch(tree)
    to = topt.init_optimizer(tp)
    data = SyntheticLM(tcfg, InputShape("test", 16, 2, "train"))
    for s in range(3):
        batch = data.get_batch(s)
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in batch.items()})
        tp, to, tm = tstep(tp, to, interop.to_torch(batch))
        for key in ("loss", "xent", "aux", "grad_norm", "lr"):
            _close(tm[key], jm[key])
    for a, b in zip(topt.tree_leaves(tp), jax.tree.leaves(jp)):
        _close(a, b)
    for a, b in zip(topt.tree_leaves(to), jax.tree.leaves(jo)):
        _close(a, b)
