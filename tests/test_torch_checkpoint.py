"""Checkpointing, resilience, gradient compression and the training CLI of
the port against the JAX package, on the CPU.

Required:
- save / restore bitwise (fp32, bf16, int32, an optimizer state, an int8
  weight), ``keep`` pruning, `latest_step`, the ``ValueError`` of a shape
  mismatch and the ``KeyError`` of a missing leaf;
- the leaf names, the manifest and every ``.npy`` file byte for byte the
  reference's for a ``{"params", "opt"}`` tree (bf16 leaves included);
- a reference checkpoint restored by the port continues as the reference
  does (losses and params within 1e-4), and a port checkpoint restored by
  the reference likewise; the reference cannot restore a bf16 leaf (numpy
  has no cast from the ``V2`` records it writes), the port restores it
  bitwise (ROADMAP C.10);
- `StragglerDetector` gives the reference's outputs on the same series,
  and `TrainingSupervisor` resumes from its newest checkpoint;
- the gradient-compression pieces bitwise (`compressed_all_reduce` runs in
  the 2-rank gloo spawn of `tests/test_torch_mesh.py`);
- ``python -m repro_torch.launch.train --smoke --device cpu`` resumed from
  its step-3 checkpoint ends with the uninterrupted run's step-6 tree,
  bitwise.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import checkpoint as jck
from repro.training import grad_compress as jgc
from repro.training import optimizer as jopt
from repro.training import resilience as jres
from repro.training import train_loop as jtl
from repro_torch import interop
from repro_torch.configs import InputShape
from repro_torch.serving import quant as tq
from repro_torch.training import checkpoint as tck
from repro_torch.training import grad_compress as tgc
from repro_torch.training import optimizer as topt
from repro_torch.training import resilience as tres
from repro_torch.training import train_loop as ttl
from repro_torch.training.data import SyntheticLM
from tests.test_torch_training import configs, ref_params

torch.set_num_threads(2)
TOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree():
    """A {"params", "opt"} tree in both packages: fp32 params of two
    layers, one bf16 leaf, and AdamW's state."""
    rng = np.random.default_rng(0)
    params = {"embed": rng.standard_normal((6, 4)).astype(np.float32),
              "layers": [{"w": rng.standard_normal((4, 3)).astype(np.float32),
                          "ln": rng.standard_normal((4,)).astype(np.float32)}
                         for _ in range(2)]}
    jparams = jax.tree.map(jnp.asarray, params)
    jparams["head"] = jnp.asarray(rng.standard_normal((6, 4)), jnp.bfloat16)
    jtree = {"params": jparams, "opt": jopt.init_optimizer(jparams)}
    ttree = interop.to_torch(jax.tree.map(np.asarray, jtree))
    return jtree, ttree


def _equal_trees(a, b):
    la, lb = topt.tree_leaves(a), topt.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)


def test_save_restore_bitwise(tmp_path):
    _, tree = _tree()
    tree["q"] = tq.quantize_weight(torch.randn(8, 300), 1)
    d = str(tmp_path / "ck")
    tck.save_checkpoint(d, 7, tree)
    assert tck.latest_step(d) == 7
    target = topt.tree_map(torch.zeros_like, {k: v for k, v in tree.items() if k != "q"})
    target["q"] = tq.QTensor(q=torch.zeros_like(tree["q"].q), scale=torch.zeros_like(tree["q"].scale))
    got = tck.restore_checkpoint(d, 7, target)
    assert isinstance(got["opt"], topt.AdamWState) and isinstance(got["q"], tq.QTensor)
    _equal_trees(got["params"], tree["params"])
    _equal_trees(list(got["opt"]), list(tree["opt"]))
    assert torch.equal(got["q"].q, tree["q"].q) and torch.equal(got["q"].scale, tree["q"].scale)
    assert got["params"]["head"].dtype == torch.bfloat16


def test_prune_latest_and_errors(tmp_path):
    d = str(tmp_path / "ck")
    assert tck.latest_step(d) is None
    for s in (1, 2, 3, 4):
        tck.save_checkpoint(d, s, {"p": torch.zeros(3)}, keep=2)
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]
    assert tck.latest_step(d) == 4
    with pytest.raises(ValueError, match="shape"):
        tck.restore_checkpoint(d, 4, {"p": torch.zeros(4)})
    with pytest.raises(KeyError, match="missing leaf q"):
        tck.restore_checkpoint(d, 4, {"p": torch.zeros(3), "q": torch.zeros(3)})


def test_async_checkpointer_one_in_flight(tmp_path):
    d = str(tmp_path / "ck")
    ck = tck.AsyncCheckpointer(d, keep=5)
    t = {"p": torch.arange(4.0)}
    for s in range(3):
        ck.save(s, t)
        t["p"] += 1  # the snapshot was taken before the write
    ck.wait()
    assert tck.latest_step(d) == 2
    for s in range(3):
        got = tck.restore_checkpoint(d, s, {"p": torch.zeros(4)})
        assert torch.equal(got["p"], torch.arange(4.0) + s)


def test_leaf_names_and_files_match_reference(tmp_path):
    jtree, ttree = _tree()
    names = [jck._leaf_name(p) for p, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    assert tck.leaf_names(ttree) == names
    assert names[:2] == ["opt__.step", "opt__.master__embed"]
    assert "params__layers__0__w" in names
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jck.save_checkpoint(jdir, 3, jtree)
    tck.save_checkpoint(tdir, 3, ttree)
    with open(os.path.join(jdir, "step_00000003", "manifest.json")) as f:
        jman = json.load(f)
    with open(os.path.join(tdir, "step_00000003", "manifest.json")) as f:
        assert json.load(f) == jman
    for leaf in jman["leaves"]:
        with open(os.path.join(jdir, "step_00000003", leaf["name"] + ".npy"), "rb") as f:
            jbytes = f.read()
        with open(os.path.join(tdir, "step_00000003", leaf["name"] + ".npy"), "rb") as f:
            assert f.read() == jbytes, leaf["name"]


def test_bf16_leaf_restores_in_the_port_only(tmp_path):
    """The reference writes a bf16 leaf as raw ``V2`` records and cannot
    cast them back; the port reads the bits (ROADMAP C.10)."""
    jtree, _ = _tree()
    d = str(tmp_path / "ck")
    jck.save_checkpoint(d, 1, jtree)
    with pytest.raises(ValueError, match="No cast function"):
        jck.restore_checkpoint(d, 1, jtree)
    target = interop.to_torch(jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), jtree))
    got = tck.restore_checkpoint(d, 1, target)
    want = interop.to_torch(jax.tree.map(np.asarray, jtree))
    _equal_trees(got["params"], want["params"])


# ---------------------------------------------------------------------------
# checkpoints across packages, then training on
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def granite():
    """granite-3-2b smoke: the reference's init, its jitted step, the
    port's step, and batches."""
    jcfg, tcfg = configs("granite-3-2b")
    tree = ref_params(jcfg)
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=4)
    data = SyntheticLM(tcfg, InputShape("test", 16, 2, "train"))
    return {"tree": tree,
            "jstep": jax.jit(jtl.make_train_step(jcfg, jopt.OptimizerConfig(**kw))),
            "tstep": ttl.make_train_step(tcfg, topt.OptimizerConfig(**kw)),
            "batches": [data.get_batch(s) for s in range(3)]}


def _jrun(g, state, steps):
    p, o = state["params"], state["opt"]
    for s in steps:
        p, o, m = g["jstep"](p, o, {k: jnp.asarray(v) for k, v in g["batches"][s].items()})
    return {"params": p, "opt": o}, m


def _trun(g, state, steps):
    p, o = state["params"], state["opt"]
    for s in steps:
        p, o, m = g["tstep"](p, o, interop.to_torch(g["batches"][s]))
    return {"params": p, "opt": o}, m


def _close_states(t, j):
    for a, b in zip(topt.tree_leaves([t["params"], list(t["opt"])]),
                    jax.tree.leaves([j["params"], list(j["opt"])])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL, atol=TOL)


def _init(tree):
    jp = jax.tree.map(jnp.asarray, tree)
    tp = interop.to_torch(tree)
    return {"params": jp, "opt": jopt.init_optimizer(jp)}, {"params": tp,
                                                           "opt": topt.init_optimizer(tp)}


def test_reference_checkpoint_continues_in_port(granite, tmp_path):
    jstate, tinit = _init(granite["tree"])
    jstate, _ = _jrun(granite, jstate, [0, 1])
    d = str(tmp_path / "ck")
    jck.save_checkpoint(d, 2, jstate)
    tstate = tck.restore_checkpoint(d, 2, tinit)
    assert int(tstate["opt"].step) == 2
    tstate, tm = _trun(granite, tstate, [2])
    jstate, jm = _jrun(granite, jstate, [2])
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=TOL)
    _close_states(tstate, jstate)


def test_port_checkpoint_continues_in_reference(granite, tmp_path):
    jinit, tstate = _init(granite["tree"])
    tstate, _ = _trun(granite, tstate, [0, 1])
    d = str(tmp_path / "ck")
    tck.save_checkpoint(d, 2, tstate)
    jstate = jck.restore_checkpoint(d, 2, jinit)
    jstate, jm = _jrun(granite, jstate, [2])
    tstate, tm = _trun(granite, tstate, [2])
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=TOL)
    _close_states(tstate, jstate)


# ---------------------------------------------------------------------------
# resilience
# ---------------------------------------------------------------------------


def test_straggler_detector_matches_reference():
    rng = np.random.default_rng(3)
    series = 1.0 + 0.05 * rng.standard_normal((30, 4))
    series[12:, 2] *= 1.8  # shard 2 slows down
    series[25:, 0] = 0.0
    a, b = tres.StragglerDetector(4), jres.StragglerDetector(4)
    flagged = 0
    for row in series:
        x, y = a.observe(row), b.observe(row)
        assert (x is None) == (y is None)
        if x is not None:
            flagged += 1
            assert np.array_equal(x, y)
    assert flagged > 0


def test_supervisor_resumes_from_newest(tmp_path):
    cfg = tres.SupervisorConfig(checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2)
    sup = tres.TrainingSupervisor(cfg, n_shards=2, on_straggler=lambda s: None)

    def step_fn(state, batch):
        return {"x": state["x"] + batch}, {"x": float(state["x"][0])}

    start, state = sup.restore_or_init({"x": torch.zeros(2)})
    assert start == 0
    n, state, _ = sup.run(state, step_fn, lambda s: torch.full((2,), float(s)), 5,
                          per_shard_times_fn=lambda: np.ones(2))
    assert n == 5 and tck.latest_step(cfg.checkpoint_dir) == 4
    sup.emergency_save(5, state)
    start, restored = tres.TrainingSupervisor(cfg).restore_or_init({"x": torch.zeros(2)})
    assert start == 5 and torch.equal(restored["x"], state["x"])


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------


def test_grad_compression_bitwise():
    rng = np.random.default_rng(4)
    grads = {"a": (rng.standard_normal((5, 7)) * 3).astype(np.float32),
             "layers": [{"w": rng.standard_normal((9,)).astype(np.float32)},
                        {"w": np.zeros((2, 2), np.float32)}]}
    err = {"a": (0.01 * rng.standard_normal((5, 7))).astype(np.float32),
           "layers": [{"w": (0.01 * rng.standard_normal((9,))).astype(np.float32)},
                      {"w": np.zeros((2, 2), np.float32)}]}
    jg, je = jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, err)
    tg, te = interop.to_torch(grads), interop.to_torch(err)
    q, s = tgc.quantize_int8(tg["a"])
    jq_, js = jgc.quantize_int8(jg["a"])
    assert np.array_equal(q.numpy(), np.asarray(jq_)) and float(s) == float(js)
    assert np.array_equal(tgc.dequantize_int8(q, s).numpy(), np.asarray(jgc.dequantize_int8(jq_, js)))
    got = tgc.compress_tree(tg, te)
    want = jgc.compress_tree(jg, je)
    for a, b in zip(got, want):
        for x, y in zip(topt.tree_leaves(a), jax.tree.leaves(b)):
            assert np.array_equal(x.numpy(), np.asarray(y))
    for x, y in zip(topt.tree_leaves(tgc.decompress_tree(got[0], got[1])),
                    jax.tree.leaves(jgc.decompress_tree(want[0], want[1]))):
        assert np.array_equal(x.numpy(), np.asarray(y))
    zeros = tgc.init_error_state(tg)
    assert all(z.dtype == torch.float32 and not z.any() for z in topt.tree_leaves(zeros))


# ---------------------------------------------------------------------------
# the training CLI
# ---------------------------------------------------------------------------


def _train(ckpt, *extra):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "granite-3-2b", "--smoke",
         "--device", "cpu", "--steps", "6", "--ckpt-every", "3", "--ckpt-dir", ckpt, *extra],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def _leaves_on_disk(path):
    with open(os.path.join(path, "manifest.json")) as f:
        names = [m["name"] for m in json.load(f)["leaves"]]
    return {n: np.load(os.path.join(path, n + ".npy")) for n in names}


def test_train_cli_resume_is_bitwise(tmp_path):
    ckpt = str(tmp_path / "ck")
    first = _train(ckpt)
    assert "step     6" in first and "done: loss" in first
    assert sorted(os.listdir(ckpt)) == ["step_00000003", "step_00000006"]
    full = _leaves_on_disk(os.path.join(ckpt, "step_00000006"))
    for d in os.listdir(ckpt):
        if d != "step_00000003":
            os.rename(os.path.join(ckpt, d), str(tmp_path / d))
    second = _train(ckpt, "--resume")
    assert "resumed from step 3" in second
    resumed = _leaves_on_disk(os.path.join(ckpt, "step_00000006"))
    assert sorted(resumed) == sorted(full)
    for name, arr in full.items():
        assert np.array_equal(resumed[name], arr), name
    assert np.asarray(full["opt__.step"]) == 6
