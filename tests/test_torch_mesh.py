"""The port's multi-GPU executor against the JAX package, on the CPU (slot
backend; the paged pool, speculation and chunking are in
`tests/test_torch_mesh_paged.py`).

The mesh runs as gloo process groups of 2 (1x2) and 8 (2x4) ranks, the
reference's host meshes of ``tests/test_executor.py``, started by
`repro_torch.launch.mesh.spawn` under ``tmp_path`` with one CPU thread per
rank and a timeout; the ranks' side is `tests/_torch_mesh_ranks.py`.  The
reference's weights reach every rank through an ``.npz``.  Held here:

- the configuration checks (`tests/test_executor.py:67-98`): the local
  executor refuses a mesh, the mesh executor needs one, MoE is refused,
  a mesh over too few or too many ranks raises, NCCL with fewer cards than
  ranks raises, and ``graphs=True`` on gloo raises;
- one-shot parity on imbalanced plans with replicas (skew 2.0 seed 1 on
  1x2 and 2x4, skew 3.0 seed 7 on 2x4): tokens, realized lengths and the
  gathered state lengths equal the reference's local executor, logits
  within rtol = atol = 1e-4 (fp32; only the o-projection's summation order
  differs), again after a replan, with the slot weights and plan arrays
  still in their storage (a captured step keeps its inputs); every rank
  returns the same results bitwise;
- the decode step's collectives: one all-reduce over ``model`` per layer
  and no all-gather over it; over ``data`` the tokens and logits gather;
- the continuous trace on 2x4: tokens equal the reference local run's;
- gemma2-9b (window, softcaps, embedding scale) and qwen1.5-110b (qkv bias,
  non-zero, its slot biases sharded over ``model``) one-shot on 1x2:
  tokens and lengths equal the reference local executor's, logits within
  1e-4, one all-reduce over ``model`` per layer.

(The reference's own mesh run of the paged backend is red in its baseline,
so the port is held to the reference's local executor throughout.)
"""
import jax
import numpy as np
import pytest
import torch

import repro.api as JAPI
from repro.api import Engine as JEngine
from repro.api import synthesize_requests as jsynth
from repro.paging.block_pool import BlockPool as JBlockPool
from repro_torch.api import Engine, EngineConfig
from repro_torch.configs.base import MoEConfig
from repro_torch.exec.base import make_executor
from repro_torch.exec.mesh import MeshExecutor
from repro_torch.launch.mesh import Group, Mesh, make_host_mesh, spawn
from repro_torch.paging.block_pool import BlockPool
from tests import _torch_mesh_ranks as R
from tests.test_torch_families import shared_params

SPAWN_TIMEOUT = 300
SLOT_CASES = {"1x2": [("slot", 2, 2.0, 1)],
              "2x4": [("slot", 4, 2.0, 1), ("slot", 4, 3.0, 7)]}
SHAPES = {"1x2": (2, 1), "2x4": (4, 2)}  # (model, data)
FAMILY_ARCHS = ["gemma2-9b", "qwen1.5-110b"]


def fake_mesh(backend="gloo", model=1, data=1):
    """A `Mesh` value without a process group (for constructor checks)."""
    g = Group(None, "model", model, 0, backend)
    return Mesh(rank=0, world=model * data, model=model, data=data, model_idx=0,
                data_idx=0, model_group=g, data_group=Group(None, "data", data, 0, backend),
                device=torch.device("cpu"), backend=backend)


# ---------------------------------------------------------------------------
# configuration checks
# ---------------------------------------------------------------------------


def test_local_executor_rejects_mesh():
    cfg = EngineConfig.smoke(R.ARCH, device="cpu")
    with pytest.raises(ValueError, match="executor='mesh'"):
        Engine.build(cfg, mesh=fake_mesh())
    with pytest.raises(ValueError, match="mesh"):
        make_executor("local", cfg.model, cfg.compression, mesh=fake_mesh(), device="cpu")


def test_mesh_executor_requires_mesh():
    cfg = EngineConfig.smoke(R.ARCH, device="cpu", executor="mesh")
    with pytest.raises(ValueError, match="make_host_mesh"):
        Engine.build(cfg)


def test_mesh_executor_rejects_moe():
    """MoE's capacity-bounded dispatch depends on the global token count,
    so the mesh executor refuses it (as the reference does)."""
    import dataclasses
    cfg = EngineConfig.smoke(R.ARCH, device="cpu")
    moe = dataclasses.replace(cfg.model, moe=MoEConfig(num_experts=4, top_k=2, d_expert=32))
    with pytest.raises(NotImplementedError, match="expert parallelism"):
        MeshExecutor(moe, cfg.compression, mesh=fake_mesh())


def test_config_accepts_mesh_and_round_trips():
    cfg = EngineConfig.smoke(R.ARCH, device="cpu", executor="mesh")
    again = EngineConfig.from_dict(cfg.to_dict())
    assert again.executor == "mesh" and again == cfg
    with pytest.raises(ValueError, match="unknown executor"):
        EngineConfig.smoke(R.ARCH, device="cpu", executor="meshes")


def test_no_silent_fallback():
    """No mesh without a process group, no NCCL over too few cards, no
    graphs on gloo."""
    cfg = EngineConfig.smoke(R.ARCH, device="cpu")
    with pytest.raises(ValueError, match="process group"):
        make_host_mesh(model=1, data=1)
    with pytest.raises(ValueError, match="one card per rank"):
        spawn(R.oversubscribe_rank, model=2, data=1, backend="nccl")
    with pytest.raises(ValueError, match="graphs=True needs the nccl backend"):
        MeshExecutor(cfg.model, cfg.compression, mesh=fake_mesh(), graphs=True)
    ex = MeshExecutor(cfg.model, cfg.compression, mesh=fake_mesh())
    assert not ex.graphs and (ex.pool_partitions, ex.row_partitions) == (1, 1)


def test_make_host_mesh_oversubscription_raises(tmp_path):
    """Regression of the reference's: a mesh of more ranks than the group
    holds is a ValueError, not an assert."""
    (msg,) = spawn(R.oversubscribe_rank, init_file=str(tmp_path / "rv"),
                   timeout=SPAWN_TIMEOUT)
    assert msg is not None and "2 ranks" in msg and "holds 1" in msg


# ---------------------------------------------------------------------------
# the partitioned allocator, bitwise the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("parts", [1, 2, 8])
def test_partitioned_block_pool_matches_reference(parts):
    """The same alloc / free sequence through both pools: the same ids, the
    same partitions, the same per-partition free counts at every step."""
    rng = np.random.default_rng(parts)
    L, N = 2, 8 * parts * 3
    j, t = JBlockPool(L, N, n_partitions=parts), BlockPool(L, N, n_partitions=parts)
    held = {(layer, p): [] for layer in range(L) for p in range(parts)}
    for step in range(60):
        layer, p = int(rng.integers(L)), int(rng.integers(parts))
        ids = held[(layer, p)]
        if ids and rng.random() < 0.45:
            k = int(rng.integers(1, len(ids) + 1))
            drop, held[(layer, p)] = ids[:k], ids[k:]
            j.decref(layer, drop)
            t.decref(layer, drop)
        else:
            n = int(rng.integers(1, 4))
            if n > t.free_blocks(layer, partition=p):
                continue
            a, b = j.alloc(layer, n, partition=p), t.alloc(layer, n, partition=p)
            assert a == b and {t.partition_of(x) for x in b} == {p}
            ids.extend(b)
        assert np.array_equal(j.free_blocks_by_partition(), t.free_blocks_by_partition())
        assert np.array_equal(j.refcount, t.refcount)
        assert j.blocks_in_use() == t.blocks_in_use()
    assert (t.usable_blocks, t.part_size) == (j.usable_blocks, j.part_size)
    t.check_invariants()
    with pytest.raises(ValueError, match="null block"):
        t.decref(0, [t.part_size * (parts - 1)])


# ---------------------------------------------------------------------------
# parity with the reference's local executor
# ---------------------------------------------------------------------------


def _reference(cases, jparams, profiles):
    out = []
    for (backend, n_shards, skew, seed), prof in zip(cases, profiles):
        eng = JEngine.build(R.oneshot_cfg(JAPI, backend, n_shards, skew, seed), params=jparams)
        prompts = np.random.default_rng(seed).integers(0, 256, (R.B, R.T))
        res = eng.generate(prompts, R.GEN)
        rec = {"tokens": res.tokens, "logits": res.logits, "lengths": np.asarray(res.lengths),
               "state_lengths": np.asarray(eng.state.cache.lengths)}
        eng.replan(profile=prof)
        res2 = eng.generate(prompts, R.GEN)
        rec.update(tokens2=res2.tokens, logits2=res2.logits,
                   state_lengths2=np.asarray(eng.state.cache.lengths))
        out.append(rec)
    return out


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The reference's smoke weights, written once as an .npz."""
    jparams = JEngine.build(R.oneshot_cfg(JAPI, "slot", 2, 2.0, 1)).params
    path = tmp_path_factory.mktemp("mesh") / "params.npz"
    R.save_params(path, jax.tree.map(np.asarray, jparams))
    return jparams, str(path)


def _profiles(cases, jparams):
    """The replan input of each case: the build profile reversed over heads
    (the reference test's)."""
    return [np.asarray(JEngine.build(R.oneshot_cfg(JAPI, b, n, sk, sd), params=jparams)
                       .profile)[:, ::-1].copy() for b, n, sk, sd in cases]


@pytest.fixture(scope="module")
def family_weights(tmp_path_factory):
    """The reference's weights of the other dense archs (qwen1.5's biases
    non-zero), each as an .npz, and the reference local executor's run."""
    out = {}
    for arch in FAMILY_ARCHS:
        jparams, _ = shared_params(R.family_cfg(JAPI, arch))
        path = tmp_path_factory.mktemp("family") / "params.npz"
        R.save_params(path, jax.tree.map(np.asarray, jparams))
        res = JEngine.build(R.family_cfg(JAPI, arch), params=jparams).generate(
            np.random.default_rng(1).integers(0, 256, (R.B, R.T)), R.GEN)
        out[arch] = (str(path), res)
    return out


@pytest.fixture(scope="module")
def oneshot(weights, family_weights, tmp_path_factory):
    """The one-shot cases per mesh shape; the 2x4 spawn also runs the
    continuous trace (under ``"trace"``), the 1x2 spawn the other dense
    archs (under ``"family"``)."""
    jparams, path = weights
    out = {}
    for shape, cases in SLOT_CASES.items():
        profiles = _profiles(cases, jparams)
        model, data = SHAPES[shape]
        jobs = [("oneshot_rank", (path, cases, profiles))]
        if shape == "2x4":
            jobs.append(("trace_rank", (path, "slot")))
        else:
            jobs += [("family_rank", (family_weights[a][0], a)) for a in FAMILY_ARCHS]
        ranks = spawn(R.jobs_rank, model=model, data=data, args=(jobs,),
                      init_file=str(tmp_path_factory.mktemp(shape) / "rv"),
                      timeout=SPAWN_TIMEOUT)
        out[shape] = (cases, [r[0] for r in ranks], _reference(cases, jparams, profiles))
        if shape == "2x4":
            out["trace"] = [r[1] for r in ranks]
        else:
            out["family"] = {a: [r[1 + i] for r in ranks] for i, a in enumerate(FAMILY_ARCHS)}
    return out


CASE_IDS = [(shape, i) for shape, cases in SLOT_CASES.items() for i in range(len(cases))]


@pytest.mark.parametrize("shape,i", CASE_IDS, ids=[f"{s}-{i}" for s, i in CASE_IDS])
def test_oneshot_parity(oneshot, shape, i):
    cases, ranks, ref = oneshot[shape]
    got, want = ranks[0][i], ref[i]
    assert np.array_equal(got["tokens"], want["tokens"])
    assert np.array_equal(got["lengths"], want["lengths"])
    assert np.array_equal(got["state_lengths"], want["state_lengths"])
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape,i", CASE_IDS, ids=[f"{s}-{i}" for s, i in CASE_IDS])
def test_oneshot_parity_after_replan(oneshot, shape, i):
    """A replan copies into the live weights, plan arrays and cache; the
    second generate matches the reference's after its replan."""
    cases, ranks, ref = oneshot[shape]
    got, want = ranks[0][i], ref[i]
    assert np.array_equal(got["tokens2"], want["tokens2"])
    assert np.array_equal(got["state_lengths2"], want["state_lengths2"])
    np.testing.assert_allclose(got["logits2"], want["logits2"], rtol=1e-4, atol=1e-4)
    assert got["same_storage"]
    assert set(got["captures"].values()) == {0}  # eager on the CPU: nothing captured


def test_cases_exercise_replicas(oneshot):
    assert any(r["replicas"] for shape in SLOT_CASES for r in oneshot[shape][1][0])


@pytest.mark.parametrize("shape", list(SLOT_CASES))
def test_ranks_agree(oneshot, shape):
    """Every rank returns bitwise the same tokens, logits and lengths: the
    replicated host sees one global state."""
    _, ranks, _ = oneshot[shape]
    for other in ranks[1:]:
        for a, b in zip(ranks[0], other):
            for key in ("tokens", "logits", "lengths", "state_lengths", "tokens2", "logits2"):
                assert np.array_equal(a[key], b[key]), key
            assert a["memory"] == b["memory"]


@pytest.mark.parametrize("shape", list(SLOT_CASES))
def test_decode_collectives(oneshot, shape):
    """One all-reduce over model per layer (the o-projection), no
    all-gather over it; the data group gathers tokens and logits."""
    _, ranks, _ = oneshot[shape]
    model, data = SHAPES[shape]
    n_layers = EngineConfig.smoke(R.ARCH, device="cpu").model.n_layers
    for rec in ranks[0]:
        coll = rec["collectives"]
        assert coll["model"]["all_reduce"]["calls"] == n_layers
        assert "all_gather" not in coll["model"]
        d = rec["logits"].shape[0] // data  # (B / data, d_model) fp32 per all-reduce
        D = EngineConfig.smoke(R.ARCH, device="cpu").model.d_model
        assert coll["model"]["all_reduce"]["bytes"] == n_layers * d * D * 4
        gathers = coll.get("data", {}).get("all_gather", {}).get("calls", 0)
        assert gathers == (2 if data > 1 else 0)


def test_continuous_parity_2x4(weights, oneshot):
    jparams, _ = weights
    ref = JEngine.build(R.oneshot_cfg(JAPI, "slot", 4, 2.0, 1), params=jparams)
    out = ref.run_trace(R.trace_reqs(jsynth), max_steps=300)
    assert out["finished"] == out["total"]
    want = {r.req_id: list(r.generated) for r in ref.finished_requests}
    for got in oneshot["trace"]:
        assert got["finished"] == got["total"]
        assert got["tokens"] == want


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_parity_1x2(oneshot, family_weights, arch):
    """gemma2-9b and qwen1.5-110b on two gloo ranks: the reference local
    executor's tokens and lengths, logits within 1e-4, every rank alike,
    and still one all-reduce over ``model`` per layer."""
    want = family_weights[arch][1]
    ranks = oneshot["family"][arch]
    n_layers = EngineConfig.smoke(arch, device="cpu").model.n_layers
    for got in ranks:
        assert np.array_equal(got["tokens"], want.tokens)
        assert np.array_equal(got["lengths"], np.asarray(want.lengths))
        np.testing.assert_allclose(got["logits"], want.logits, rtol=1e-4, atol=1e-4)
        assert got["collectives"]["model"]["all_reduce"]["calls"] == n_layers
        assert "all_gather" not in got["collectives"]["model"]
