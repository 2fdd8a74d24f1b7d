"""The port's multi-GPU executor on the partitioned paged pool, against the
JAX package, on the CPU (the slot backend and the configuration checks are
in `tests/test_torch_mesh.py`, which explains the setting).

- one-shot parity on 1x2 and 2x4 gloo meshes (skew 2.0, seed 1): tokens,
  lengths and the gathered state lengths equal the reference's local
  executor, logits within 1e-4, again after a replan, every rank bitwise
  alike; the decode step's one all-reduce per layer;
- the continuous trace of `tests/test_executor.py` on 2x4: the reference
  local run's tokens, every request finished and every partition empty;
- speculative decoding on 2x4 (`tests/test_speculative.py:196-333`):
  sequential decode equals the reference's local run, the full-depth draft
  commits the same tokens at acceptance 1.0, a half-depth draft the same
  tokens, and both again after a replan;
- chunked prefill on 2x4 (`tests/test_prefix.py:562-641`): the trace's
  tokens equal the reference's chunked local run (which the reference holds
  to its monolithic run), with no prefix index on the partitioned pool.
"""
import jax
import numpy as np
import pytest

import repro.api as JAPI
from repro.api import Engine as JEngine
from repro.api import synthesize_requests as jsynth
from repro.serving.request import Request as JRequest
from repro_torch.api import EngineConfig
from repro_torch.launch.mesh import spawn
from tests import _torch_mesh_ranks as R

SPAWN_TIMEOUT = 300
CASES = {"1x2": ((2, 1), [("paged", 2, 2.0, 1)]), "2x4": ((4, 2), [("paged", 4, 2.0, 1)])}
N_LAYERS = EngineConfig.smoke(R.ARCH, device="cpu").model.n_layers


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    jparams = JEngine.build(R.oneshot_cfg(JAPI, "paged", 2, 2.0, 1)).params
    path = tmp_path_factory.mktemp("mesh_paged") / "params.npz"
    R.save_params(path, jax.tree.map(np.asarray, jparams))
    return jparams, str(path)


def _oneshot_job(jparams, path, case):
    """The rank job of a one-shot case and the reference's local run of it
    (generate, replan to the build profile reversed over heads, generate)."""
    backend, n_shards, skew, seed = case
    jeng = JEngine.build(R.oneshot_cfg(JAPI, backend, n_shards, skew, seed), params=jparams)
    prof = np.asarray(jeng.profile)[:, ::-1].copy()
    prompts = np.random.default_rng(seed).integers(0, 256, (R.B, R.T))
    res = jeng.generate(prompts, R.GEN)
    ref = {"tokens": res.tokens, "logits": res.logits, "lengths": np.asarray(res.lengths),
           "state_lengths": np.asarray(jeng.state.cache.lengths)}
    jeng.replan(profile=prof)
    res2 = jeng.generate(prompts, R.GEN)
    ref.update(tokens2=res2.tokens, logits2=res2.logits,
               state_lengths2=np.asarray(jeng.state.cache.lengths))
    return ("oneshot_rank", (path, [case], [prof])), ref


@pytest.fixture(scope="module")
def mesh_2x4(weights, tmp_path_factory):
    """One 2x4 spawn for the one-shot, continuous, speculative and chunked
    runs; the reference's one-shot run under ``"oneshot_ref"``."""
    jparams, path = weights
    job, ref = _oneshot_job(jparams, path, CASES["2x4"][1][0])
    jobs = [job, ("trace_rank", (path, "paged")), ("spec_rank", (path,)),
            ("chunk_rank", (path,))]
    ranks = spawn(R.jobs_rank, model=4, data=2, args=(jobs,),
                  init_file=str(tmp_path_factory.mktemp("jobs") / "rv"), timeout=SPAWN_TIMEOUT)
    out = {name: [r[i] for r in ranks] for i, (name, _) in enumerate(jobs)}
    out["oneshot_ref"] = ref
    return out


@pytest.fixture(scope="module")
def oneshot(weights, mesh_2x4, tmp_path_factory):
    jparams, path = weights
    (model, data), (case,) = CASES["1x2"]
    job, ref = _oneshot_job(jparams, path, case)
    ranks = spawn(R.oneshot_rank, model=model, data=data, args=job[1],
                  init_file=str(tmp_path_factory.mktemp("1x2") / "rv"), timeout=SPAWN_TIMEOUT)
    return {"1x2": ([r[0] for r in ranks], ref, data),
            "2x4": ([r[0] for r in mesh_2x4["oneshot_rank"]], mesh_2x4["oneshot_ref"],
                    CASES["2x4"][0][1])}


@pytest.mark.parametrize("shape", list(CASES))
def test_paged_oneshot_parity(oneshot, shape):
    ranks, want, _ = oneshot[shape]
    got = ranks[0]
    assert np.array_equal(got["tokens"], want["tokens"])
    assert np.array_equal(got["lengths"], want["lengths"])
    assert np.array_equal(got["state_lengths"], want["state_lengths"])
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=1e-4, atol=1e-4)


def test_paged_cases_exercise_replicas(oneshot):
    assert any(ranks[0]["replicas"] for ranks, _, _ in oneshot.values())


@pytest.mark.parametrize("shape", list(CASES))
def test_paged_oneshot_parity_after_replan(oneshot, shape):
    """The replan re-paginates the live pool partitions in place."""
    ranks, want, _ = oneshot[shape]
    got = ranks[0]
    assert np.array_equal(got["tokens2"], want["tokens2"])
    assert np.array_equal(got["state_lengths2"], want["state_lengths2"])
    np.testing.assert_allclose(got["logits2"], want["logits2"], rtol=1e-4, atol=1e-4)
    assert got["same_storage"]


@pytest.mark.parametrize("shape", list(CASES))
def test_paged_ranks_agree_and_collectives(oneshot, shape):
    ranks, _, data = oneshot[shape]
    for other in ranks[1:]:
        for key in ("tokens", "logits", "state_lengths", "tokens2", "logits2"):
            assert np.array_equal(ranks[0][key], other[key]), key
        assert ranks[0]["memory"] == other["memory"]
    for rec in ranks:
        coll = rec["collectives"]
        assert coll["model"]["all_reduce"]["calls"] == N_LAYERS
        assert "all_gather" not in coll["model"]
        assert coll.get("data", {}).get("all_gather", {}).get("calls", 0) == (
            2 if data > 1 else 0)


def test_paged_continuous_parity_2x4(weights, mesh_2x4):
    jparams, _ = weights
    ref = JEngine.build(R.oneshot_cfg(JAPI, "paged", 4, 2.0, 1), params=jparams)
    out = ref.run_trace(R.trace_reqs(jsynth), max_steps=300)
    assert out["finished"] == out["total"]
    want = {r.req_id: list(r.generated) for r in ref.finished_requests}
    for got in mesh_2x4["trace_rank"]:
        assert got["finished"] == got["total"] and got["tokens"] == want
        assert got["blocks_in_use"] == 0 and len(got["partition_free"]) == 8


def _jax_run_ref(eng, prompts):
    """The reference test's ``run_ref`` on its local executor."""
    eng.prefill(prompts)
    state = eng.state = eng.backend.from_prefill(eng.state, eng.pa)
    toks = []
    for _ in range(R.SGEN):
        state = eng.backend.prepare_decode(state, None)
        state, _ = eng.executor.decode(eng.sp, state, eng.pa, state.last_tokens)
        toks.append(np.asarray(state.last_tokens))
    return np.stack(toks, 1)


@pytest.fixture(scope="module")
def speculative(weights, mesh_2x4):
    ref = _jax_run_ref(JEngine.build(R.spec_cfg(JAPI), params=weights[0]),
                       np.random.default_rng(0).integers(0, 256, (R.SB, R.ST)))
    return mesh_2x4["spec_rank"], ref


def test_spec_mesh_sequential_equals_reference(speculative):
    ranks, ref = speculative
    for got in ranks:
        assert np.array_equal(got["ref"], ref)


def test_spec_mesh_full_and_partial_drafts(speculative):
    """Committing verify's accepted run gives sequential decode's tokens at
    any acceptance; the full-depth self-draft accepts everything."""
    ranks, ref = speculative
    for got in ranks:
        assert np.array_equal(got["full"], ref) and got["acc_full"] == 1.0
        assert np.array_equal(got["partial"], ref)
        assert got["acc_partial"] == ranks[0]["acc_partial"]


def test_spec_mesh_after_replan(speculative):
    ranks, ref = speculative
    for got in ranks:
        assert np.array_equal(got["ref_after_replan"], ref)
        assert np.array_equal(got["spec_after_replan"], ref)


def test_mesh_chunked_parity(weights, mesh_2x4):
    jparams, _ = weights
    eng = JEngine.build(R.chunk_cfg(JAPI), params=jparams)
    out = eng.run_trace(R.chunk_reqs(JRequest, eng.cfg.model.vocab_size), max_steps=400)
    assert out["finished"] == out["total"]
    want = {r.req_id: list(r.generated) for r in eng.scheduler.finished}
    for got in mesh_2x4["chunk_rank"]:
        assert got["finished"] == got["total"] and got["tokens"] == want
        assert got["chunks"] > 0 and got["prefix"] and got["blocks_in_use"] == 0
