"""The encoder-decoder and VLM families in the port against the JAX package,
on the CPU: whisper-small (an encoder over stub-frontend frames, decoder
cross-attention on its K / V, learned decoder positions) and llava-next-34b
(stub image embeddings ahead of the text tokens), the latter also at G = 7
query heads per kv head (14 / 2 heads: the smoke config keeps 4 / 2).

Smoke configs in fp32 (4 shards, Ada-SnapKV budget 12, B = 2 prompts of
T = 24 text tokens, 6 new tokens), the reference's weights with every norm
scale drawn non-zero (`tests/test_torch_families_ssm.perturbed_params`),
frames and image embeddings drawn with numpy from a seed.  Required: the
encoder output and each layer's cross K / V within 1e-5 of `encode` /
`encoder_cross_kv`; one-shot under sha and fairkv_dp with identical greedy
tokens and retained lengths, logits within 1e-4, plan invariance below
1e-3; and the reference's refusals: the continuous scheduler, chunked
prefill, speculation and the mesh executor.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as JM
from repro_torch.api import (CompressionConfig, Engine, EngineConfig, SpeculationConfig,
                             synthesize_requests)
from repro_torch.models import transformer as M
from repro_torch.serving import engine as serve
from tests.test_torch_families import PLANNERS, B, T
from tests.test_torch_families_ssm import (VARIANTS, check_oneshot, oneshot_pair,
                                           perturbed_params, variant_configs)

torch.set_num_threads(2)

NAMES = ["whisper", "llava", "llava-g7"]  # `VARIANTS` names


def batch_for(model, seed=1):
    """Prompts plus the stub frontends' inputs the model takes, numpy fp32."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, 256, (B, T)).astype(np.int32)}
    if model.is_vlm:
        batch["image_embeds"] = (0.02 * rng.standard_normal(
            (B, model.num_image_tokens, model.d_model))).astype(np.float32)
    if model.is_encoder_decoder:
        batch["frames"] = (0.02 * rng.standard_normal(
            (B, model.encoder_seq_len, model.d_model))).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def params():
    return {name: perturbed_params(variant_configs(name)[0]) for name in NAMES}


@pytest.fixture(scope="module")
def oneshot(params):
    return {name: oneshot_pair(name, params[name], batch_for(variant_configs(name)[1].model))
            for name in NAMES}


def test_encoder_and_cross_kv_match_reference(params):
    jc, tc = variant_configs("whisper")
    jp, tp = params["whisper"]
    frames = batch_for(tc.model)["frames"]
    j_out = JM.encode(jp, jnp.asarray(frames), jc.model)
    t_out = M.encode(tp, torch.from_numpy(frames), tc.model)
    assert np.abs(np.asarray(j_out) - t_out.numpy()).max() < 1e-5
    j_kv = JM.encoder_cross_kv(jp, j_out, jc.model)
    t_kv = M.encoder_cross_kv(tp, torch.from_numpy(np.array(j_out)), tc.model)
    assert len(j_kv) == len(t_kv) == tc.model.n_layers
    for (jk, jv), (tk, tv) in zip(j_kv, t_kv):
        assert np.abs(np.asarray(jk) - tk.numpy()).max() < 1e-5
        assert np.abs(np.asarray(jv) - tv.numpy()).max() < 1e-5


@pytest.mark.parametrize("mode", [m for m, _ in PLANNERS])
@pytest.mark.parametrize("name", NAMES)
def test_generate_matches_reference(oneshot, name, mode):
    check_oneshot(*oneshot[name][mode])


@pytest.mark.parametrize("name", NAMES)
def test_plan_invariance(oneshot, name):
    base, other = oneshot[name]["sha"][1], oneshot[name]["fairkv_dp"][1]
    assert np.abs(other.logits - base.logits).max() < 1e-3
    assert np.array_equal(other.lengths, base.lengths)


def test_state_holds_cross_kv_and_images(params):
    """whisper's prefilled state carries each layer's cross K / V of the
    encoder (written once, read by every decode step); llava's cache
    positions count the image tokens ahead of the text."""
    tc = variant_configs("whisper")[1]
    te = Engine.build(tc, params=params["whisper"][1])
    te.prefill(batch_for(tc.model))
    m = tc.model
    assert te.state.cross_k.shape == (m.n_layers, B, m.encoder_seq_len, m.n_kv_heads,
                                      m.head_dim)
    assert te.state.cross_v.shape == te.state.cross_k.shape
    tc = variant_configs("llava")[1]
    te = Engine.build(tc, params=params["llava"][1])
    te.prefill(batch_for(tc.model))
    assert (te.state.cache.positions == T + tc.model.num_image_tokens).all()


@pytest.mark.parametrize("name", ["whisper", "llava"])
def test_refusals(params, name):
    """The paths the reference refuses for these families are refused:
    continuous batching, chunked prefill, speculation and the mesh."""
    tc = variant_configs(name)[1]
    te = Engine.build(tc, params=params[name][1])
    with pytest.raises(NotImplementedError, match="token-prompt decoder models"):
        te.submit(synthesize_requests(1, 0.5, 256, min_prompt=8, max_prompt=8,
                                      max_new_tokens=2, seed=0)[0])
    if tc.model.is_encoder_decoder:
        with pytest.raises(NotImplementedError, match="encoder-decoder"):
            serve.init_serve_state(tc.model, te.pa, 2, tc.compression)
    with pytest.raises(ValueError, match="chunked prefill supports dense attention"):
        serve.prefill_chunk({}, torch.zeros((1, 4), dtype=torch.long), tc.model, None, None,
                            None, torch.zeros(1), torch.zeros(1), torch.ones(1), [4, 4])
    with pytest.raises(ValueError, match="speculative decoding supports dense attention"):
        EngineConfig.smoke(VARIANTS[name][0], device="cpu", cache_backend="paged",
                           speculation=SpeculationConfig(enabled=True, max_k=2))
    from repro_torch.exec.mesh import MeshExecutor
    from tests.test_torch_mesh import fake_mesh
    with pytest.raises(NotImplementedError, match="dense decoder-only"):
        MeshExecutor(tc.model, CompressionConfig(), mesh=fake_mesh(model=2))
