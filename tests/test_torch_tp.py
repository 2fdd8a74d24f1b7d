"""The serve cells' step (`repro_torch.launch.specs.serve_step`: the port's
`prefill` / `decode_step` on a rank's shards under the reference's
``serve_rules``) against the reference's single-device `prefill` /
`decode_step`, on the CPU.

The ranks run as jobs of `tests/test_torch_mesh.py`'s two gloo spawns
(``tp_rank`` / ``argmax_rank`` in `tests/_torch_mesh_ranks.py`): the 1x2
spawn is (model 2, data 1), the 2x4 spawn (model 4, data 2) with
``weights_2d`` off and on.  A test needs the spawn's results in the module
that makes the spawn (pytest-xdist hands out whole files), so the parity
tests are there and call `check_case` / `check_argmax` here; this module
holds the reference side and the tests that need no ranks.

Setup: fp32 smoke configs of the four dense archs (qwen1.5's qkv biases
drawn non-zero), the two MoE archs (granite-moe: 4 experts top-2,
qwen3-moe: 8 top-2; the reference's capacity factor 1.25, which drops
replicas at these sizes) and the SSM, hybrid, encoder-decoder and VLM
archs (mamba2, hymba, whisper, llava; their SSD vectors and norm scales
drawn non-zero; a VLM's image embeddings and an encoder-decoder's frames
beside the prompts), the reference's weights through `interop.to_torch`
and `local_shard`, one plan per arch (`cell_plan` at 4 shards, 4 slots,
in both packages bitwise; none for mamba2), Ada-SnapKV budget 12; a
prefill of 4 x 20 tokens, then 3 decode steps.  qwen1.5 also runs
widened (d_model 256) on int8 weights against the reference's
`quantize_serve_params`.  At these sizes mamba2's split cuts every SSD dim
(in_proj's 84 columns across the z | xBC | dt boundaries), hymba's keeps
in_proj's 93 columns and its 5 heads whole, and whisper's 4 heads split.

long_500k's split-S step (``long_rank``): gemma2-9b's smoke config (a
local layer with window 16, a global one), B 1, policy none at capacity
120 + 8, the reference's prefill of 100 tokens handed to the ranks, then
32 decode steps past the ring's wrap, against the reference's
single-device decode steps: tokens and lengths equal, logits and the
cache within 1e-4, per step L all-gathers over ``data`` (none on 1x2,
where the columns do not split) beside the dense contract; hymba's long
cell (one window of 16 + a ring of 8, wrapped) and mamba2's (no cache)
alike, their SSD state and conv window within 1e-4.  The
expert-parallel `moe_block` (``moe_rank``, 8 experts top-2 at capacity
factor 1.0) against the reference's `moe_block`, whose drops a per-shard
capacity would change.

Bars: tokens and retained lengths equal; the logits (the ranks' vocab
columns, gathered here only) and the rank's cache corner within 1e-4
(fp32: the MLP's and o-projection's partial sums add in another order);
the cache's lengths and positions equal; the SSD state, conv window and
cross K / V shards within 1e-4; per decode step over ``model`` 2·L + 1
all-reduces of (B / data, d_model) and one all-gather of (B / data, 2)
argmax pairs, over ``data`` nothing, or with ``weights_2d`` one
all-gather per weight read (the family archs: the dry run's derived
count).  In-process (thread ranks, no spawn): the SSD branch and the
encoder and cross attention on shards sum to the whole.  `vocab_argmax`: a tie across two vocab shards
picks the lowest id, a padded column is never picked.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.cache.slot_cache import PlanArrays as JPlanArrays
from repro.compression.base import CompressionConfig as JCompression
from repro.launch import specs as jspecs
from repro.models import transformer as JM
from repro.serving import engine as JE
from repro.serving import quant as jq
from repro_torch import configs
from repro_torch.configs import SHAPES, get_config
from repro_torch.distributed.param_specs import (local_shard, localize_scales, shard_shape,
                                                 tree_specs)
from repro_torch.distributed.sharding import Split, StepShards, serve_rules
from repro_torch.launch import specs
from repro_torch.launch.mesh import Group, Mesh
from repro_torch.models import layers as L
from repro_torch.serving import engine as E
from repro_torch.serving.quant import QTensor, quantize_serve_params
from repro_torch.training.optimizer import tree_leaves
from tests import _torch_mesh_ranks as R

torch.set_num_threads(2)
TOL = 1e-4
ARCHS = ["minitron-8b", "gemma2-9b", "granite-3-2b", "qwen1.5-110b"]
MOE_ARCHS = ["granite-moe-1b-a400m", "qwen3-moe-30b-a3b"]
# the SSM, hybrid, encoder-decoder and VLM archs (no weights_2d case: no
# production cell of theirs runs it)
FAMILY_ARCHS = ["mamba2-1.3b", "hymba-1.5b", "whisper-small", "llava-next-34b"]
# (arch, widened, int8) per weight set; the spawns' cases add weights_2d
WEIGHTS = ([(a, False, False) for a in ARCHS + MOE_ARCHS + FAMILY_ARCHS]
           + [("qwen1.5-110b", True, True)])
CASES = {"1x2": [w + (False,) for w in WEIGHTS],
         "2x4": [w + (w2,) for w in WEIGHTS for w2 in (False, True)
                 if not (w2 and w[0] in FAMILY_ARCHS)]}
# drawn non-zero in the family archs' weights, (scale, offset) of scale·N(0, 1)
# + offset: the reference's zeros and ones hide a sign error or a dropped term
NONZERO = {"A_log": (0.5, 0.0), "dt_bias": (0.5, 0.0), "ssm_D": (0.5, 1.0),
           "ssm_norm": (0.3, 0.0), "attn_out_norm": (0.3, 0.0), "ln1": (0.3, 0.0),
           "ln2": (0.3, 0.0), "ln_cross": (0.3, 0.0)}


def case_id(case) -> str:
    arch, wide, int8, w2 = case
    return arch + ("-int8" if int8 else "") + ("-weights_2d" if w2 else "")


# ---------------------------------------------------------------------------
# the reference side
# ---------------------------------------------------------------------------


def weights_tree(arch: str, wide: bool) -> dict:
    """The reference's fp32 smoke weights as numpy, qkv biases non-zero (and
    the family archs' SSD vectors and norm scales, `NONZERO`)."""
    jcfg = R.tp_model(jconfigs, arch, wide)
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0),
                                                   dtype=jnp.float32))
    rng = np.random.default_rng(0)
    for pl in tree["layers"]:
        for key in ("bq", "bk", "bv"):
            if key in pl:
                pl[key] = (0.5 * rng.standard_normal(pl[key].shape)).astype(np.float32)
    if arch in FAMILY_ARCHS:
        for pl in tree["layers"] + tree.get("enc_layers", []):
            for key, (scale, off) in NONZERO.items():
                if key in pl:
                    pl[key] = (scale * rng.standard_normal(pl[key].shape) + off).astype(
                        np.float32)
    return tree


def reference_run(tree: dict, arch: str, wide: bool, int8: bool) -> dict:
    """The reference's single-device `prefill` then `R.TP_STEPS` decode
    steps (jitted) on the slotified (and int8) tree: tokens (steps + 1, B),
    logits (steps + 1, B, V), lengths (L, Hkv, B) and the final cache."""
    jcfg = R.tp_model(jconfigs, arch, wide)
    ccfg = JCompression(**R.TP_COMP)
    plan = jspecs.cell_plan(jcfg, R.TP_PLAN_SHARDS, batch_cap=R.TP_B)
    sp = JE.slotify_params(jax.tree.map(jnp.asarray, tree), plan, jcfg)
    if int8:
        sp = jq.quantize_serve_params(sp)
    pa = None if plan is None else JPlanArrays.from_plan(plan)
    prefill = jax.jit(lambda sp, b, pa: JE.prefill(sp, b, jcfg, pa, ccfg))
    decode = jax.jit(lambda sp, st, pa: JE.decode_step(sp, st, jcfg, pa, ccfg))
    batch = {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32)
             for k, v in R.tp_batch(jcfg).items()}
    st, lg, lengths = prefill(sp, batch, pa)
    tokens, logits = [st.last_tokens], [lg]
    for _ in range(R.TP_STEPS):
        st, lg = decode(sp, st, pa)
        tokens.append(st.last_tokens)
        logits.append(lg)
    return {"tokens": np.stack(tokens), "logits": np.stack(logits),
            "lengths": np.asarray(lengths),
            "cache": None if st.cache is None else {
                f: np.asarray(getattr(st.cache, f))
                for f in ("k", "v", "lengths", "pos", "positions")},
            "state": {f: np.asarray(getattr(st, f)) for f in R.STATE_FIELDS
                      if getattr(st, f) is not None}}


def long_weights() -> dict:
    return weights_tree(R.LONG_ARCH, False)


def long_prefill(tree: dict, path, arch: str = R.LONG_ARCH) -> None:
    """The reference's prefill of ``arch``'s long cell prompt (B 1, its
    `R.LONG_CELLS` tokens, policy none) on the slotified tree: its state
    (cache, recurrent state) to ``path`` (.npz) for the ranks."""
    jcfg, ccfg, plan, sp, pa = _long_setup(tree, arch)
    n_prompt = R.LONG_CELLS[arch][1]
    tokens = jnp.asarray(np.random.default_rng(5).integers(0, jcfg.vocab_size,
                                                            (1, n_prompt)), jnp.int32)
    st, _, _ = jax.jit(lambda sp, t, pa: JE.prefill(sp, {"tokens": t}, jcfg, pa, ccfg))(
        sp, tokens, pa)
    parts = {f: np.asarray(getattr(st, f)) for f in R.STATE_FIELDS
             if getattr(st, f) is not None}
    if st.cache is not None:
        parts.update({f: np.asarray(getattr(st.cache, f)) for f in R.CACHE_FIELDS})
    np.savez(path, **parts, last_tokens=np.asarray(st.last_tokens),
             decode_steps=np.asarray(st.decode_steps))


def _long_setup(tree, arch: str = R.LONG_ARCH):
    jcfg = jconfigs.get_smoke_config(arch)
    ccfg = JCompression(**R.LONG_CELLS[arch][0])
    plan = jspecs.cell_plan(jcfg, R.TP_PLAN_SHARDS, batch_cap=1)
    sp = JE.slotify_params(jax.tree.map(jnp.asarray, tree), plan, jcfg)
    return jcfg, ccfg, plan, sp, None if plan is None else JPlanArrays.from_plan(plan)


def long_reference(tree: dict, path, arch: str = R.LONG_ARCH) -> dict:
    """The reference's single-device decode steps (jitted) from the state
    `long_prefill` wrote: tokens (steps, 1), logits (steps, 1, V), the
    final cache and recurrent state."""
    from repro.cache.slot_cache import SlotCache as JSlotCache

    jcfg, ccfg, plan, sp, pa = _long_setup(tree, arch)
    with np.load(path) as z:
        st = JE.ServeState(
            cache=JSlotCache(**{f: jnp.asarray(z[f]) for f in R.CACHE_FIELDS})
            if "k" in z.files else None,
            **{f: jnp.asarray(z[f]) if f in z.files else None for f in R.STATE_FIELDS},
            last_tokens=jnp.asarray(z["last_tokens"]),
            decode_steps=jnp.asarray(z["decode_steps"]))
    decode = jax.jit(lambda sp, st, pa: JE.decode_step(sp, st, jcfg, pa, ccfg))
    tokens, logits = [], []
    for _ in range(R.LONG_CELLS[arch][2]):
        st, lg = decode(sp, st, pa)
        tokens.append(np.asarray(st.last_tokens))
        logits.append(np.asarray(lg))
    return {"tokens": np.stack(tokens), "logits": np.stack(logits),
            "cache": None if st.cache is None else {
                f: np.asarray(getattr(st.cache, f)) for f in R.CACHE_FIELDS},
            "state": {f: np.asarray(getattr(st, f)) for f in R.STATE_FIELDS
                      if getattr(st, f) is not None}}


def moe_arrays() -> dict:
    """`R.moe_rank`'s inputs: the reference's expert weights at `R.MOE_EP`
    (fp32, seed 3) and (8, 6, 64) activations."""
    from repro.configs.base import MoEConfig as JMoE
    from repro.models.moe import init_moe_params

    jcfg = dataclasses.replace(jconfigs.get_smoke_config("qwen3-moe-30b-a3b"),
                               moe=JMoE(**R.MOE_EP))
    pl = jax.tree.map(np.asarray, init_moe_params(jax.random.PRNGKey(3), jcfg, jnp.float32))
    h = np.random.default_rng(4).standard_normal((R.MOE_ROWS, R.MOE_SEQ, jcfg.d_model))
    return {**pl, "h": h.astype(np.float32)}

# ---------------------------------------------------------------------------
# checks of the spawns' results (called by tests/test_torch_mesh.py)
# ---------------------------------------------------------------------------


def _cut(whole: np.ndarray, spec, got: dict, model: int, data: int) -> np.ndarray:
    """The slice of ``whole`` a rank (``got``'s ``model_idx`` / ``data_idx``)
    holds under ``spec``."""
    idx = []
    for n, phys in zip(whole.shape, spec):
        names = () if phys is None else (phys,) if isinstance(phys, str) else tuple(phys)
        size, i = (model, got["model_idx"]) if "model" in names else (
            (data, got["data_idx"]) if names else (1, 0))
        idx.append(slice(i * (n // size), (i + 1) * (n // size)))
    return whole[tuple(idx)]


def check_case(ranks: list, want: dict, case, model: int, data: int) -> None:
    """A case of the cell step on every rank against the reference's run:
    tokens and lengths equal, logits (the ranks' vocab columns put
    together), the cache corner and each state shard (``ssm_state``,
    ``conv_state``, ``cross_k`` / ``cross_v``, cut as the state's specs
    lay them out) within 1e-4, and one decode step's collectives: the dense
    and MoE archs' below, the family archs' the dry run's derived count
    (`repro_torch.launch.dryrun.decode_contract`) with nothing over
    ``data`` at prefill."""
    from repro_torch.launch import dryrun

    arch, wide, int8, weights_2d = case
    cfg = R.tp_model(configs, arch, wide)
    n_v = cfg.padded_vocab // model
    logits = np.full(want["logits"].shape, np.nan, np.float32)
    rows_per, L = R.TP_B // data, cfg.n_layers
    for got in ranks:
        r, s = slice(*got["rows"]), slice(*got["slots"])
        v = slice(got["model_idx"] * n_v, (got["model_idx"] + 1) * n_v)
        assert got["int8"] == int8
        assert np.array_equal(np.stack(got["tokens"]), want["tokens"][:, r])
        assert np.array_equal(got["lengths"], want["lengths"][..., r])
        logits[:, r, v] = np.stack(got["logits"])
        c, w = got["cache"], want["cache"]
        assert (c is None) == (w is None) == cfg.attention_free
        if c is not None:
            for f in ("lengths", "pos"):
                assert np.array_equal(c[f], w[f][:, s, r]), f
            assert np.array_equal(c["positions"], w["positions"][r])
            for f in ("k", "v"):
                np.testing.assert_allclose(c[f], w[f][:, s, r], rtol=TOL, atol=TOL)
        assert set(got["state"]) == set(want["state"])
        for f, (x, spec) in got["state"].items():
            np.testing.assert_allclose(x, _cut(want["state"][f], spec, got, model, data),
                                       rtol=TOL, atol=TOL, err_msg=f)
        coll = got["collectives"]
        if arch in FAMILY_ARCHS:
            held = dryrun.decode_contract(coll, cfg, rows_per, model, data)
            assert all(held.values()), (held, coll)
            assert "data" not in got["prefill_collectives"]
            continue
        # the decode contract; MoE gathers its router's columns over model
        # and its expert counts over data (when the rows split) each layer
        moe = cfg.moe.num_experts > 0
        ar, ag = coll["model"]["all_reduce"], coll["model"]["all_gather"]
        assert ar["calls"] == 2 * L + 1 and ar["elements"] == ar["calls"] * rows_per * cfg.d_model
        routers = L if moe else 0
        assert ag["calls"] == 1 + routers
        assert ag["elements"] == rows_per * 2 * model + routers * cfg.d_model * cfg.moe.num_experts
        counts = L if moe and data > 1 else 0
        if weights_2d:
            # every weight read gathers its d_model shards: 4 attention and
            # 3 MLP (or expert) weights a layer, the embedding and the head
            assert set(coll["data"]) == {"all_gather"}
            assert coll["data"]["all_gather"]["calls"] == 7 * L + 2 + counts
        elif counts:
            for c in (coll, got["prefill_collectives"]):
                assert set(c["data"]) == {"all_gather"} and c["data"]["all_gather"]["calls"] == L
        else:
            assert "data" not in coll and "data" not in got["prefill_collectives"]
    np.testing.assert_allclose(logits, want["logits"], rtol=TOL, atol=TOL)


def check_long(ranks: list, want: dict, model: int, data: int,
               arch: str = R.LONG_ARCH) -> None:
    """``arch``'s long cell step on every rank against the reference's
    decode steps: tokens and lengths equal, logits (the ranks' vocab
    columns put together), the cache (the ranks' slots and columns put
    together) and the recurrent state shards within 1e-4, positions equal,
    every rank's tokens the same; per step the derived collectives
    (`repro_torch.launch.dryrun.decode_contract`): for gemma2 over
    ``model`` the dense contract and over ``data`` one all-gather a layer
    when the columns split (``data`` > 1), else none."""
    from repro_torch.launch import dryrun

    cfg = configs.get_smoke_config(arch)
    L, n_v = cfg.n_layers, cfg.padded_vocab // model
    logits = np.full(want["logits"].shape, np.nan, np.float32)
    cache = None if want["cache"] is None else {
        f: np.full(w.shape, np.nan if f in ("k", "v") else -7, w.dtype)
        for f, w in want["cache"].items() if f in ("k", "v", "pos")}
    for got in ranks:
        s, c = slice(*got["slots"]), slice(*got["cols"])
        v = slice(got["model_idx"] * n_v, (got["model_idx"] + 1) * n_v)
        assert np.array_equal(np.stack(got["tokens"]), want["tokens"])
        logits[:, :, v] = np.stack(got["logits"])
        assert (got["cache"] is None) == (cache is None)
        if cache is not None:
            for f in cache:
                cache[f][:, s, :, c] = got["cache"][f]
            assert np.array_equal(got["cache"]["lengths"], want["cache"]["lengths"][:, s])
            assert np.array_equal(got["cache"]["positions"], want["cache"]["positions"])
        assert set(got["state"]) == set(want["state"])
        for f, (x, spec) in got["state"].items():
            np.testing.assert_allclose(x, _cut(want["state"][f], spec, got, model, data),
                                       rtol=TOL, atol=TOL, err_msg=f)
        coll = got["collectives"]
        held = dryrun.decode_contract(coll, cfg, 1, model, data, split_s=True)
        assert all(held.values()), (held, coll)
        if arch == R.LONG_ARCH:
            ar, ag = coll["model"]["all_reduce"], coll["model"]["all_gather"]
            assert ar["calls"] == 2 * L + 1 and ag["calls"] == 1
            if data > 1:
                assert set(coll["data"]) == {"all_gather"}
                assert coll["data"]["all_gather"]["calls"] == L
            else:
                assert "data" not in coll
    np.testing.assert_allclose(logits, want["logits"], rtol=TOL, atol=TOL)
    if cache is None:
        return
    assert (want["cache"]["lengths"] == want["cache"]["k"].shape[3]).any()  # at capacity
    assert np.array_equal(cache["pos"], want["cache"]["pos"])
    for f in ("k", "v"):
        np.testing.assert_allclose(cache[f], want["cache"][f], rtol=TOL, atol=TOL)


def check_moe(ranks: list, arrays: dict, data: int) -> None:
    """The expert-parallel `moe_block` against the reference's `moe_block`
    on the whole batch: outputs within 1e-4 and the aux loss within 1e-6;
    the reference drops replicas at this capacity, and where the rows split
    (``data`` > 1) the port's local block on each rank's rows alone
    (capacity from its own tokens, as a per-shard ``Ce`` would give) is
    further than 1e-3 from it."""
    from repro.configs.base import MoEConfig as JMoE
    from repro.models.moe import moe_block as jmoe_block
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models.moe import expert_capacity, moe_block

    jcfg = dataclasses.replace(jconfigs.get_smoke_config("qwen3-moe-30b-a3b"),
                               moe=JMoE(**R.MOE_EP))
    pl = {k: jnp.asarray(arrays[k]) for k in ("router", "we1", "we3", "we2")}
    want, want_aux = (np.asarray(x) for x in jmoe_block(pl, jnp.asarray(arrays["h"]), jcfg))
    got = np.full(want.shape, np.nan, np.float32)
    for r in ranks:
        got[slice(*r["rows"])] = r["out"]
        np.testing.assert_allclose(r["aux"], want_aux, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # drops: the reference's top-k picks against its global capacity
    x = arrays["h"].reshape(-1, arrays["h"].shape[-1])
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ pl["router"], axis=-1))
    picks = np.argsort(-probs, axis=-1, kind="stable")[:, :R.MOE_EP["top_k"]]
    cfg = dataclasses.replace(configs.get_smoke_config("qwen3-moe-30b-a3b"),
                              moe=MoEConfig(**R.MOE_EP))
    counts = np.bincount(picks.ravel(), minlength=R.MOE_EP["num_experts"])
    assert (counts > expert_capacity(x.shape[0], cfg)).any()
    if data > 1:  # the rows split: a per-shard capacity would drop other replicas
        tpl = {k: torch.from_numpy(arrays[k]) for k in ("router", "we1", "we3", "we2")}
        n = R.MOE_ROWS // data
        per_shard = np.concatenate([moe_block(tpl, torch.from_numpy(arrays["h"][i:i + n]),
                                              cfg)[0].numpy()
                                    for i in range(0, R.MOE_ROWS, n)])
        assert np.abs(per_shard - want).max() > 1e-3


def check_argmax(ranks: list) -> None:
    """`vocab_argmax` over two shards equals the plain argmax over the real
    vocab: the cross-shard tie goes to id 3, the in-shard tie to id 10, the
    padded column's 100 is passed over, an all-tied row picks 0."""
    for got, want in ranks:
        assert np.array_equal(got, want)
        assert got[0] == 3 and got[1] == 10 and got[2] < 14 and got[3] == 0


# ---------------------------------------------------------------------------
# tests without ranks
# ---------------------------------------------------------------------------


def rank_meshes(model: int, data: int) -> list:
    """A `Mesh` value per rank of a (data, model) mesh, without process
    groups (`local_shard` reads only the ranks' indices)."""
    out = []
    for r in range(model * data):
        d, m = divmod(r, model)
        out.append(Mesh(rank=r, world=model * data, model=model, data=data, model_idx=m,
                        data_idx=d, model_group=Group(None, "model", model, m, "gloo"),
                        data_group=Group(None, "data", data, d, "gloo"),
                        device=torch.device("cpu"), backend="gloo"))
    return out


def _serve_tree():
    """A slotified int8 serve tree (the widened qwen1.5 smoke config), its
    whole-tree leaves by path, and its plan."""
    cfg = R.tp_model(configs, "qwen1.5-110b", True)
    plan = specs.cell_plan(cfg, R.TP_PLAN_SHARDS, batch_cap=R.TP_B)
    from repro_torch.models.transformer import init_params
    sp = quantize_serve_params(E.slotify_params(init_params(cfg, 0, torch.float32, "cpu"),
                                                plan, cfg))
    return cfg, sp, plan


def _leaves(tree, spec, prefix=""):
    """(path, leaf, spec) of a tree and its spec tree; a `QTensor` is one leaf."""
    if isinstance(tree, (torch.Tensor, QTensor)):
        yield prefix, tree, spec
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, spec[k], f"{prefix}/{k}")
    else:
        for i, v in enumerate(tree):
            yield from _leaves(v, spec[i], f"{prefix}/{i}")


def _place(whole: torch.Tensor, spec, mesh):
    """The slice of ``whole`` that ``mesh``'s rank holds under ``spec``."""
    idx = []
    for d, phys in enumerate(spec):
        if phys is None:
            idx.append(slice(None))
            continue
        g = mesh.model_group if phys == "model" else mesh.data_group
        n = whole.shape[d] // g.size
        idx.append(slice(g.rank * n, (g.rank + 1) * n))
    return tuple(idx)


@pytest.mark.parametrize("weights_2d", [False, True])
def test_local_shard_tiles_the_tree(weights_2d):
    """On (data 2, model 4), every rank's `local_shard` of an int8 serve
    tree has ``shard_shape(spec)`` leaves; put back at their places the
    shards give the tree again, each element once (a scale along the dims
    its codes split over ``model``; whole along ``data``), and a cut shard
    holds no more storage than its elements; `localize_scales`
    on the rules' layout (whole scales) cuts the same scales."""
    cfg, sp, plan = _serve_tree()
    rules = serve_rules({"data": 2, "model": 4}, weights_2d=weights_2d)
    spec = tree_specs(sp, rules, "serve")
    axes = {"data": 2, "model": 4}
    whole = list(_leaves(sp, spec))
    assert any(isinstance(w, QTensor) for _, w, _ in whole)
    assert any("data" in s.q for _, w, s in whole if isinstance(w, QTensor)) == weights_2d
    meshes = rank_meshes(4, 2)
    back = {path: [torch.full(w.shape, float("nan")) for w in
                   ((t.q.float(), t.scale) if isinstance(t, QTensor) else (t,))]
            for path, t, _ in whole}
    for mesh in meshes:
        shards = {p: t for p, t, _ in _leaves(local_shard(sp, spec, mesh), spec)}
        for path, t, s in whole:
            got = shards[path]
            if isinstance(t, QTensor):
                assert tuple(got.q.shape) == shard_shape(tuple(t.q.shape), s.q, axes)
                back[path][0][_place(t.q, s.q, mesh)] = got.q.float()
                cut = tuple(p if p == "model" and n > 1 and n == m else None
                            for p, n, m in zip(s.q, t.scale.shape, t.q.shape))
                at = _place(t.scale, cut, mesh)
                back[path][1][at] = got.scale
                # the rules' layout (the dry run's arguments): codes cut,
                # scale whole; localized, the same scale as local_shard's
                ruled = QTensor(q=got.q, scale=t.scale)
                loc = localize_scales({"w": ruled}, {"w": s}, mesh)["w"]
                assert torch.equal(loc.scale, got.scale)
            else:
                assert tuple(got.shape) == shard_shape(tuple(t.shape), s, axes)
                back[path][0][_place(t, s, mesh)] = got.to(back[path][0].dtype)
            q = got.q if isinstance(got, QTensor) else got
            if any(p is not None for p in (s.q if isinstance(t, QTensor) else s)):
                # a cut shard owns its elements, not the whole leaf's storage
                assert q.untyped_storage().nbytes() == q.numel() * q.element_size()
    for path, t, _ in whole:
        parts = (t.q.float(), t.scale) if isinstance(t, QTensor) else (t,)
        for b, w in zip(back[path], parts):
            assert torch.equal(b, w.to(b.dtype)), path


def _split_shards(index: int, size: int) -> StepShards:
    """`StepShards` of a rank ``index`` of ``size`` over vocab and ff with no
    group: the layers' partial results, summed by the test."""
    sp = Split(None, index, size)
    return StepShards(mesh=None, vocab=sp, ff=sp, fsdp_w=Split(), kv_slot=Split(),
                      batch=Split())


@pytest.mark.parametrize("int8", [False, True])
def test_layers_on_shards_sum_to_the_whole(int8):
    """`embed` / `unembed` / `swiglu` on each of 4 vocab / ff shards (no
    collective: the test sums): the embedding's rows bitwise the whole
    table's (an int8 table's per-row scale cut with its rows), the logits'
    columns and SwiGLU's partial sums within 1e-5."""
    g = torch.Generator().manual_seed(0)
    V, D, F, n = 512, 256, 512, 4
    table = torch.randn((V, D), generator=g) * 0.02
    w1, w3 = torch.randn((D, F), generator=g) / 16, torch.randn((D, F), generator=g) / 16
    w2 = torch.randn((F, D), generator=g) / 22
    if int8:
        qt = quantize_serve_params({"embed": table, "w1": w1, "w3": w3, "w2": w2})
        table, w1, w3, w2 = qt["embed"], qt["w1"], qt["w3"], qt["w2"]
    tokens = torch.randint(0, V, (3, 5), generator=g)
    x = torch.randn((3, 5, D), generator=g)
    spec = {"embed": ("model", None), "w1": (None, "model"), "w3": (None, "model"),
            "w2": ("model", None)}
    rows = mlp = 0
    logits = []
    for mesh in rank_meshes(n, 1):
        sh = local_shard({"embed": table, "w1": w1, "w3": w3, "w2": w2},
                         {k: (QTensor(q=v, scale=None) if int8 else v) for k, v in spec.items()},
                         mesh)
        s = _split_shards(mesh.model_idx, n)
        rows = rows + L.embed(tokens, sh["embed"], s)
        logits.append(L.unembed(x, sh["embed"], 30.0, s))
        mlp = mlp + L.swiglu(x, sh["w1"], sh["w3"], sh["w2"], s)
    assert torch.equal(rows, L.embed(tokens, table))
    torch.testing.assert_close(torch.cat(logits, dim=-1), L.unembed(x, table, 30.0),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(mlp, L.swiglu(x, w1, w3, w2), rtol=1e-5, atol=1e-5)


def test_cell_step_refuses_other_cells():
    """The train cells of the MoE, SSM, hybrid, encoder-decoder and VLM
    families execute their step: each arch's train_4k cell, cut to one
    layer (whisper: one encoder layer too), built on a fake (data 2, model
    2) mesh runs ``build_cell(...).fn`` to the reference's metrics and its
    shards' shapes; `build_cell(...).fn` refuses a cell built for axis
    sizes only (a train cell's too); `serve_step` refuses a family the port
    has no step for."""
    from repro_torch.distributed import step_stats
    from repro_torch.launch.mesh import fake_process_group, make_production_mesh

    axes = {"data": 2, "model": 4}
    with fake_process_group(4), step_stats.fake_tensors():
        mesh = make_production_mesh(model=2, data=2, device="cpu")
        for arch in ("qwen3-moe-30b-a3b", "mamba2-1.3b", "hymba-1.5b", "whisper-small",
                     "llava-next-34b"):
            cfg = dataclasses.replace(get_config(arch), n_layers=1,
                                      n_encoder_layers=min(1, get_config(arch).n_encoder_layers))
            cell = specs.build_cell(cfg, SHAPES["train_4k"], mesh)
            params, opt, metrics = cell.fn(*cell.args)
            assert set(metrics) == {"loss", "xent", "aux", "grad_norm", "lr"}, arch
            assert [p.shape for p in tree_leaves(params)] == [
                p.shape for p in tree_leaves(cell.args[0])], arch
    with step_stats.fake_tensors():
        for arch, shape in (("granite-3-2b", "train_4k"), ("granite-3-2b", "decode_32k"),
                            ("mamba2-1.3b", "decode_32k")):
            cell = specs.build_cell(get_config(arch), SHAPES[shape], axes)
            with pytest.raises(NotImplementedError, match="axis sizes"):
                cell.fn(*cell.args)
    with pytest.raises(NotImplementedError, match="no serve step"):
        specs.serve_step("decode", dataclasses.replace(get_config("mamba2-1.3b"), family="rnn"),
                         None, None, None, None, 0, 1)


# ---------------------------------------------------------------------------
# the SSD branch and the encoder / cross attention on shards, in-process
# ---------------------------------------------------------------------------


class _ThreadGroup:
    """``size`` ranks of a group as threads of this process: each collective
    waits for every rank's part, then sums (in rank order) or concatenates
    them.  `rank_view` is what one rank's `Mesh` holds."""

    def __init__(self, size: int, name: str = "model"):
        import threading

        self.size, self.name = size, name
        self.parts = [None] * size
        self.barrier = threading.Barrier(size)
        self.calls = [{"all_reduce": 0, "all_gather": 0} for _ in range(size)]

    def exchange(self, rank: int, x: torch.Tensor, kind: str) -> list:
        self.calls[rank][kind] += 1
        self.parts[rank] = x.clone()
        self.barrier.wait()
        out = list(self.parts)
        self.barrier.wait()
        return out

    def rank_view(self, rank: int):
        return dataclasses.replace(Group(None, self.name, self.size, rank, "gloo"), pg=(self, rank))


def _thread_comm(monkeypatch):
    """`comm`'s collectives over `_ThreadGroup` ranks (counted per rank in
    the group's ``calls``)."""
    from repro_torch.distributed import comm

    def all_reduce_sum(x, group):
        g, r = group.pg
        parts = g.exchange(r, x, "all_reduce")
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return x.copy_(total)

    def all_gather(x, group, dim=0):
        g, r = group.pg
        return torch.cat(g.exchange(r, x.contiguous(), "all_gather"), dim=dim)

    monkeypatch.setattr(comm, "all_reduce_sum", all_reduce_sum)
    monkeypatch.setattr(comm, "all_gather", all_gather)


def _run_ranks(n: int, fn) -> list:
    """``fn(mesh)`` on ``n`` thread ranks of a (data 1, model ``n``) mesh:
    each rank's (result, its collectives' calls by kind)."""
    import threading

    g = _ThreadGroup(n)
    out, errors = [None] * n, []

    def run(r):
        mesh = Mesh(rank=r, world=n, model=n, data=1, model_idx=r, data_idx=0,
                    model_group=g.rank_view(r), data_group=Group(None, "data", 1, 0, "gloo"),
                    device=torch.device("cpu"), backend="gloo")
        try:
            with torch.inference_mode():
                out[r] = fn(mesh)
        except BaseException as e:  # re-raised below
            errors.append(e)
            g.barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return list(zip(out, g.calls))


def _ssm_layer(arch: str):
    """The smoke config and one SSD layer's weights (fp32, seed 0), its
    decay, skip, dt-bias and norm vectors drawn non-zero."""
    from repro_torch.models.transformer import _ssm_params

    cfg = configs.get_smoke_config(arch)
    g = torch.Generator().manual_seed(0)
    pl = _ssm_params(cfg, g, torch.float32, "cpu")
    for key, (scale, off) in {"A_log": (0.5, 0.0), "dt_bias": (0.5, 0.0), "ssm_D": (0.5, 1.0),
                              "ssm_norm": (0.3, 0.0)}.items():
        pl[key] = scale * torch.randn(pl[key].shape, generator=g) + off
    return cfg, pl


@pytest.mark.parametrize("arch,n", [("mamba2-1.3b", 4), ("hymba-1.5b", 4)],
                         ids=["mamba2-all-split", "hymba-proj-and-heads-whole"])
def test_ssd_on_shards_sums_to_the_whole(monkeypatch, arch, n):
    """The SSD branch on ``n`` thread ranks under ``serve_rules`` (model
    ``n``) against the whole branch: the full-sequence block (prefill) and
    two decode steps, outputs within 1e-5 on every rank, each rank's conv
    window and SSD state bitwise the whole's slices at prefill, within 1e-5
    after the steps.  mamba2's smoke split cuts every dim (in_proj's 84
    columns 21 a rank across the z | xBC | dt boundaries, the conv's 48
    channels, 32 out_proj rows, 4 heads); hymba's keeps in_proj's 93
    columns and its 5 heads whole and cuts the conv and out_proj."""
    from repro_torch.distributed.sharding import step_shards
    from repro_torch.models import transformer as M

    _thread_comm(monkeypatch)
    cfg, pl = _ssm_layer(arch)
    s = cfg.ssm
    g = torch.Generator().manual_seed(1)
    h = torch.randn((2, 11, cfg.d_model), generator=g)
    steps = [torch.randn((2, 1, cfg.d_model), generator=g) for _ in range(2)]
    rules = serve_rules({"data": 1, "model": n})
    proj = 2 * s.d_inner + 2 * s.n_groups * s.state_size + s.num_heads
    assert (proj % n == 0, s.num_heads % n == 0) == ((True, True) if arch.startswith("mamba2")
                                                     else (False, False))

    def branch(shards, p):
        out, (cs, ss) = M.ssm_block_full(p, h, cfg, shards=shards)
        state = E.ServeState(cache=None, last_tokens=None, decode_steps=0,
                             ssm_state=ss[None].clone(), conv_state=cs[None].clone())
        outs = [out]
        for x in steps:
            outs.append(E._decode_ssm(p, x, cfg, 0, state, shards))
        return outs, (cs, ss), (state.conv_state[0], state.ssm_state[0])

    with torch.inference_mode():
        want, want_pre, want_end = branch(None, pl)

    def rank(mesh):
        sp = local_shard(pl, tree_specs(pl, rules, "serve"), mesh)
        shards = step_shards(rules, mesh, vocab=cfg.padded_vocab, ff=cfg.d_ff,
                             d_model=cfg.d_model, n_slots=0, batch=2, ssm=s)
        return branch(shards, sp), shards

    for (got, shards), calls in _run_ranks(n, rank):
        for a, b in zip(got[0], want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        c, hd = shards.ssm_conv, shards.ssm_heads
        for (cs, ss), (wcs, wss), exact in ((got[1], want_pre, True), (got[2], want_end, False)):
            nc = wcs.shape[-1] // c.size
            nh = wss.shape[1] // hd.size
            wcs = wcs[..., c.offset(nc):c.offset(nc) + nc]
            wss = wss[:, hd.offset(nh):hd.offset(nh) + nh]
            if exact:
                assert torch.equal(cs, wcs)
            torch.testing.assert_close(cs, wcs, rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(ss, wss, rtol=1e-5, atol=1e-5)
        # per call: in_proj's and the conv's gathers where they split, the
        # norm's Σ where the heads split, out_proj's all-reduce
        split_proj, split_heads = proj % n == 0, s.num_heads % n == 0
        assert calls == {"all_gather": 3 * (1 + split_proj), "all_reduce": 3 * (1 + split_heads)}


def test_encoder_and_cross_attention_on_shards_sum_to_the_whole(monkeypatch):
    """whisper's smoke encoder, cross K / V and cross attention with G = 2
    (4 query heads, 2 K / V heads) on thread ranks against the whole: at
    model 2 both head dims split, at model 4 the query heads split and the
    K / V heads stay whole (each rank takes its query heads' K / V heads);
    outputs within 1e-5, each rank's cross K / V its heads' slice."""
    from repro_torch.distributed.sharding import step_shards
    from repro_torch.models import transformer as M

    _thread_comm(monkeypatch)
    cfg = dataclasses.replace(configs.get_smoke_config("whisper-small"), n_kv_heads=2)
    params = M.init_params(cfg, 0, torch.float32, "cpu")
    g = torch.Generator().manual_seed(2)
    frames = 0.5 * torch.randn((2, cfg.encoder_seq_len, cfg.d_model), generator=g)
    hq = torch.randn((2, 3, cfg.d_model), generator=g)

    def run(shards, p):
        enc = M.encode(p, frames, cfg, shards)
        kvs = M.encoder_cross_kv(p, enc, cfg, shards)
        return enc, kvs, M.cross_attn_block(p["layers"][0], hq, kvs[0], cfg, shards)

    with torch.inference_mode():
        want = run(None, params)
    for n in (2, 4):
        rules = serve_rules({"data": 1, "model": n})

        def rank(mesh):
            p = local_shard(params, tree_specs(params, rules, "serve"), mesh)
            shards = step_shards(rules, mesh, vocab=cfg.padded_vocab, ff=cfg.d_ff,
                                 d_model=cfg.d_model, n_slots=0, batch=2, heads=cfg.n_heads,
                                 kv_heads=cfg.n_kv_heads)
            return run(shards, p), shards

        for ((enc, kvs, out), shards), _ in _run_ranks(n, rank):
            assert shards.heads.size == n and shards.kv_heads.size == (n if n == 2 else 1)
            torch.testing.assert_close(enc, want[0], rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(out, want[2], rtol=1e-5, atol=1e-5)
            kv = shards.kv_heads
            nk = cfg.n_kv_heads // kv.size
            for (k, v), (wk, wv) in zip(kvs, want[1]):
                torch.testing.assert_close(k, wk[:, :, kv.offset(nk):kv.offset(nk) + nk],
                                           rtol=1e-5, atol=1e-5)
                torch.testing.assert_close(v, wv[:, :, kv.offset(nk):kv.offset(nk) + nk],
                                           rtol=1e-5, atol=1e-5)
