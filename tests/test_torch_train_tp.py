"""The train cells' step (`repro_torch.launch.specs.train_step`: the
port's `train_step` on a rank's shards under the reference's
``train_rules``) of every family against the reference's single-device
`train_step`, on the CPU.

The ranks run as jobs of `tests/test_torch_mesh.py`'s two gloo spawns
(``train_rank`` in `tests/_torch_mesh_ranks.py`): the 1x2 spawn is (model
2, data 1), the 2x4 spawn (model 4, data 2), and the 2x4 spawn's eight
ranks also make a second mesh, (pod 2, data 2, model 2), whose rows split
over all four (pod, data) ranks.  A test needs the spawn's results in the
module that makes the spawn (pytest-xdist hands out whole files), so the
parity tests are there and call `check_train` here; this module holds the
reference side and the tests that need no ranks.

Setup: fp32 smoke configs of the four dense archs and of the MoE pair,
mamba2, hymba, whisper and llava (every norm scale, SSD vector and
qwen1.5's qkv biases drawn non-zero, `tests/test_torch_training.py`'s
``ref_params``), B 2 x T 32 (gemma2's window of 16 and the sequence
slices' edges, 16 or 8 positions, cross each other; mamba2's and hymba's
SSD chunk of 8, so the scan's state crosses every slice edge; hymba's 5
SSD heads and 93 ``in_proj`` columns stay whole at model 2 and 4; llava's
16 image positions fill whole slices at model 4; the MoE capacity is
global over both data ranks' rows on 2x4), three steps of `SyntheticLM`
batches (the stub frontends' frames and image embeddings fed to both
packages) with remat; granite-3-2b at B 4 on the pod mesh and,
one layer, at B 1 x T 2056 on 1x2 (past ``flash_threshold``: the
sequence-parallel flash attention and its recomputing backward, 1028
queries a rank over the 2056 keys).  The optimizer runs at lr 1e-3
(warmup 1, 3 steps): at 1e-2 Adam's first update lr·g/(|g| + eps) turns
the fp32 rounding of a gradient near eps into parameter steps past the
1e-4 bar whatever the order of the sums, the single-process port's
against the reference's too (`test_adam_amplifies_rounding_near_eps`).

Bars (`check_train`): every step's loss, xent, aux, grad norm and lr within
1e-4 of the reference's, the same on every rank; every rank's param,
master, mu and nu shards within 1e-4 of the reference's results cut to the
rank's shard; the optimizer's step 3; the first step's collectives those
`repro_torch.launch.dryrun.train_collectives` derives for the mesh.  In
process: the autograd pairs of `repro_torch.distributed.comm` and the
vocab-parallel cross-entropy on thread ranks; the expert-parallel MoE
block's output, aux loss and gradients on (data 2, model 2) thread ranks
against the whole block's; the groups a leaf's gradient is summed over;
the splits of every family and the step's refusals; on a mesh of one rank
the cell step is bitwise the local step, for every family.
"""
from __future__ import annotations

import dataclasses
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.training import optimizer as jopt
from repro.training import train_loop as jtl
from repro_torch import configs, interop
from repro_torch.configs import SHAPES, get_config
from repro_torch.distributed import comm
from repro_torch.distributed.param_specs import local_shard, tree_specs
from repro_torch.distributed.sharding import (Split, mesh_group, replicated_over,
                                              train_rules, train_shards)
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import Group, Mesh, fake_process_group, make_production_mesh
from repro_torch.models import init_params
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop as ttl
from tests import _torch_mesh_ranks as R
from tests.test_torch_training import ref_params

torch.set_num_threads(2)
TOL = 1e-4
ARCHS = ["minitron-8b", "gemma2-9b", "granite-3-2b", "qwen1.5-110b", "granite-moe-1b-a400m",
         "qwen3-moe-30b-a3b", "mamba2-1.3b", "hymba-1.5b", "whisper-small", "llava-next-34b"]
# (arch, B, T, layers) per spawn; the pod case runs as a second mesh of the
# 2x4 spawn's ranks, (model, data, pods)
CASES = {"1x2": [(a, 2, 32, None) for a in ARCHS] + [("granite-3-2b", 1, 2056, 1)],
         "2x4": [(a, 2, 32, None) for a in ARCHS]}
POD_CASE = ("granite-3-2b", 4, 32, None)
POD_LAYOUT = (2, 4, 2)


def case_id(case) -> str:
    arch, B, T, layers = case
    return f"{arch}-{B}x{T}" + ("" if layers is None else f"-{layers}layer")


# ---------------------------------------------------------------------------
# the reference side
# ---------------------------------------------------------------------------


def weights_tree(arch: str, layers=None) -> dict:
    """The reference's fp32 smoke weights (numpy), every norm scale and bias
    drawn non-zero."""
    return ref_params(R.train_cfg(jconfigs, arch, layers))


def reference_run(tree: dict, case) -> dict:
    """The reference's jitted single-device `train_step` over the case's
    batches: each step's metrics and the final params and optimizer state
    (numpy trees)."""
    arch, B, T, layers = case
    jcfg = R.train_cfg(jconfigs, arch, layers)
    step = jax.jit(jtl.make_train_step(jcfg, jopt.OptimizerConfig(**R.TRAIN_OPT), remat=True))
    p = jax.tree.map(jnp.asarray, tree)
    o = jopt.init_optimizer(p)
    metrics = []
    for b in R.train_batches(R.train_cfg(configs, arch, layers), B, T):
        p, o, m = step(p, o, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "params": jax.tree.map(np.asarray, p),
            "opt": {k: jax.tree.map(np.asarray, getattr(o, k)) for k in ("master", "mu", "nu")},
            "opt_step": int(o.step)}


def _cut(x: np.ndarray, spec, rank: dict, sizes: dict) -> np.ndarray:
    """The rank's shard of a whole numpy leaf under its spec: a dim split
    over ``model`` cut to the rank's model index, over ``data`` to its
    in-pod data index."""
    idx = {"model": rank["model_idx"], "data": rank["fsdp_idx"]}
    for d, phys in enumerate(spec):
        if phys is not None:
            n = x.shape[d] // sizes[phys]
            x = np.take(x, range(idx[phys] * n, (idx[phys] + 1) * n), axis=d)
    return x


def _pairs(got, want, spec, path=""):
    """(path, shard, whole, spec) over a numpy tree and its spec tree."""
    if isinstance(got, dict):
        for k in got:
            yield from _pairs(got[k], want[k], spec[k], f"{path}.{k}")
    elif isinstance(got, list):
        for i, (g, w, s) in enumerate(zip(got, want, spec)):
            yield from _pairs(g, w, s, f"{path}.{i}")
    else:
        yield path, got, want, spec


def check_train(ranks: list, ref: dict, case, model: int, data: int, pods: int = 1) -> None:
    """A train case's bars on every rank of a (pod, data, model) mesh
    (``data`` the in-pod size): see the module docstring."""
    arch, B, T, layers = case
    cfg = R.train_cfg(configs, arch, layers)
    sizes = {"model": model, "data": data}
    for r, got in enumerate(ranks):
        assert len(got["metrics"]) == len(ref["metrics"]) == R.TRAIN_STEPS
        for step, (m, want) in enumerate(zip(got["metrics"], ref["metrics"])):
            for k in ("loss", "xent", "aux", "grad_norm", "lr"):
                np.testing.assert_allclose(m[k], want[k], rtol=TOL, atol=TOL,
                                           err_msg=f"rank {r} step {step + 1} {k}")
        assert got["metrics"] == ranks[0]["metrics"]  # global: the same on every rank
        trees = [("params", got["params"], ref["params"])] + [
            (k, got["opt"][k], ref["opt"][k]) for k in ("master", "mu", "nu")]
        for name, mine, whole in trees:
            for path, shard, leaf, spec in _pairs(mine, whole, got["spec"]):
                np.testing.assert_allclose(shard, _cut(leaf, spec, got, sizes), rtol=TOL,
                                           atol=TOL, err_msg=f"rank {r} {name}{path}")
        assert got["opt_step"] == ref["opt_step"] == R.TRAIN_STEPS
        held = dryrun.train_contract(got["collectives"], cfg, B // (data * pods), T, model,
                                     data, pods)
        assert all(held.values()), (r, held, got["collectives"])


# ---------------------------------------------------------------------------
# in-process checks
# ---------------------------------------------------------------------------


class _Exchange:
    """``n`` thread ranks handing each other tensors at a barrier."""

    def __init__(self, n: int):
        self.n, self.slots = n, [None] * n
        self.barrier = threading.Barrier(n)

    def all(self, r: int, x: torch.Tensor) -> list:
        self.slots[r] = x.detach().clone()
        self.barrier.wait()
        parts = list(self.slots)
        self.barrier.wait()
        return parts


def _thread_collectives(monkeypatch):
    """`comm`'s primitives over `_Exchange` ranks (a group's ``pg`` is the
    (exchange, rank) pair); the autograd pairs call them by name."""
    def parts(x, group):
        ex, r = group.pg
        return ex.all(r, x)

    def all_reduce_sum(x, group):
        return x.copy_(torch.stack(parts(x, group)).sum(0))

    def all_reduce_max(x, group):
        return x.copy_(torch.stack(parts(x, group)).amax(0))

    def all_gather(x, group, dim=0):
        return torch.cat(parts(x.contiguous(), group), dim=dim)

    def reduce_scatter_sum(x, group, dim=0):
        total = torch.stack(parts(x, group)).sum(0)
        return total.chunk(group.size, dim=dim)[group.rank].contiguous()

    for fn in (all_reduce_sum, all_reduce_max, all_gather, reduce_scatter_sum):
        monkeypatch.setattr(comm, fn.__name__, fn)


def _threads(n: int, fn) -> list:
    """``fn(group)`` on ``n`` thread ranks of one group; their results."""
    ex, out, errors = _Exchange(n), [None] * n, []

    def run(r):
        try:
            out[r] = fn(Group((ex, r), "model", n, r, "threads"))
        except BaseException as e:  # re-raised below
            errors.append(e)
            ex.barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def test_comm_autograd_pairs(monkeypatch):
    """Each pair's forward and backward on 3 thread ranks, against sums
    written out: gather / reduce-scatter, reduce-scatter / gather,
    identity / all-reduce, all-reduce / identity."""
    _thread_collectives(monkeypatch)
    n = 3
    g = torch.Generator().manual_seed(0)
    xs = [torch.randn((2, 6, 4), generator=g) for _ in range(n)]
    ws = [torch.randn((2, 6, 4), generator=g) for _ in range(n)]  # the ranks' loss weights

    def run(fn, shape_w):
        def rank(group):
            x = xs[group.rank].clone().requires_grad_(True)
            y = fn(x, group)
            (y * ws[group.rank][tuple(slice(0, s) for s in shape_w(y))]).sum().backward()
            return y.detach(), x.grad
        return _threads(n, rank)

    def cols(t, r):
        return t[:, 2 * r:2 * r + 2]

    # gather along dim 1: every rank the concatenation; each shard's gradient
    # the sum over ranks of its columns of their weights
    got = run(lambda x, gr: comm.all_gather_diff(x[:, :2], gr, 1), lambda y: y.shape)
    whole = torch.cat([x[:, :2] for x in xs], 1)
    for r, (y, gx) in enumerate(got):
        assert torch.equal(y, whole)
        want = sum(cols(w, r) for w in ws)
        torch.testing.assert_close(gx[:, :2], want)
        assert not gx[:, 2:].any()
    # reduce-scatter along dim 1: the rank's columns of the sum; the gradient
    # the gathered weights
    got = run(lambda x, gr: comm.reduce_scatter_diff(x, gr, 1), lambda y: y.shape)
    total = sum(xs)
    for r, (y, gx) in enumerate(got):
        torch.testing.assert_close(y, cols(total, r))
        torch.testing.assert_close(gx, torch.cat([w[:, :2] for w in ws], 1))
    # identity forward, the gradient summed
    for r, (y, gx) in enumerate(run(comm.all_reduce_grad, lambda y: y.shape)):
        assert torch.equal(y, xs[r])
        torch.testing.assert_close(gx, sum(ws))
    # the sum forward (x untouched), the gradient passed through
    for r, (y, gx) in enumerate(run(comm.all_reduce_diff, lambda y: y.shape)):
        torch.testing.assert_close(y, total)
        assert torch.equal(gx, ws[r])


@pytest.mark.parametrize("n", [2, 4])
def test_vocab_parallel_xent_matches_whole(monkeypatch, n):
    """`vocab_parallel_xent` over ``n`` thread ranks' columns: the per-token
    loss of every rank and the concatenated gradient of the logits equal
    the whole logits' logsumexp - gold (and its autograd) within 1e-6,
    labels in every shard."""
    _thread_collectives(monkeypatch)
    g = torch.Generator().manual_seed(1)
    logits = 4 * torch.randn((2, 5, 16), generator=g)
    labels = torch.randint(0, 16, (2, 5), generator=g)
    w = torch.rand((2, 5), generator=g)
    whole = logits.clone().requires_grad_(True)
    want = torch.logsumexp(whole, -1) - torch.gather(whole, -1, labels[..., None])[..., 0]
    (want * w).sum().backward()
    v = 16 // n

    def rank(group):
        x = logits[..., group.rank * v:(group.rank + 1) * v].clone().requires_grad_(True)
        loss = ttl.vocab_parallel_xent(x, labels, group.rank * v, group)
        (loss * w).sum().backward()
        return loss.detach(), x.grad

    got = _threads(n, rank)
    for loss, _ in got:
        torch.testing.assert_close(loss, want.detach(), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(torch.cat([gx for _, gx in got], -1), whole.grad, rtol=1e-6,
                               atol=1e-6)


def _pod_mesh(model_idx=0, fsdp_idx=0, pod_idx=0) -> Mesh:
    """A (pod 2, data 2, model 2) `Mesh` value without process groups."""
    def grp(name, size, rank):
        return Group(None, name, size, rank, "gloo")

    data_idx = pod_idx * 2 + fsdp_idx
    return Mesh(rank=data_idx * 2 + model_idx, world=8, model=2, data=4, model_idx=model_idx,
                data_idx=data_idx, model_group=grp("model", 2, model_idx),
                data_group=grp("data", 4, data_idx), device=torch.device("cpu"),
                backend="gloo", pods=2, data_pod_group=grp("data_in_pod", 2, fsdp_idx),
                pod_group=grp("pod", 2, pod_idx), world_group=grp("world", 8, 0))


def test_groups_a_gradient_is_summed_over():
    """On (pod 2, data 2, model 2): ``data`` names the in-pod group and
    ``("pod", "data")`` the folded one; a leaf's gradient is summed over
    ``model`` and ``data`` where its spec splits no dim over them and over
    ``pod`` always; the global norm counts a shard on one replica."""
    mesh = _pod_mesh()
    assert mesh.axes == {"pod": 2, "data": 2, "model": 2}
    assert mesh_group(mesh, "data").name == "data_in_pod"
    assert mesh_group(mesh, ("pod", "data")).name == "data"
    assert mesh_group(mesh, "pod").name == "pod"
    cfg = configs.get_smoke_config("qwen1.5-110b")
    params = init_params(cfg, 0, torch.float32, "cpu")
    spec = tree_specs(params, train_rules(mesh), "train")
    names = {k: [g.name for g in replicated_over(spec["layers"][0][k], mesh)]
             for k in ("ln1", "wq", "bq", "w1", "w2")}
    assert names == {"ln1": ["model", "data_in_pod", "pod"],
                     "wq": ["model", "pod"], "bq": ["model", "data_in_pod", "pod"],
                     "w1": ["pod"], "w2": ["pod"]}
    assert [g.name for g in replicated_over(spec["embed"], mesh)] == ["pod"]
    owner = ttl._owner(params, spec, _pod_mesh(model_idx=1))
    assert owner[1].name == "world"
    assert owner[0]["layers"][0]["w1"] and not owner[0]["layers"][0]["wq"]
    assert not any(topt.tree_leaves(ttl._owner(params, spec, _pod_mesh(pod_idx=1))[0]))


def _mesh(model: int, data: int) -> Mesh:
    """A (data, model) `Mesh` value of rank 0 without process groups."""
    def grp(name, size):
        return Group(None, name, size, 0, "gloo")

    return Mesh(rank=0, world=model * data, model=model, data=data, model_idx=0, data_idx=0,
                model_group=grp("model", model), data_group=grp("data", data),
                device=torch.device("cpu"), backend="gloo", world_group=grp("world", model * data))


def _shards(arch: str, mesh, seq: int = 32, batch: int = 4, **over):
    cfg = dataclasses.replace(configs.get_smoke_config(arch), **over)
    moe = cfg.moe.num_experts > 0
    return train_shards(train_rules(mesh), mesh, vocab=cfg.padded_vocab,
                        ff=0 if moe else cfg.d_ff, d_model=cfg.d_model, seq=seq, batch=batch,
                        experts=cfg.moe.num_experts,
                        ssm=cfg.ssm if cfg.family in ("ssm", "hybrid") else None)


def test_train_step_refusals():
    """The cell step refuses rows the data axis does not divide (every rank
    must hold rows of its own), a sequence ``model`` does not divide, and,
    with more than one ``model`` rank, experts or an SSD inner dim that
    would stay whole there, naming the dim; a family the port has no step
    for."""
    mesh = _pod_mesh()
    rules = train_rules(mesh)
    cfg = configs.get_smoke_config("granite-3-2b")
    kw = dict(vocab=cfg.padded_vocab, ff=cfg.d_ff, d_model=cfg.d_model)
    with pytest.raises(ValueError, match="batch rows"):
        train_shards(rules, mesh, seq=32, batch=2, **kw)
    with pytest.raises(ValueError, match="sequence"):
        train_shards(rules, mesh, seq=33, batch=4, **kw)
    s = train_shards(rules, mesh, seq=32, batch=4, **kw)
    assert (s.batch.size, s.seq.size, s.fsdp.size, s.ff.size, s.vocab.size) == (4, 2, 2, 2, 2)
    assert s.heads == Split()
    with pytest.raises(ValueError, match=r"the experts \(4\) over 8 ranks"):
        _shards("granite-moe-1b-a400m", _mesh(8, 1))
    ssm = configs.get_smoke_config("mamba2-1.3b").ssm  # d_inner 4 x 8
    with pytest.raises(ValueError, match=r"the SSD's inner dim \(24\)"):
        _shards("mamba2-1.3b", _mesh(16, 1), ssm=dataclasses.replace(ssm, num_heads=3))
    with pytest.raises(NotImplementedError, match="no train step"):
        specs.train_step(dataclasses.replace(cfg, family="rnn"), mesh, rules, None, 4, 32)


@pytest.mark.parametrize("model,data", [(2, 2), (4, 1)])
def test_train_shards_of_every_family(model, data):
    """`train_shards` resolves every family's splits under ``train_rules``:
    the experts over ``model``, no MLP split for mamba2 (d_ff 0); the SSD's
    ``in_proj`` columns, conv channels and heads split where they divide
    (mamba2's 84 / 48 / 4; hymba's 93 columns and 5 heads stay whole, its
    48 channels and 40 inner rows split), the inner rows always."""
    mesh = _mesh(model, data)
    sizes = {}
    for arch in ARCHS:
        s = _shards(arch, mesh)
        sizes[arch] = {k: getattr(s, k).size for k in ("batch", "seq", "ff", "vocab", "expert",
                                                      "ssm_proj", "ssm_conv", "ssm_inner",
                                                      "ssm_heads")}
    m, d = model, data
    assert sizes["qwen3-moe-30b-a3b"] == dict(batch=d, seq=m, ff=1, vocab=m, expert=m,
                                              ssm_proj=1, ssm_conv=1, ssm_inner=1, ssm_heads=1)
    assert sizes["mamba2-1.3b"] == dict(batch=d, seq=m, ff=1, vocab=m, expert=1, ssm_proj=m,
                                        ssm_conv=m, ssm_inner=m, ssm_heads=m)
    assert sizes["hymba-1.5b"] == dict(batch=d, seq=m, ff=m, vocab=m, expert=1, ssm_proj=1,
                                       ssm_conv=m, ssm_inner=m, ssm_heads=1)
    for arch in ("whisper-small", "llava-next-34b", "granite-3-2b"):
        assert sizes[arch] == dict(batch=d, seq=m, ff=m, vocab=m, expert=1, ssm_proj=1,
                                   ssm_conv=1, ssm_inner=1, ssm_heads=1)


def _thread_mesh_groups(model: int, data: int):
    """Per rank (d, m) of a (data, model) mesh of thread ranks: its model,
    rows and world `Group`s (each ``pg`` the (exchange, index) pair)."""
    mex = [_Exchange(model) for _ in range(data)]
    dex = [_Exchange(data) for _ in range(model)]
    wex = _Exchange(model * data)
    out = {}
    for d in range(data):
        for m in range(model):
            out[d, m] = (Group((mex[d], m), "model", model, m, "threads"),
                         Group((dex[m], d), "data", data, d, "threads"),
                         Group((wex, d * model + m), "world", model * data, d * model + m,
                               "threads"))
    return out


def _run_grid(model: int, data: int, fn) -> dict:
    """``fn(d, m, groups)`` on a thread per rank of a (data, model) mesh."""
    groups, out, errors = _thread_mesh_groups(model, data), {}, []
    exchanges = {id(g.pg[0]): g.pg[0] for gs in groups.values() for g in gs}

    def run(key):
        try:
            out[key] = fn(*key, groups[key])
        except BaseException as e:  # re-raised below
            errors.append(e)
            for ex in exchanges.values():
                ex.barrier.abort()

    threads = [threading.Thread(target=run, args=(k,)) for k in groups]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def test_moe_block_on_train_shards_matches_whole(monkeypatch):
    """The expert-parallel MoE block of a train step on (data 2, model 2)
    thread ranks (the rank's rows with their whole sequence in, its
    experts and router columns, out onto its sequence slice) against the
    whole block at a capacity that drops (factor 0.5): every rank's output
    slice and aux loss, and, from a loss Σ out·w + 3·aux on every rank,
    the gradients of the input (summed over ``model``, as the sequence
    gather's backward sums them), of the router's and the experts' shards
    (summed over ``data``, as their replication does), within 1e-5; the aux
    is global (the same on every rank) and its gradient the whole one's."""
    from repro_torch.distributed.sharding import TrainShards
    from repro_torch.models import moe as tmoe

    _thread_collectives(monkeypatch)
    base = configs.get_smoke_config("qwen3-moe-30b-a3b")  # 8 experts, top 2
    cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, capacity_factor=0.5))
    model, data, B, S, D = 2, 2, 4, 8, base.d_model
    g = torch.Generator().manual_seed(3)
    pl = tmoe.init_moe_params(cfg, g, torch.float32, "cpu")
    x = torch.randn((B, S, D), generator=g)
    w = torch.randn((B, S, D), generator=g)
    whole = {k: v.clone().requires_grad_(True) for k, v in pl.items()}
    xw = x.clone().requires_grad_(True)
    out, aux = tmoe.moe_block(whole, xw, cfg)
    ((out * w).sum() + 3.0 * aux).backward()
    E, b, t, e = cfg.moe.num_experts, B // data, S // model, cfg.moe.num_experts // model

    def rank(d, m, groups):
        gm, gd, gw = groups
        mesh = types.SimpleNamespace(world=model * data, world_group=gw)
        shards = TrainShards(mesh=mesh, batch=Split(gd, d, data), seq=Split(gm, m, model),
                             fsdp=Split(), ff=Split(), vocab=Split(),
                             expert=Split(gm, m, model))
        mine = {"router": pl["router"][:, m * e:(m + 1) * e],
                **{k: pl[k][m * e:(m + 1) * e] for k in ("we1", "we3", "we2")}}
        mine = {k: v.clone().requires_grad_(True) for k, v in mine.items()}
        xr = x[d * b:(d + 1) * b].clone().requires_grad_(True)
        o, a = tmoe.moe_block(mine, xr, cfg, shards)
        ((o * w[d * b:(d + 1) * b, m * t:(m + 1) * t]).sum() + 3.0 * a).backward()
        return o.detach(), a.detach(), xr.grad, {k: v.grad for k, v in mine.items()}

    got = _run_grid(model, data, rank)
    close = dict(rtol=1e-5, atol=1e-5)
    for (d, m), (o, a, _, _) in got.items():
        torch.testing.assert_close(o, out.detach()[d * b:(d + 1) * b, m * t:(m + 1) * t], **close)
        torch.testing.assert_close(a, aux.detach(), **close)
    for d in range(data):
        gx = sum(got[d, m][2] for m in range(model))
        torch.testing.assert_close(gx, xw.grad[d * b:(d + 1) * b], **close)
    for m in range(model):
        # the router's columns (the gather's backward summed the model ranks')
        gr = sum(got[d, m][3]["router"] for d in range(data))
        torch.testing.assert_close(gr, whole["router"].grad[:, m * e:(m + 1) * e], **close)
        for k in ("we1", "we3", "we2"):
            gk = sum(got[d, m][3][k] for d in range(data))
            torch.testing.assert_close(gk, whole[k].grad[m * e:(m + 1) * e], **close)
    assert E == 8 and cfg.moe.top_k == 2


@pytest.mark.parametrize("arch", ["gemma2-9b", "qwen1.5-110b", "granite-moe-1b-a400m",
                                  "mamba2-1.3b", "hymba-1.5b", "whisper-small",
                                  "llava-next-34b"])
def test_one_rank_cell_step_is_the_local_step(arch):
    """On a mesh of one rank every group is of one and issues nothing: the
    cell step's metrics, params and optimizer state are bitwise the local
    `train_step`'s over three steps (real tensors under the one-rank fake
    group, which no collective reaches), for every family."""
    cfg = configs.get_smoke_config(arch)
    ocfg = topt.OptimizerConfig(**R.TRAIN_OPT)
    batches = R.train_batches(cfg, 2, 32)

    def run(step):
        params = init_params(cfg, 0, torch.float32, "cpu")
        opt, mets = topt.init_optimizer(params), []
        for b in batches:
            params, opt, m = step(params, opt, {k: torch.as_tensor(v) for k, v in b.items()})
            mets.append(m)
        return params, opt, mets

    local = run(ttl.make_train_step(cfg, ocfg))
    before = comm.snapshot()
    with fake_process_group(1):
        mesh = make_production_mesh(model=1, data=1, device="cpu")
        rules = train_rules(mesh)
        spec = tree_specs(init_params(cfg, 0, torch.float32, "cpu"), rules, "train")
        cell = run(specs.train_step(cfg, mesh, rules, spec, 2, 32, ocfg))
    assert not comm.since(before)
    for a, b in zip(local[2], cell[2]):
        assert all(torch.equal(a[k], b[k]) for k in a)
    for a, b in zip(topt.tree_leaves(local[:2]), topt.tree_leaves(cell[:2])):
        assert torch.equal(a, b)


def test_adam_amplifies_rounding_near_eps():
    """Why the train cases run at lr 1e-3: a gradient of 1e-8 (Adam's eps)
    and one 1e-9 off it (fp32 rounding of sums whose terms are ~1e-3)
    give first updates lr·g/(|g| + eps) 0.024·lr apart: past the 1e-4 bar
    at lr 1e-2, inside it at 1e-3."""
    g = torch.tensor([1e-8], dtype=torch.float32)
    gaps = {}
    for lr in (1e-2, 1e-3):
        cfg = topt.OptimizerConfig(lr=lr, warmup_steps=1, total_steps=3)
        out = []
        for x in (g, g + 1e-9):
            state = topt.init_optimizer({"w": torch.zeros(1)})
            out.append(topt.adamw_update({"w": x}, state, cfg)[0]["w"])
        gaps[lr] = abs(float(out[0] - out[1]))
    assert gaps[1e-2] > 2 * TOL and gaps[1e-3] < TOL / 2


def test_dense_train_cell_builds_its_step():
    """A dense arch's train_4k cell built on a (fake) mesh runs the train
    step, as every family's does (`tests/test_torch_tp.py`'s
    ``test_cell_step_refuses_other_cells``, the dry run's train files)."""
    cfg = dataclasses.replace(get_config("granite-3-2b"), n_layers=1)
    with fake_process_group(4):
        mesh = make_production_mesh(model=2, data=2, device="cpu")
        from repro_torch.distributed import step_stats
        with step_stats.fake_tensors():
            cell = specs.build_cell(cfg, SHAPES["train_4k"], mesh)
            params, opt, metrics = cell.fn(*cell.args)
    assert set(metrics) == {"loss", "xent", "aux", "grad_norm", "lr"}
    assert params["embed"].shape == cell.args[0]["embed"].shape
    assert opt.mu["layers"][0]["w1"].shape == cell.args[1].mu["layers"][0]["w1"].shape


def test_local_shard_of_a_reference_tree_matches_cut():
    """`_cut` (the parity tests' slicing of the reference's results) is
    `local_shard`'s cut on every rank of the pod mesh."""
    tree = weights_tree("granite-3-2b")
    for model_idx in range(2):
        for fsdp_idx in range(2):
            mesh = _pod_mesh(model_idx, fsdp_idx)
            spec = tree_specs(tree, train_rules(mesh), "train")
            shards = interop.to_numpy(local_shard(interop.to_torch(tree), spec, mesh))
            rank = {"model_idx": model_idx, "fsdp_idx": fsdp_idx}
            for _, shard, leaf, sp in _pairs(shards, tree, spec):
                assert np.array_equal(shard, _cut(leaf, sp, rank, {"model": 2, "data": 2}))


def test_reduce_scatter_counted_by_its_shard():
    """`comm.reduce_scatter_sum` on a fake group of two: the rank's shard of
    the cut dim, counted by its bytes, the reference's convention for a
    reduce-scatter (`step_stats.comm_bytes`)."""
    from repro_torch.distributed import step_stats

    with fake_process_group(2):
        mesh = make_production_mesh(model=2, data=1, device="cpu")
        before = comm.snapshot()
        out = comm.reduce_scatter_sum(torch.ones((2, 6, 3)), mesh.model_group, dim=1)
        delta = comm.since(before)
    assert out.shape == (2, 3, 3)
    assert comm.by_kind(delta) == {"model": {"reduce_scatter": {"calls": 1, "elements": 18,
                                                                "bytes": 72}}}
    assert step_stats.collective_stats(delta) == {"reduce-scatter": {"count": 1, "bytes": 72}}
