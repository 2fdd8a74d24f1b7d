"""The (data, model) process mesh of the multi-GPU executor (port of
``repro.launch.mesh``).

The reference drives every device from one process (``shard_map`` over a
``jax.make_mesh``).  The port runs one process per rank, as ``torchrun``
does: every rank runs the same engine, scheduler and planner on the same
host data, and only the device tensors are sharded.  Rank ``r`` of a
``model * data`` world sits at ``(data_idx, model_idx) = divmod(r, model)``,
the reference's device order; its ``model`` group holds the ranks of its
data index (the slot dim splits over them), its ``data`` group the ranks of
its model index (batch rows split over them).  Pool partition ``p =
model_idx * data + data_idx`` lives on the rank, as in the reference.

Backends: ``"nccl"`` with one rank per card (``cuda:{LOCAL_RANK}``);
``"gloo"`` on the CPU, or with CUDA tensors when a device is asked for by
name (several ranks sharing one card; gloo takes the CUDA tensors and
copies them through host memory itself).  No fallback: a mesh
without an initialised process group, a world of another size, or NCCL
with more ranks than cards raises.

`spawn` starts the ranks of a mesh on this host with ``torch.multiprocessing``
and a ``file://`` rendezvous (no port to clash on), runs ``fn(mesh, *args)``
in each and returns their results in rank order.

A mesh may fold pods into its data axis (``pods`` > 1): rank ``r`` then
sits at pod ``data_idx // (data / pods)``, and beside the folded ``data``
group (the rows: ``("pod", "data")`` in the rules) it has the ranks of its
own pod and model index (``data_pod_group``, named ``"data_in_pod"``: the
rules' ``"data"`` axis alone, over which FSDP splits the weights) and the
ranks of its in-pod data and model index (``pod_group``).  With one pod
the in-pod group is the data group and there is no pod group.
``world_group`` is every rank of the mesh.

The production meshes (`make_production_mesh`: (data 16, model 16), or
(pod 2, data 16, model 16) with ``pod`` folded into ``data``) exist for
the dry run (`repro_torch.launch.dryrun`): it builds them over
`fake_process_group`, a ``"fake"`` backend of 256 or 512 ranks in one
process whose collectives move nothing, and runs rank 0's steps on fake
tensors.  Only these two accept the fake backend.
"""
from __future__ import annotations

import contextlib
import os
import pickle
import tempfile
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import comm


@dataclass(frozen=True)
class Group:
    """One axis of the mesh as seen from this rank."""

    pg: Any  # the torch.distributed process group
    name: str  # "model" | "data"
    size: int
    rank: int  # this process's index in the group
    backend: str


@dataclass(frozen=True)
class Mesh:
    rank: int
    world: int
    model: int  # model-axis size: the slot dim splits over it
    data: int  # data-axis size: batch rows split over it
    model_idx: int
    data_idx: int
    model_group: Group
    data_group: Group
    device: torch.device
    backend: str
    pods: int = 1  # the data axis folds (pod, data) when > 1
    # the rank's pod's share of the data axis (None: the data group itself)
    data_pod_group: Optional[Group] = None
    pod_group: Optional[Group] = None  # the same in-pod data and model index
    world_group: Optional[Group] = None  # every rank of the mesh

    @property
    def fsdp_group(self) -> Group:
        """The rules' ``"data"`` axis: the ranks of this rank's pod and model
        index (the data group when the mesh has one pod)."""
        return self.data_pod_group or self.data_group

    @property
    def axes(self) -> Dict[str, int]:
        """Mesh axis sizes by name, in mesh order: ``{"data", "model"}``, or
        ``{"pod", "data", "model"}`` when the data axis folds pods."""
        if self.pods > 1:
            return {"pod": self.pods, "data": self.data // self.pods, "model": self.model}
        return {"data": self.data, "model": self.model}

    @property
    def part(self) -> int:
        """This rank's pool partition (model-major, as the reference's)."""
        return self.model_idx * self.data + self.data_idx

    def slots(self, n_slots: int) -> slice:
        """This rank's slots of an ``n_slots`` grid."""
        if n_slots % self.model:
            raise ValueError(
                f"{n_slots} slots do not split over model={self.model}; plan "
                f"with n_shards (or slots_per_shard) a multiple of the model size")
        k = n_slots // self.model
        return slice(self.model_idx * k, (self.model_idx + 1) * k)

    def rows(self, n_rows: int) -> slice:
        """This rank's rows of an ``n_rows`` batch."""
        if n_rows % self.data:
            raise ValueError(
                f"batch {n_rows} does not split over data={self.data}; size the "
                f"batch (scheduler max_rows / generate batch) as a multiple of it")
        k = n_rows // self.data
        return slice(self.data_idx * k, (self.data_idx + 1) * k)

    def host_lengths(self, lengths: torch.Tensor, rows: bool = True) -> np.ndarray:
        """A sharded (L, S/model, B[/data]) lengths tensor as the global
        (L, S, B) numpy array, the same on every rank (every rank must call
        it at the same point).  ``rows=False``: the rows are not split (a
        prefill's sub-state)."""
        full = comm.all_gather(lengths, self.model_group, dim=1)
        if rows:
            full = comm.all_gather(full, self.data_group, dim=2)
        return full.cpu().numpy()

    def sum_over(self, values: Sequence[float], rows: bool = True) -> List[float]:
        """Host scalars summed over the model group (and the data group when
        ``rows``): a metric computed from one rank's shard, made global."""
        t = torch.as_tensor(np.asarray(values, np.float64), device=self.device)
        comm.all_reduce_sum(t, self.model_group)
        if rows:
            comm.all_reduce_sum(t, self.data_group)
        return t.cpu().tolist()


def make_host_mesh(model: int = 1, data: int = 1, device=None, pods: int = 1) -> Mesh:
    """The mesh over the initialised default process group, which must hold
    exactly ``model * data`` ranks.  ``device``: the tensors' device under
    gloo (default the CPU; ``"cuda"`` / ``"cuda:N"`` to share a card);
    NCCL ranks take ``cuda:{LOCAL_RANK}`` and may not name another.
    ``pods``: the data axis folds that many pods of ``data / pods`` ranks
    (the module docstring).  Every rank must make the same meshes in the
    same order: each makes its groups."""
    return _make_mesh(model, data, device, pods=pods, fake_ok=False)


@contextlib.contextmanager
def fake_process_group(world: int):
    """A default process group of ``world`` ranks on the ``"fake"`` backend,
    this process being rank 0: collectives return at once and move nothing.
    Refuses when a default group exists; destroys the group on exit."""
    if dist.is_initialized():
        raise RuntimeError(
            "fake_process_group: a default process group already exists "
            f"(backend {dist.get_backend()!r}); destroy it first")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_production_mesh(multi_pod: bool = False, device="cuda", model: int = 16,
                         data: int = 16) -> Mesh:
    """The production mesh over the initialised default group: (data 16,
    model 16) = 256 ranks, or with ``multi_pod`` (pod 2, data 16, model 16)
    = 512 ranks, ``pod`` folded into a data axis of 32 (``model`` / ``data``
    give a smaller mesh of the same layout).  On the fake backend
    (`fake_process_group`) the tensors go on ``device`` without touching it."""
    pods = 2 if multi_pod else 1
    return _make_mesh(model, data * pods, device, pods=pods, fake_ok=True)


def _make_mesh(model: int, data: int, device, pods: int = 1, fake_ok: bool = False) -> Mesh:
    """`make_host_mesh`; ``fake_ok`` is given by `make_production_mesh`
    only, the one caller that accepts the fake backend."""
    if model < 1 or data < 1 or pods < 1:
        raise ValueError(f"mesh sizes must be >= 1, got model={model}, data={data}, "
                         f"pods={pods}")
    if data % pods:
        raise ValueError(f"a data axis of {data} ranks does not fold {pods} pods")
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(
            f"make_host_mesh(model={model}, data={data}) needs an initialised "
            f"torch.distributed process group of {model * data} ranks: start the "
            f"ranks with repro_torch.launch.mesh.spawn or torchrun")
    world, rank = dist.get_world_size(), dist.get_rank()
    if model * data != world:
        raise ValueError(
            f"requested mesh (data={data}, model={model}) = {model * data} ranks, "
            f"but the process group holds {world}; start exactly model * data ranks")
    backend = str(dist.get_backend())
    if backend == "nccl":
        n_cards = torch.cuda.device_count()
        if world > n_cards:
            raise ValueError(
                f"nccl needs one card per rank: {world} ranks, {n_cards} cards "
                f"(gloo with device='cuda' shares one card between ranks)")
        local = int(os.environ.get("LOCAL_RANK", rank % n_cards))
        dev = torch.device("cuda", local)
        if device is not None and torch.device(device) != dev:
            raise ValueError(f"an nccl rank runs on {dev}, not {device}")
        torch.cuda.set_device(dev)
    elif backend == "gloo":
        dev = torch.device(device or "cpu")
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise ValueError(f"device {device!r} asked for, but CUDA is not available")
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            torch.cuda.set_device(dev)
    elif backend == "fake" and fake_ok:
        dev = torch.device(device or "cuda")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", 0)
    else:
        raise ValueError(f"unsupported process-group backend {backend!r} (nccl or gloo; "
                         f"'fake' only through make_production_mesh)")
    data_idx, model_idx = divmod(rank, model)
    model_group = data_group = None
    # every rank creates every group, in the same order
    for d in range(data):
        pg = dist.new_group([d * model + m for m in range(model)])
        if d == data_idx:
            model_group = Group(pg, "model", model, model_idx, backend)
    for m in range(model):
        pg = dist.new_group([d * model + m for d in range(data)])
        if m == model_idx:
            data_group = Group(pg, "data", data, data_idx, backend)
    data_pod_group = pod_group = None
    if pods > 1:
        per_pod = data // pods
        pod_idx, d_idx = divmod(data_idx, per_pod)
        for p in range(pods):
            for m in range(model):
                pg = dist.new_group([(p * per_pod + d) * model + m for d in range(per_pod)])
                if (p, m) == (pod_idx, model_idx):
                    data_pod_group = Group(pg, "data_in_pod", per_pod, d_idx, backend)
        for d in range(per_pod):
            for m in range(model):
                pg = dist.new_group([(p * per_pod + d) * model + m for p in range(pods)])
                if (d, m) == (d_idx, model_idx):
                    pod_group = Group(pg, "pod", pods, pod_idx, backend)
    world_group = Group(dist.group.WORLD, "world", world, rank, backend)
    return Mesh(rank=rank, world=world, model=model, data=data, model_idx=model_idx,
                data_idx=data_idx, model_group=model_group, data_group=data_group,
                device=dev, backend=backend, pods=pods, data_pod_group=data_pod_group,
                pod_group=pod_group, world_group=world_group)


def _rank_main(rank: int, fn, args, model: int, data: int, backend: str,
               init_file: str, device) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                            world_size=model * data)
    try:
        out = fn(make_host_mesh(model=model, data=data, device=device), *args)
        with open(f"{init_file}.rank{rank}", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, model: int = 1, data: int = 1, backend: str = "gloo",
          init_file: Optional[str] = None, device=None, args: tuple = (),
          timeout: float = 600.0) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``model * data`` new processes, one per
    rank, and return their (picklable) results in rank order.

    ``fn`` must be importable by name (a module-level function); the ranks
    meet through ``init_file`` (``file://`` rendezvous; a fresh path in a
    new temporary directory by default; it must not exist yet).  Each rank
    uses one CPU thread.  A rank that raises fails the call with
    its traceback; past ``timeout`` seconds every rank is killed and
    ``TimeoutError`` raised."""
    import torch.multiprocessing as mp

    world = model * data
    if backend == "nccl" and world > torch.cuda.device_count():
        raise ValueError(
            f"nccl needs one card per rank: {world} ranks, "
            f"{torch.cuda.device_count()} cards")
    if init_file is None:
        init_file = os.path.join(tempfile.mkdtemp(prefix="mesh-"), "rendezvous")
    ctx = mp.start_processes(_rank_main, args=(fn, args, model, data, backend, init_file,
                                               device),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, min(5.0, deadline - time.monotonic()))):
            if time.monotonic() > deadline:
                raise TimeoutError(f"mesh ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    out = []
    for r in range(world):
        with open(f"{init_file}.rank{r}", "rb") as f:
            out.append(pickle.load(f))
    return out
