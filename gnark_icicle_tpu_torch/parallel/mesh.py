"""A device mesh of one axis on torch.distributed: one process a rank.

The port's counterpart of ``jax.sharding.Mesh`` with its one axis
``"shard"`` (gnark_icicle_tpu/parallel/msm.py:27, ntt.py:39,
pipeline.py:34-51). The JAX package drives every device of a mesh from one
controller, and the bodies of its ``shard_map`` calls run on each device;
here each rank is a process of its own (SPMD) that runs those bodies on its
own device, and JAX's ``all_gather``/``all_to_all`` are ``torch.distributed``
collectives over the mesh's process group. One controller would not do: the
port's MSM reads counts back to the host mid-call (``ops/msm.py``), so one
process would run the shards of an MSM one after another.

A rank's device is explicit: ``cuda:(LOCAL_RANK % device_count)`` on the
card, ``cpu`` only where the caller asks for it. The backend is the
caller's too: ``"nccl"`` where every rank has a card of its own, ``"gloo"``
for ranks that share a card or run on the CPU. Nothing switches backend or
device because something failed.

``split_submeshes`` (pipeline.py:34-51) carves a mesh into disjoint
sub-meshes, each a ``dist.new_group``: every rank of the mesh calls
``new_group`` for every sub-mesh, in the same order, those outside it too.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


class Mesh:
    """A process group along one axis: its global ranks in order, this
    rank's index among them (None where this rank is outside), the device
    of this rank and the group's backend."""

    def __init__(self, group, ranks, device, backend: str):
        self.group = group
        self.ranks = tuple(ranks)
        self.size = len(self.ranks)
        me = dist.get_rank()
        self.index = self.ranks.index(me) if me in self.ranks else None
        self.device = torch.device(device)
        self.backend = backend
        self._submeshes: dict = {}

    @property
    def member(self) -> bool:
        return self.index is not None

    def __repr__(self) -> str:
        return (f"Mesh(ranks={list(self.ranks)}, index={self.index}, device={self.device}, "
                f"backend={self.backend!r})")

    # -- collectives over the group (members only) -----------------------------
    def all_gather(self, t: torch.Tensor) -> list:
        """Every member's tensor of t's shape, in rank order (the list form
        of ``all_gather``, which both backends take)."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return parts

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """Chunk k of t's dim 0 to member k; chunk s of the result from
        member s (``all_to_all_single``)."""
        t = t.contiguous()
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=self.group)
        return out

    def _object_device(self):
        # NCCL moves objects through tensors on the rank's card; gloo on the host
        return self.device if self.backend == "nccl" else None

    def broadcast_object(self, obj):
        """The first member's obj on every member (pickled)."""
        box = [obj]
        dist.broadcast_object_list(box, src=self.ranks[0], group=self.group,
                                   device=self._object_device())
        return box[0]

    def all_gather_object(self, obj) -> list:
        """Every member's obj, in rank order (pickled)."""
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)


def rank_device(device=None, local_rank: int | None = None) -> torch.device:
    """This rank's device: ``device`` where the caller names one with an
    index or ``"cpu"``; else (None or ``"cuda"``) the card ``local_rank %
    device_count`` (``LOCAL_RANK`` of the environment, else the global
    rank). Raises where torch sees no card."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda" or device.index is not None:
            return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the mesh on the CPU")
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def world_mesh(backend: str, device=None, rank: int | None = None,
               world_size: int | None = None, init_method: str | None = None,
               local_rank: int | None = None) -> Mesh:
    """The mesh of every rank: the default process group, initialised here
    where it is not yet, from the arguments or else from torchrun's
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``:
    ``init_method`` "env://"). ``device``: see :func:`rank_device`."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not {backend!r}")
    if not dist.is_initialized():
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                world_size=world_size)
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, not {backend!r}")
    dev = rank_device(device, local_rank)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("NCCL runs on CUDA devices only: take gloo for the CPU")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(dist.group.WORLD, range(dist.get_world_size()), dev, backend)


def split_submeshes(mesh: Mesh, shares: dict, backend: str | None = None) -> dict:
    """Carve `mesh` into named sub-meshes, each a disjoint run of its ranks
    in order (gnark_icicle_tpu/parallel/pipeline.py:34-51): shares is
    {name: ranks}, their sum at most the mesh's size. Every rank of the mesh
    must call this with the same shares (each ``dist.new_group`` is a
    collective of the whole world, in this order). The split is made once a
    mesh and shares; ``backend`` (default: the mesh's) names the sub-groups'."""
    backend = backend or mesh.backend
    key = (tuple(shares.items()), backend)
    if key in mesh._submeshes:
        return mesh._submeshes[key]
    total = sum(shares.values())
    if total > mesh.size:
        raise ValueError(f"need {total} ranks for {shares}, have {mesh.size}")
    out, off = {}, 0
    for name, n in shares.items():
        ranks = mesh.ranks[off:off + n]
        out[name] = Mesh(dist.new_group(list(ranks), backend=backend), ranks, mesh.device,
                         backend)
        off += n
    mesh._submeshes[key] = out
    return out
