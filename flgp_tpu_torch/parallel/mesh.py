"""Process meshes on ``torch.distributed``: one process per device.

The JAX package lays its devices out as a ``jax.sharding.Mesh`` and runs
shard-mapped functions over it.  Here every process drives one device and a
:class:`Mesh` names the process group, the axis, this process's rank, the
world size and the device.  The axis conventions are the JAX package's:

- ``data``: the n-point axis of the spectral stage (the rows of X, of the
  ELL graph and of the (n, K) eigenvector store);
- ``chain``: MCMC chains and SMC particles.

A sharded function takes this rank's rows and the replicated arguments and
returns the replicated results and this rank's rows; its reductions over
rows are all-reduces over the group.  A mesh of world size 1 needs no
process group: its collectives are the identity, by definition and not as a
fallback, so a sharded function on one process is the single-process
computation.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import resolve_device


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> bool:
    """Start the process group from explicit arguments or from the
    environment (``FLGP_COORDINATOR`` = host:port, ``FLGP_NUM_PROCESSES``,
    ``FLGP_PROCESS_ID``).  NCCL when the device is a CUDA device (``None``:
    the card, one per process, ``process_id`` modulo the visible cards),
    gloo on the CPU (``device="cpu"``).  Returns False when no multi-process
    configuration is given (single-process mode), True once the group is up;
    a second call returns True."""
    coordinator_address = coordinator_address or os.environ.get("FLGP_COORDINATOR")
    if num_processes is None and "FLGP_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["FLGP_NUM_PROCESSES"])
    if process_id is None and "FLGP_PROCESS_ID" in os.environ:
        process_id = int(os.environ["FLGP_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return False
    if dist.is_initialized():
        return True
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("init_distributed needs the coordinator, the number of processes "
                         "and this process's id")
    device = resolve_device(device, "the multi-device layer")
    if device.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method=init,
                            world_size=num_processes, rank=process_id)
    return True


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One axis of processes: the group (``None`` for world size 1), the
    axis name, this process's rank, the world size and its device."""

    group: Optional[dist.ProcessGroup]
    axis: str
    rank: int
    size: int
    device: torch.device

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Σ over the ranks of x (a new tensor; x itself at world size 1)."""
        if self.size == 1:
            return x
        out = x.detach().clone()
        dist.all_reduce(out, group=self.group)
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' x (equal shapes) concatenated along dim 0 in rank order."""
        if self.size == 1:
            return x
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=0)

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """Rank 0's x on every rank."""
        if self.size == 1:
            return x
        out = x.detach().clone().contiguous()
        dist.broadcast(out, src=0, group=self.group)
        return out

    def check_axis(self, axis: str) -> None:
        if axis != self.axis:
            raise ValueError(f"the mesh's axis is {self.axis!r}, not {axis!r}")


def _mesh_device(device) -> torch.device:
    """The device of a mesh: the caller's, else the process group's (the
    current card under NCCL, the CPU under gloo), else the card."""
    if device is not None or not dist.is_initialized():
        return resolve_device(device, "the multi-device layer")
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("data",),
    shape: Optional[Sequence[int]] = None,
    device=None,
) -> Mesh:
    """A one-axis mesh over every process of the default group (a single
    process without one).  ``n_devices``, if given, must be that count: a
    process drives one device.  ``shape``, if given, is (world,) padded with
    ones, as the JAX package's leading axis."""
    size = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is not None and n_devices != size:
        raise ValueError(f"{n_devices} devices asked for, {size} processes run (one device each)")
    if shape is not None and (int(np.prod(shape)) != size or shape[0] != size):
        raise ValueError(f"mesh shape {tuple(shape)} does not lay {size} processes on its first axis")
    group = dist.group.WORLD if size > 1 else None
    rank = dist.get_rank() if dist.is_initialized() else 0
    return Mesh(group, axis_names[0], rank, size, _mesh_device(device))


def global_mesh(axis_names: Sequence[str] = ("data",), shape: Optional[Sequence[int]] = None,
                device=None) -> Mesh:
    """The mesh over all processes, rank order = row-block order."""
    return make_mesh(None, axis_names, shape, device)


def shard_rows(mesh: Mesh, x, axis: str = "data") -> torch.Tensor:
    """This rank's block of the rows of ``x`` (a tensor or an array, the
    same on every rank), on the mesh's device: block ``rank`` of ``size``
    equal blocks, so the leading length must divide by the world size
    (:func:`pad_to_multiple`)."""
    mesh.check_axis(axis)
    x = torch.as_tensor(x)
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split into {mesh.size} equal blocks")
    rows = n // mesh.size
    return x[mesh.rank * rows:(mesh.rank + 1) * rows].to(mesh.device).contiguous()


def replicate(mesh: Mesh, x) -> torch.Tensor:
    """``x`` on the mesh's device, rank 0's value on every rank."""
    return mesh.broadcast(torch.as_tensor(x).to(mesh.device).contiguous())


def pad_to_multiple(x: torch.Tensor, multiple: int, axis: int = 0) -> Tuple[torch.Tensor, int]:
    """Pad ``axis`` with zeros to a multiple of ``multiple``; returns (padded,
    the original length)."""
    x = torch.as_tensor(x)
    n = x.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return x, n
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis), n
