"""The ("data", "model") grid of ranks (counterpart of ``qasr/parallel/mesh.py``).

The JAX package hands GSPMD a mesh of devices and lets XLA insert the
collectives. In PyTorch a device is a process: the mesh here is a grid of
ranks of one ``torch.distributed`` world, with one process group per column
(the ranks that share a model index: the "data" axis, over which gradients
sum) and one per row (the ranks that share a data index: the "model" axis,
over which the quaternion kernels' output channels are split). The
collectives are written out where they happen (``qasr_torch.parallel.train``,
``seq_parallel``, ``collectives``).

A process outside any world (no ``init_process_group``) is the 1 x 1 mesh
of rank 0, and every collective is the identity there.

Non-goals, as the reference's: pipeline, expert and attention parallelism
(no model here has experts or attention, and every one fits a card with DP
and TP alone).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, MODEL_AXIS)


def world() -> tuple[int, int]:
    """(rank, world size) of this process; (0, 1) outside a world."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclass(eq=False)
class Mesh:
    """A grid ``ranks [n_data, n_model]`` of global ranks and, for this
    process, its coordinates and its two groups.

    ``groups[axis]`` is this rank's process group along ``axis`` (None where
    the axis has one rank: no collective runs there); ``coords`` is None for
    a rank outside the grid.
    """

    ranks: np.ndarray
    rank: int
    groups: dict = field(default_factory=dict)

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: int(self.ranks.shape[0]), MODEL_AXIS: int(self.ranks.shape[1])}

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    @property
    def axis_names(self) -> tuple[str, str]:
        return AXES

    @property
    def coords(self) -> tuple[int, int] | None:
        hit = np.argwhere(self.ranks == self.rank)
        return None if hit.size == 0 else (int(hit[0, 0]), int(hit[0, 1]))

    def index(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        coords = self.coords
        if coords is None:
            raise ValueError(f"rank {self.rank} is outside the mesh {self.ranks.tolist()}")
        return coords[AXES.index(axis)]

    def group(self, axis: str):
        return self.groups.get(axis)

    def group_ranks(self, axis: str) -> list[int]:
        """The global ranks of this rank's group along ``axis``, in axis order."""
        i, j = self.coords
        line = self.ranks[:, j] if axis == DATA_AXIS else self.ranks[i, :]
        return [int(r) for r in line]


def make_mesh(n_data: int = -1, n_model: int = 1, *, ranks=None) -> Mesh:
    """Build a ("data", "model") mesh over ``ranks`` (default every rank of
    the world, in order): ``n_data == -1`` means "all remaining ranks".
    Consecutive ranks share a row, so the model axis (the weight gathers'
    heavier traffic) lands on adjacent ranks, as the reference orders its
    devices. Every rank of the world must call this, in the same order as
    its other group creations: each creates every group, its own or not.
    """
    rank, size = world()
    ranks = list(ranks) if ranks is not None else list(range(size))
    n = len(ranks)
    if n_data == -1:
        if n % n_model:
            raise ValueError(f"{n} devices not divisible by n_model={n_model}")
        n_data = n // n_model
    if n_data * n_model != n:
        raise ValueError(f"mesh {n_data}x{n_model} != {n} devices")
    grid = np.asarray(ranks, np.int64).reshape(n_data, n_model)
    groups = {}
    if size > 1:
        for axis, lines in ((DATA_AXIS, grid.T), (MODEL_AXIS, grid)):
            if lines.shape[1] == 1:
                continue
            for line in lines:
                members = [int(r) for r in line]
                g = dist.new_group(members)
                if rank in members:
                    groups[axis] = g
    return Mesh(ranks=grid, rank=rank, groups=groups)


def initialize_multihost(
    coordinator: str | None = None,
    *,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    device: torch.device | str = "cuda",
) -> tuple[int, int]:
    """Join the world of processes; returns (rank, world size).

    Reads ``torch.distributed.run``'s environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``/``MASTER_PORT``) unless ``coordinator`` (an init method:
    ``tcp://host:port`` or ``file:///path``; a bare ``host:port`` means tcp)
    with ``num_processes`` and ``process_id`` is given; without either it
    does nothing (one process). ``backend`` defaults to NCCL when ``device``
    is a CUDA device (each rank owns a card) and gloo for the CPU; a caller
    may ask for gloo on CUDA tensors (ranks that share one card, which NCCL
    refuses). There is no fallback: a backend that cannot start raises.
    """
    if dist.is_initialized():
        return world()
    env = os.environ
    if coordinator is None and not ("RANK" in env and "WORLD_SIZE" in env):
        return 0, 1
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if coordinator is None:
        init, size, rank = "env://", int(env["WORLD_SIZE"]), int(env["RANK"])
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and process_id")
        init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        size, rank = num_processes, process_id
    dist.init_process_group(backend, init_method=init, world_size=size, rank=rank)
    return world()


def batch_sharding(mesh: Mesh) -> tuple:
    """The spec of a batch leaf: its leading dim split over "data"."""
    return (DATA_AXIS,)


def replicated(mesh: Mesh) -> tuple:
    """The spec of a leaf every rank holds whole."""
    return ()
