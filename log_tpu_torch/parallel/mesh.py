"""Process groups, the rank mesh and the row layout of multi-device
training; counterpart of log_tpu/parallel/mesh.py.

The layout is the JAX package's: Gaussian state, Adam moments and counters
split over ranks on axis 0 of every capacity-padded tensor (each rank holds
one contiguous block of rows), cameras split over ranks, tree arrays and
the per-view gain replicated. JAX names devices of one process; here every
rank is a process with one device, and the collectives of parallel/comm.py
run over its group.

`initialize_distributed` starts the group from the JAX package's variables
(LOG_TPU_COORDINATOR, LOG_TPU_NUM_PROCESSES, LOG_TPU_PROCESS_ID) or
torchrun's (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): NCCL
for a CUDA device, gloo for the CPU.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from .comm import group_initialized, rank_zero_first

# a collective that waits longer raises (every rank's, not only the slow one)
TIMEOUT_S = 600.0


@dataclass
class Mesh:
    """Ranks on a (data, point) grid. `groups` holds, under an initialized
    process group, this rank's group along each axis ("data": its column,
    "point": its row); it is empty otherwise."""

    grid: np.ndarray
    groups: dict = field(default_factory=dict)


def mesh_shape(n: int, data: int | None = None,
               point: int | None = None) -> tuple[int, int]:
    """The JAX factorization of n ranks into (data, point): point-sharding
    first (device memory), data 2 from 4 ranks up."""
    if data is None or point is None:
        if n >= 4:
            data, point = 2, n // 2
        else:
            data, point = 1, n
    if data * point != n:
        raise ValueError(f"mesh ({data}, {point}) does not hold {n} ranks")
    return data, point


def make_mesh(n_devices: int | None = None, data: int | None = None,
              point: int | None = None) -> Mesh:
    """Ranks 0..n-1 (n defaults to the world size) on the (data, point)
    grid. Under an initialized group every rank must call it: it creates
    the axes' groups with dist.new_group, which is collective."""
    world = dist.get_world_size() if group_initialized() else 1
    n = int(n_devices or world)
    if n > world and group_initialized():
        raise ValueError(f"mesh of {n} ranks in a world of {world}")
    d, p = mesh_shape(n, data, point)
    grid = np.arange(n).reshape(d, p)
    groups = {}
    if group_initialized():
        rank = dist.get_rank()
        for axis, lines in (("point", list(grid)), ("data", list(grid.T))):
            for line in lines:
                g = dist.new_group([int(r) for r in line])
                if rank in line:
                    groups[axis] = g
    return Mesh(grid, groups)


def shard_rows(x: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    """Rank `rank`'s block of axis 0 (the JAX point sharding)."""
    rows = x.shape[0]
    if rows % world:
        raise ValueError(f"{rows} rows do not split over {world} ranks")
    n = rows // world
    return x[rank * n:(rank + 1) * n]


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           device="cuda"):
    """Start this process's group once, before any model is built.

    The arguments, else LOG_TPU_COORDINATOR ("host:port"),
    LOG_TPU_NUM_PROCESSES and LOG_TPU_PROCESS_ID, else torchrun's
    MASTER_ADDR:MASTER_PORT, WORLD_SIZE and RANK. A no-op returning None
    when none of them is set. On a CUDA device the group is NCCL and the
    process takes device LOCAL_RANK (else its rank) first; on the CPU it
    is gloo. Returns the rank's device. On a CUDA device rank 0 builds the
    kernel library (ops/kernels.build) while the other ranks wait, so that
    n ranks started together compile it once.
    """
    env = os.environ
    if coordinator is None:
        if "LOG_TPU_COORDINATOR" in env:
            coordinator = env["LOG_TPU_COORDINATOR"]
            num_processes = int(env.get("LOG_TPU_NUM_PROCESSES", "1"))
            process_id = int(env.get("LOG_TPU_PROCESS_ID", "0"))
        elif "RANK" in env and "WORLD_SIZE" in env:
            coordinator = (f"{env.get('MASTER_ADDR', 'localhost')}:"
                           f"{env['MASTER_PORT']}")
            num_processes = int(env["WORLD_SIZE"])
            process_id = int(env["RANK"])
        else:
            return None
    if num_processes is None or process_id is None:
        raise ValueError("initialize_distributed needs num_processes and "
                         "process_id with a coordinator")
    device = torch.device(device)
    if device.type == "cuda":
        local_rank = int(env.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local_rank)
        device = torch.device("cuda", local_rank)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process group backend for {device}")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=timedelta(seconds=TIMEOUT_S))
    if device.type == "cuda":
        # the kernel library: built by rank 0, loaded by the others
        from ..ops import kernels

        with rank_zero_first():
            kernels.build()
    return device
