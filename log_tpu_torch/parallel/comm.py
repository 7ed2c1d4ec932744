"""Collectives with the JAX package's tiled shard_map semantics, on
torch.distributed.

JAX drives every device from one process and names the mesh axis inside
shard_map; torch runs one process per rank, so the axis here is a process
group and each collective a plain function on this rank's tensors:

  all_gather(x, tiled=True)    jax.lax.all_gather(x, AXIS, tiled=...)
  all_to_all(x, split, concat) jax.lax.all_to_all(..., tiled=True)
  psum(x) / pmax(x)            jax.lax.psum / pmax (all_reduce)
  psum_scatter(x)              jax.lax.psum_scatter(..., tiled=True), with
                               the all_gather of the cotangent as its VJP
                               (the transpose JAX's autodiff inserts)

The list forms of all_gather and reduce_scatter are used: they exist under
the same names in every torch release the port runs on, where the tensor
forms are deprecated in newer ones. bool tensors travel as uint8 (NCCL has
no bool). Without an initialized process group the axis has one rank and
every collective is the identity.

`rank_zero_first` orders work that writes shared files (the dataset cache):
rank 0 runs it while the other ranks wait at a barrier, then they run it.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict

import torch
import torch.distributed as dist


def group_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


@contextlib.contextmanager
def rank_zero_first():
    """Run the block on rank 0 first: the other ranks wait at a barrier of
    the default group until rank 0 has left the block (or raised in it),
    then run it. Yields True on the rank that runs first (rank 0, or the
    only process outside a group or in a group of one), False on the
    others. Every rank of the group must enter it."""
    if not group_initialized() or dist.get_world_size() == 1:
        yield True
        return
    lead = dist.get_rank() == 0
    if not lead:
        dist.barrier()
    try:
        yield lead
    finally:
        if lead:
            dist.barrier()


class Comm:
    """One axis of ranks: the process group's ranks in rank order, or the
    single rank of a process without a group. `bytes` counts, by
    collective, the bytes of the tensors this rank hands in (for
    psum_scatter's backward: the cotangent it gathers)."""

    def __init__(self):
        if group_initialized():
            self.rank, self.world = dist.get_rank(), dist.get_world_size()
        else:
            self.rank, self.world = 0, 1
        self.bytes = defaultdict(int)

    @property
    def distributed(self) -> bool:
        """True where the collectives go through torch.distributed (a group
        of any size, one rank included)."""
        return group_initialized()

    def _count(self, name: str, x: torch.Tensor) -> None:
        self.bytes[name] += x.numel() * x.element_size()

    # ------------------------------------------------------------ gathers
    def all_gather(self, x: torch.Tensor, tiled: bool = True):
        """Every rank's x in rank order: concatenated on axis 0 (tiled) or
        stacked on a new axis 0."""
        self._count("all_gather", x)
        if not self.distributed:
            return x.clone() if tiled else x[None].clone()
        wire = _to_wire(x.contiguous())
        parts = [torch.empty_like(wire) for _ in range(self.world)]
        dist.all_gather(parts, wire)
        out = torch.cat(parts) if tiled else torch.stack(parts)
        return _from_wire(out, x.dtype)

    def all_to_all(self, x: torch.Tensor, split_axis: int, concat_axis: int):
        """x split into `world` blocks on split_axis, block j sent to rank j;
        the blocks received are concatenated on concat_axis in rank order.
        (B, cap_l) with split 0, concat 1 gives (B / world, cap)."""
        self._count("all_to_all", x)
        if not self.distributed:
            return x.clone()
        n = self.world
        if x.shape[split_axis] % n:
            raise ValueError(f"all_to_all: axis {split_axis} of "
                             f"{tuple(x.shape)} does not split {n} ways")
        # all_to_all_single splits and concatenates on dim 0: bring the
        # split axis to the front, exchange, and put each received block
        # back in its place before the concatenation
        moved = torch.movedim(x, split_axis, 0)
        inp = _to_wire(moved.reshape((n, moved.shape[0] // n)
                                     + moved.shape[1:]).contiguous())
        out = torch.empty_like(inp)
        dist.all_to_all_single(out, inp)
        blocks = [torch.movedim(b, 0, split_axis) for b in out.unbind(0)]
        return _from_wire(torch.cat(blocks, dim=concat_axis), x.dtype)

    # ---------------------------------------------------------- reductions
    def psum(self, x: torch.Tensor):
        return self._all_reduce("psum", x, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor):
        return self._all_reduce("pmax", x, dist.ReduceOp.MAX)

    def _all_reduce(self, name, x, op):
        self._count(name, x)
        out = x.detach().clone()
        if self.distributed:
            dist.all_reduce(out, op=op)
        return out

    def psum_scatter(self, x: torch.Tensor):
        """Sum over the ranks, scattered on axis 0 (tiled): rank r keeps
        block r of the sum. Differentiable: its VJP all_gathers the
        cotangent, so every rank must run the backward too."""
        return _PsumScatter.apply(x, self)

    def broadcast(self, x: torch.Tensor, src: int = 0):
        """x of rank `src` on every rank (a copy)."""
        self._count("broadcast", x)
        out = _to_wire(x.detach().clone().contiguous())
        if self.distributed:
            dist.broadcast(out, src=src)
        return _from_wire(out, x.dtype)


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        comm._count("psum_scatter", x)
        if not comm.distributed:
            return x.clone()
        n = comm.world
        if x.shape[0] % n:
            raise ValueError(f"psum_scatter: {x.shape[0]} rows do not split "
                             f"{n} ways")
        blocks = list(x.contiguous().chunk(n, 0))
        out = torch.empty_like(blocks[0])
        dist.reduce_scatter(out, blocks)
        return out

    @staticmethod
    def backward(ctx, g):
        comm = ctx.comm
        comm._count("psum_scatter_grad", g)
        if not comm.distributed:
            return g.clone(), None
        g = g.contiguous()
        parts = [torch.empty_like(g) for _ in range(comm.world)]
        dist.all_gather(parts, g)
        return torch.cat(parts), None


def _to_wire(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.uint8) if x.dtype == torch.bool else x


def _from_wire(x: torch.Tensor, dtype) -> torch.Tensor:
    return x.to(torch.bool) if dtype == torch.bool else x
