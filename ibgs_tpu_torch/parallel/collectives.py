"""Collectives over the named dims of a DeviceMesh, as autograd Functions
with the transposes that JAX derives for its collectives.

    all_gather(x, mesh, axes, dim)   tiled gather along `dim`; backward:
                                     psum_scatter of the cotangent
    all_to_all(x, mesh, axis)        equal splits along dim 0; backward:
                                     all_to_all of the cotangent
    psum(x, mesh, axes)              sum over the ranks; backward: psum
    psum_scatter(x, mesh, axes, dim) sum, then each rank keeps its tile
                                     along `dim`; backward: all_gather

`axes` is one dim name or a tuple of them; a tuple of every dim of the
mesh means the whole process group, in rank order (global_mesh lays rank
r out at its row-major coordinate).  All four rest on two primitives,
`all_gather_into_tensor` and `all_to_all_single`: a sum is taken on each
rank over the gathered (or exchanged) copies in rank order, so it is the
same on every rank and on every backend, and has no float atomics.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.distributed as dist

Axes = Union[str, Sequence[str]]

# the newer name of the tiled gather, where the installed torch has it
_gather_into = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def group(mesh, axes: Axes):
    """The process group of `axes` of `mesh` (this rank's slice)."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    if len(names) == 1:
        return mesh.get_group(names[0])
    if names != tuple(mesh.mesh_dim_names):
        raise ValueError(f"collectives: dims {names} of a mesh "
                         f"{mesh.mesh_dim_names}: one dim, or all in order")
    return dist.group.WORLD


def axis_size(mesh, axes: Axes) -> int:
    return dist.get_world_size(group(mesh, axes))


def axis_index(mesh, axes: Axes) -> int:
    """This rank's index along `axes` (row-major over a tuple)."""
    return dist.get_rank(group(mesh, axes))


def _gathered(x: torch.Tensor, g) -> torch.Tensor:
    """(n, *x.shape): every rank's x in rank order."""
    n = dist.get_world_size(g)
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:])) \
        if x.dim() else x.new_empty(n)
    _gather_into(out, x.reshape(-1) if not x.dim() else x, group=g)
    return out.reshape((n,) + tuple(x.shape))


def _exchanged(x: torch.Tensor, g) -> torch.Tensor:
    """all_to_all_single with equal splits of dim 0."""
    n = dist.get_world_size(g)
    if x.shape[0] % n:
        raise ValueError(f"all_to_all: {x.shape[0]} rows over {n} ranks")
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=g)
    return out


def _fold(stack: torch.Tensor) -> torch.Tensor:
    """Sum over dim 0 in index order."""
    acc = stack[0].clone()
    for i in range(1, stack.shape[0]):
        acc = acc + stack[i]
    return acc


def _gather_tiled(x, g, dim):
    st = _gathered(x.movedim(dim, 0), g)             # (n, d, ...)
    return st.reshape((st.shape[0] * st.shape[1],) + tuple(st.shape[2:])
                      ).movedim(0, dim)


def _psum_scatter_tiled(x, g, dim):
    n = dist.get_world_size(g)
    xm = x.movedim(dim, 0)
    if xm.shape[0] % n:
        raise ValueError(f"psum_scatter: {xm.shape[0]} rows over {n} ranks")
    recv = _exchanged(xm, g)                          # rank r's tile of each
    return _fold(recv.reshape((n, xm.shape[0] // n) + tuple(xm.shape[1:]))
                 ).movedim(0, dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return _gather_tiled(x, g, dim)

    @staticmethod
    def backward(ctx, dy):
        return _psum_scatter_tiled(dy, ctx.g, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _exchanged(x, g)

    @staticmethod
    def backward(ctx, dy):
        return _exchanged(dy, ctx.g), None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _fold(_gathered(x, g))

    @staticmethod
    def backward(ctx, dy):
        return _fold(_gathered(dy, ctx.g)), None


class _PSumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return _psum_scatter_tiled(x, g, dim)

    @staticmethod
    def backward(ctx, dy):
        return _gather_tiled(dy, ctx.g, ctx.dim), None, None


def all_gather(x: torch.Tensor, mesh, axes: Axes, dim: int = 0
               ) -> torch.Tensor:
    """Every rank's x of `axes`, concatenated along `dim` in rank order."""
    return _AllGather.apply(x, group(mesh, axes), dim)


def all_to_all(x: torch.Tensor, mesh, axis: Axes) -> torch.Tensor:
    """Rank r sends rows [k·m, (k+1)·m) of x (m = rows / n) to rank k and
    receives rank k's rows [r·m, (r+1)·m) into the same place."""
    return _AllToAll.apply(x, group(mesh, axis))


def psum(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """Sum of x over the ranks of `axes`, on every one of them."""
    return _PSum.apply(x, group(mesh, axes))


def psum_scatter(x: torch.Tensor, mesh, axes: Axes, dim: int = 0
                 ) -> torch.Tensor:
    """Sum of x over the ranks of `axes`; rank r keeps the r-th of n equal
    tiles along `dim`."""
    return _PSumScatter.apply(x, group(mesh, axes), dim)
