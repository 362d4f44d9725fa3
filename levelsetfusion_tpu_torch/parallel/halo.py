"""Halo exchange and edge-exact sharded stencil primitives. Twin of
``levelsetfusion_tpu/parallel/halo.py``.

The volume is split along one spatial axis into contiguous voxel blocks, one
per rank of a ``parallel.mesh.Group``; the functions take the rank's block:

- ``halo_exchange``: extend a block with ``width`` slices from each
  neighbour along ``axis``, by one batched ``isend``/``irecv`` per
  neighbour pair (``dist.batch_isend_irecv``); beyond the volume's two
  global edges the halo is made per ``fill``:
    * ``"replicate"`` — the block's edge slice (Neumann ghost cells, the
      Laplacian's convention),
    * ``"zero"``      — zeros (the Sobolev filter's padding),
    * ``"truncation"``— +1.0 (unobserved space outside the volume).
  A world of 1 only fills. With ``wait=False`` it returns a ``PendingHalo``
  whose ``wait()`` gives the extended block, so the caller can overlap the
  exchange with other work.
- ``d_edge_fixed``: np.gradient along ``axis`` on a haloed block, exact at
  the global edges: with replicated ghost slices the central difference at
  a global edge is half the one-sided one, so it is doubled there and
  copied into the ghosts beyond, so that the operator composes (Hessians,
  ∇(∇·u)).
- ``second_diff``: the 1-(-2)-1 stencil on a haloed block (replicated
  ghosts give the global Neumann Laplacian).
- ``convolve_zero_edges``: a same-size convolution along ``axis`` with
  zero padding at the global edges (the Sobolev filter).
- ``psum_axis`` / ``pmax_axis``: ``all_reduce`` (sum, max), nothing at a
  world of 1.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from levelsetfusion_tpu_torch.parallel.mesh import Group

FILLS = ("replicate", "zero", "truncation")


def _fill(x: torch.Tensor, width: int, fill: str, axis: int, edge: int) -> torch.Tensor:
    """The ``width`` ghost slices beyond edge slice ``edge`` of ``x``."""
    shape = list(x.shape)
    shape[axis] = width
    if fill == "replicate":
        return x.narrow(axis, edge, 1).expand(shape)
    return x.new_full(shape, 0.0 if fill == "zero" else 1.0)  # "truncation": +1


class PendingHalo:
    """An exchange in flight: ``wait()`` waits for its sends and receives
    and returns the block with its halo. It holds the send buffers until
    then."""

    def __init__(self, works, ops, left, x, right, axis):
        self._works, self._ops = works, ops
        self._parts, self._axis = (left, x, right), axis

    def wait(self) -> torch.Tensor:
        for work in self._works:
            work.wait()
        self._works, self._ops = [], []
        return torch.cat(self._parts, dim=self._axis)


def halo_exchange(x: torch.Tensor, width: int, group: Group, fill: str = "replicate",
                  axis: int = 0, wait: bool = True):
    """``x`` extended with ``width`` halo slices on both sides of ``axis``;
    a ``PendingHalo`` when ``wait`` is false."""
    if fill not in FILLS:
        raise ValueError(f"unknown fill {fill!r}")
    n = x.shape[axis]
    if width > n:
        raise ValueError(f"halo of {width} slices exceeds the block's {n}")
    works, ops, left, right = [], [], None, None
    if width and group.world > 1:
        if group.rank > 0:
            left = torch.empty_like(x.narrow(axis, 0, width),
                                    memory_format=torch.contiguous_format)
            ops += [dist.P2POp(dist.isend, x.narrow(axis, 0, width).contiguous(), group.rank - 1),
                    dist.P2POp(dist.irecv, left, group.rank - 1)]
        if group.rank < group.world - 1:
            right = torch.empty_like(x.narrow(axis, n - width, width),
                                     memory_format=torch.contiguous_format)
            ops += [dist.P2POp(dist.isend, x.narrow(axis, n - width, width).contiguous(),
                               group.rank + 1),
                    dist.P2POp(dist.irecv, right, group.rank + 1)]
        works = dist.batch_isend_irecv(ops)
    if left is None:
        left = _fill(x, width, fill, axis, 0)
    if right is None:
        right = _fill(x, width, fill, axis, n - 1)
    pending = PendingHalo(works, ops, left, x, right, axis)
    return pending.wait() if wait else pending


def _first_last(group: Group):
    return group.rank == 0, group.rank == group.world - 1


def d_edge_fixed(x_ext: torch.Tensor, halo: int, group: Group, axis: int = 0) -> torch.Tensor:
    """np.gradient along ``axis`` of a block with ``halo`` ghost slices a
    side (replicated at the global edges), exact at the global edges.
    Returns ``halo - 1`` ghost slices a side; beyond a global edge they hold
    the edge value, so the result can be fed back in."""
    first, last = _first_last(group)
    n = x_ext.shape[axis]
    g = (x_ext.narrow(axis, 2, n - 2) - x_ext.narrow(axis, 0, n - 2)) * 0.5
    m = g.shape[axis]
    h = halo - 1  # ghosts left in g; global slice 0 sits at index h
    parts = list(torch.split(g, 1, dim=axis))
    if first:
        start = parts[h] * 2.0
        parts[:h + 1] = [start] * (h + 1)
    if last:
        end = parts[m - 1 - h] * 2.0
        parts[m - 1 - h:] = [end] * (h + 1)
    return torch.cat(parts, dim=axis) if (first or last) else g


def second_diff(x_ext: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """1-(-2)-1 stencil along ``axis``; consumes one ghost slice a side."""
    n = x_ext.shape[axis]
    return (x_ext.narrow(axis, 2, n - 2) - 2.0 * x_ext.narrow(axis, 1, n - 2)
            + x_ext.narrow(axis, 0, n - 2))


def convolve_zero_edges(x: torch.Tensor, kernel: torch.Tensor, group: Group,
                        axis: int = 0) -> torch.Tensor:
    """Same-size convolution along ``axis`` with zero padding at the global
    edges: a radius-wide zero-filled exchange, then the taps."""
    k = kernel.shape[0]
    x_ext = halo_exchange(x, k // 2, group, fill="zero", axis=axis)
    n = x.shape[axis]
    out = torch.zeros_like(x)
    for t in range(k):
        out = out + kernel[k - 1 - t] * x_ext.narrow(axis, t, n)
    return out


def psum_axis(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum over the ranks (``x`` itself at a world of 1)."""
    if group.world == 1:
        return x
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM)
    return x


def pmax_axis(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The max over the ranks (``x`` itself at a world of 1)."""
    if group.world == 1:
        return x
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX)
    return x
