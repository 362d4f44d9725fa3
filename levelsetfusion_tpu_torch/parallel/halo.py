"""Halo exchange and edge-exact sharded stencil primitives. Twin of
``levelsetfusion_tpu/parallel/halo.py``.

The volume is split along one or two spatial axes into contiguous voxel
blocks, one per rank of a ``parallel.mesh.Group`` (the 1D mesh) or
``Mesh2D``; the functions take the rank's block and the mesh axis it is
split along (a ``Group`` or one of a ``Mesh2D``'s ``MeshAxis``):

- ``halo_exchange``: extend a block with ``width`` slices from each
  neighbour along the mesh axis, on tensor axis ``axis``, by one batched
  ``isend``/``irecv`` per neighbour pair (``dist.batch_isend_irecv``);
  beyond the volume's two global edges the halo is made per ``fill``:
    * ``"replicate"`` — the block's edge slice (Neumann ghost cells, the
      Laplacian's convention),
    * ``"zero"``      — zeros (the Sobolev filter's padding),
    * ``"truncation"``— +1.0 (unobserved space outside the volume).
  A world of 1 only fills. With ``wait=False`` it returns a ``PendingHalo``
  whose ``wait()`` gives the extended block, so the caller can overlap the
  exchange with other work. An exchange along mesh axis 0 and then one
  along mesh axis 1 of the extended block fills the corner ghosts from the
  diagonal neighbour (``exchange_2d``, JAX's ``exch2``).
- ``d_edge_fixed``: np.gradient along ``axis`` on a haloed block, exact at
  the global edges: with replicated ghost slices the central difference at
  a global edge is half the one-sided one, so it is doubled there and
  copied into the ghosts beyond, so that the operator composes (Hessians,
  ∇(∇·u)).
- ``second_diff``: the 1-(-2)-1 stencil on a haloed block (replicated
  ghosts give the global Neumann Laplacian).
- ``convolve_zero_edges``: a same-size convolution along ``axis`` with
  zero padding at the global edges (the Sobolev filter).
- ``psum_axis`` / ``pmax_axis``: ``all_reduce`` (sum, max) over a
  ``Group``'s ranks, a ``MeshAxis``'s line of ranks, or a ``Mesh2D``'s
  whole world (both axes); nothing over one rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from levelsetfusion_tpu_torch.parallel.mesh import Group, Mesh2D, MeshAxis, line
from levelsetfusion_tpu_torch.utils.profiling import count, span

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

    def __init__(self, works, ops, lefts, x, rights, width, fill, axis):
        self._works, self._ops = works, ops
        self._lefts, self._x, self._rights = lefts, x, rights
        self._width, self._fill, self._axis = width, fill, axis

    def wait(self) -> torch.Tensor:
        with span("lsf.halo.wait"):
            return self._wait()

    def _wait(self) -> torch.Tensor:
        for work in self._works:
            work.wait()
        self._works, self._ops = [], []
        x, axis, width = self._x, self._axis, self._width
        left = self._lefts or [x]
        right = self._rights or [x]
        parts = [*self._lefts, x, *self._rights]
        # Beyond a global edge: the fill, its replicated slice the volume's
        # edge slice (the outermost part received holds it then).
        missing = width - sum(p.shape[axis] for p in self._lefts)
        if missing:
            parts.insert(0, _fill(left[0], missing, self._fill, axis, 0))
        missing = width - sum(p.shape[axis] for p in self._rights)
        if missing:
            parts.append(_fill(right[-1], missing, self._fill, axis,
                               right[-1].shape[axis] - 1))
        return torch.cat(parts, dim=axis)


def halo_exchange(x: torch.Tensor, width: int, group: Group | MeshAxis,
                  fill: str = "replicate", axis: int = 0, wait: bool = True):
    """``x`` extended with ``width`` halo slices on both sides of ``axis``,
    from the ranks along ``group`` (a ``Group`` or a ``MeshAxis``); a
    ``PendingHalo`` when ``wait`` is false. A halo wider than the block
    takes the slices it needs from as many ranks on each side as hold them
    (every rank's block has ``x``'s extent)."""
    if fill not in FILLS:
        raise ValueError(f"unknown fill {fill!r}")
    with span("lsf.halo.exchange"):
        pending = _post(x, width, group, fill, axis)
        return pending.wait() if wait else pending


def _post(x, width, group, fill, axis) -> PendingHalo:
    """``halo_exchange``'s sends and receives, posted."""
    n = x.shape[axis]
    ax = line(group)
    if width > n * ax.size:
        raise ValueError(f"halo of {width} slices exceeds the axis's {n * ax.size}")
    works, ops, lefts, rights, sent = [], [], [], [], 0
    hops = -(-width // n) if ax.size > 1 else 0
    for k in range(1, hops + 1):
        w = min(n, width - (k - 1) * n)  # what the rank k steps away holds of the halo
        lo, hi = ax.peer(-k), ax.peer(k)
        if lo is not None:
            lefts.insert(0, torch.empty_like(x.narrow(axis, n - w, w),
                                             memory_format=torch.contiguous_format))
            ops += [dist.P2POp(dist.isend, x.narrow(axis, 0, w).contiguous(), lo),
                    dist.P2POp(dist.irecv, lefts[0], lo)]
        if hi is not None:
            rights.append(torch.empty_like(x.narrow(axis, 0, w),
                                           memory_format=torch.contiguous_format))
            ops += [dist.P2POp(dist.isend, x.narrow(axis, n - w, w).contiguous(), hi),
                    dist.P2POp(dist.irecv, rights[-1], hi)]
        sent += ((lo is not None) + (hi is not None)) * w * (x.numel() // n) * x.element_size()
    if ops:
        count("halo.bytes_sent", sent)
        works = dist.batch_isend_irecv(ops)
    return PendingHalo(works, ops, lefts, x, rights, width, fill, axis)


def exchange_2d(x: torch.Tensor, width: int, mesh: Mesh2D, fill: str = "replicate",
                axis: int = 0) -> torch.Tensor:
    """``x`` extended along tensor axes ``axis`` and ``axis + 1`` (the mesh's
    two axes) by ``width`` slices: the exchange along mesh axis 0, then
    along mesh axis 1 of its result, so the corners come from the diagonal
    neighbours."""
    x = halo_exchange(x, width, mesh.axes[0], fill=fill, axis=axis)
    return halo_exchange(x, width, mesh.axes[1], fill=fill, axis=axis + 1)


def _first_last(group):
    ax = line(group)
    return ax.index == 0, ax.index == ax.size - 1


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


def _all_reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    if isinstance(group, MeshAxis):
        size, pg = group.size, group.group
    else:  # a Group, or a Mesh2D's both axes: the world
        size, pg = group.world, None
    if size == 1:
        return x
    with span("lsf.reduce"):
        x = x.clone()
        dist.all_reduce(x, op=op, group=pg)
        return x


def psum_axis(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group``'s ranks: a ``Group``'s, a ``MeshAxis``'s line,
    or both axes of a ``Mesh2D`` (``x`` itself over one rank)."""
    return _all_reduce(x, group, dist.ReduceOp.SUM)


def pmax_axis(x: torch.Tensor, group) -> torch.Tensor:
    """The max over ``group``'s ranks, as ``psum_axis``."""
    return _all_reduce(x, group, dist.ReduceOp.MAX)
