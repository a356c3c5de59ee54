"""The collectives of the mesh's serving and ``space`` paths: halo rows,
row gathers and batch gathers.

Under ``space`` > 1 a rank holds a stripe of every image's rows
(``parallel/mesh.py::stripe_bounds``).  A 3x3 conv at a stripe's inner edge
reads rows of the neighbouring stripe: :func:`halo_exchange` brings them
(zeros at the image's real top and bottom, where the conv pads with zeros),
and its backward sends their gradients back to the rank that owns those
rows.  :func:`gather_rows` assembles the full-height tensor on every rank of
the space group (the heads, before the loss or the postprocess); its
backward is the adjoint, the sum of the space ranks' gradients cut to this
rank's stripe.  :func:`gather_batch` assembles a data-parallel batch's
results (the detection rows of every image) on every rank.

Only ``all_reduce`` carries the rows, never ``send`` / ``recv`` or
``all_gather``: gloo reduces CUDA tensors but has no point-to-point ops or
gathers for them, and gloo is what runs several ranks on one card (NCCL
refuses two ranks a card).  So one code path runs on the gloo ranks that
share a card and on NCCL ranks with a card each.  Each rank writes its rows
into its own slot of a zero buffer and the buffer is summed over the space
group as bytes (``uint8``): every byte has one writer and zeros elsewhere,
so the sum moves the rows exactly, in any dtype.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.distributed as dist


def _sum_bytes(buf: torch.Tensor, group) -> torch.Tensor:
    """All-reduce a contiguous buffer of one writer per byte: a copy."""
    dist.all_reduce(buf.view(torch.uint8), group=group)
    return buf


def _swap(up: torch.Tensor, down: torch.Tensor, mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Send ``up`` to the rank above and ``down`` to the rank below (space
    index - 1 and + 1); returns (the rank above's ``down``, the rank below's
    ``up``), zeros where there is no such rank.  Every rank's ``up`` and
    ``down`` have the same shapes."""
    s, n = mesh.space_index, mesh.space_size
    nu = up.numel()
    buf = up.new_zeros((n, nu + down.numel()))
    buf[s, :nu] = up.reshape(-1)
    buf[s, nu:] = down.reshape(-1)
    _sum_bytes(buf, mesh.space_group)
    above = buf[s - 1, nu:].view(down.shape) if s > 0 else torch.zeros_like(down)
    below = buf[s + 1, :nu].view(up.shape) if s < n - 1 else torch.zeros_like(up)
    return above, below


def edge_rows(x: torch.Tensor, mesh, top: int, bottom: int,
              dim: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``top`` rows above this rank's stripe (the last rows of the rank
    above) and the ``bottom`` rows below it (the first rows of the rank
    below), along ``dim``; zeros at the image's real top and bottom.  Not
    differentiable: :func:`halo_exchange` is."""
    h = x.shape[dim]
    if h < max(top, bottom):
        raise ValueError(f"a stripe of {h} rows cannot give a halo of ({top}, {bottom})")
    return _swap(x.narrow(dim, 0, bottom), x.narrow(dim, h - top, top), mesh)


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, top, bottom, dim):
        ctx.mesh, ctx.top, ctx.bottom, ctx.dim, ctx.h = mesh, top, bottom, dim, x.shape[dim]
        above, below = edge_rows(x, mesh, top, bottom, dim)
        if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last):
            # halo rows in x's layout, so that the result keeps it
            above, below = (t.contiguous(memory_format=torch.channels_last)
                            for t in (above, below))
        return torch.cat([above, x, below], dim=dim)

    @staticmethod
    def backward(ctx, g):
        top, bottom, dim, h = ctx.top, ctx.bottom, ctx.dim, ctx.h
        # the halo rows' gradients go back to their owners: the top halo's
        # to the rank above (its last rows), the bottom halo's to the rank
        # below (its first rows)
        from_above, from_below = _swap(g.narrow(dim, 0, top),
                                       g.narrow(dim, top + h, bottom), ctx.mesh)
        gx = g.narrow(dim, top, h).clone()
        gx.narrow(dim, 0, bottom).add_(from_above)
        gx.narrow(dim, h - top, top).add_(from_below)
        return gx, None, None, None, None


def halo_exchange(x: torch.Tensor, mesh, top: int, bottom: int, dim: int = 2) -> torch.Tensor:
    """``x`` with ``top`` rows of the rank above before it and ``bottom``
    rows of the rank below after it, along ``dim`` (2: the H of the
    forward's NCHW activations); zeros at the image's real top and bottom.
    Differentiable: the halo rows' gradients are added to the rows they
    came from, on the rank that owns them."""
    return _HaloExchange.apply(x, mesh, top, bottom, dim)


def _stripe_sizes(rows: int, mesh, device) -> List[int]:
    """Every space rank's stripe height, from each rank's own (one small
    all-reduce and a read on the host)."""
    sizes = torch.zeros(mesh.space_size, dtype=torch.int64, device=device)
    sizes[mesh.space_index] = rows
    dist.all_reduce(sizes, group=mesh.space_group)
    return sizes.tolist()


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        sizes = _stripe_sizes(x.shape[dim], mesh, x.device)
        ctx.mesh, ctx.dim, ctx.sizes = mesh, dim, sizes
        # uneven stripes: every slot holds the longest, each rank's rows at
        # its start
        shape = list(x.shape)
        shape[dim] = max(sizes)
        buf = x.new_zeros([mesh.space_size] + shape)
        buf[mesh.space_index].narrow(dim, 0, x.shape[dim]).copy_(x)
        _sum_bytes(buf, mesh.space_group)
        return torch.cat([buf[i].narrow(dim, 0, n) for i, n in enumerate(sizes)], dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.mesh.space_group)
        s = ctx.mesh.space_index
        return g.narrow(ctx.dim, sum(ctx.sizes[:s]), ctx.sizes[s]), None, None


def gather_rows(x: torch.Tensor, mesh, dim: int = 1) -> torch.Tensor:
    """The full-height tensor on every rank of the space group, from each
    rank's stripe of rows along ``dim`` (1: the H of NHWC heads); ``x``
    itself at ``space`` 1.  Differentiable: the gradient of a stripe is
    the sum of every space rank's gradient of those rows."""
    if mesh.space_size == 1:
        return x
    return _GatherRows.apply(x, mesh, dim)


def gather_batch(x: torch.Tensor, mesh) -> torch.Tensor:
    """The whole batch on every rank, from each data rank's equal part of
    axis 0 (``x`` itself at ``data`` 1).  The ranks of one space group
    hold the same part, so the gather runs over the data group."""
    if mesh.data_size == 1:
        return x
    buf = x.new_zeros((mesh.data_size,) + tuple(x.shape))
    buf[mesh.data_index] = x
    _sum_bytes(buf, mesh.data_group)
    return buf.reshape((-1,) + tuple(x.shape[1:]))
