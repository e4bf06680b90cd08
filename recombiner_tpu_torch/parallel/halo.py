"""The halo exchange of a conv canvas split into slabs over ranks: what
GSPMD inserts around the JAX package's conv stack when a datapoint's patch
rows are sharded (``recombiner_tpu/models/mappings.py:36-95`` under
``shard_rows``).

A rank holds one slab of a datapoint's latent canvas, whole along every
axis but one. Before the conv stack it receives ``halo`` rows from each
neighbouring slab of the same datapoint (none at the canvas's true edges,
which keep the conv's zero padding); after it the caller crops the halo's
pixels. The backward sends each halo row's gradient to the rank that owns
the row, which adds it to its own gradient in a fixed order (the
gradient from the previous slab first, then from the next), so a run
repeats bit for bit.

Both directions are one ``all_gather`` of each rank's two boundary blocks
over the mesh (``mesh.all_gather``, looked up at each call, which stages
CUDA tensors through host memory on gloo). Every rank of the mesh calls
it, in the same order, the first and last slab of a datapoint included: a
halo that fails raises, it is never skipped.
"""

from __future__ import annotations

import torch

from recombiner_tpu_torch.parallel import mesh as mesh_mod
from recombiner_tpu_torch.parallel.mesh import Mesh, Slab


def _edges(x: torch.Tensor, dim: int, halo: int) -> torch.Tensor:
    """(first ``halo`` rows, last ``halo`` rows) of ``x`` along ``dim``,
    stacked."""
    n = x.shape[dim]
    return torch.stack([x.narrow(dim, 0, halo), x.narrow(dim, n - halo, halo)])


class HaloExchange(torch.autograd.Function):
    """``x`` (this rank's slab) -> [previous slab's last ``halo`` rows, x,
    next slab's first ``halo`` rows] along ``dim``, each neighbour only
    where ``slab`` has one."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: Mesh, slab: Slab, dim: int) -> torch.Tensor:
        h = slab.halo
        if x.shape[dim] < h:
            raise ValueError(f"a slab of {x.shape[dim]} rows is thinner than the halo of {h}")
        ctx.mesh, ctx.slab, ctx.dim, ctx.n = mesh, slab, dim, x.shape[dim]
        parts = mesh_mod.all_gather(_edges(x, dim, h), mesh)
        pieces = [x]
        if slab.has_prev:
            pieces.insert(0, parts[mesh.rank - 1][1])
        if slab.has_next:
            pieces.append(parts[mesh.rank + 1][0])
        return torch.cat(pieces, dim)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        mesh, slab, dim, n = ctx.mesh, ctx.slab, ctx.dim, ctx.n
        h = slab.halo
        lo = h if slab.has_prev else 0
        zero = g.new_zeros(g.narrow(dim, 0, h).shape)
        sent = torch.stack([g.narrow(dim, 0, h) if slab.has_prev else zero,
                            g.narrow(dim, lo + n, h) if slab.has_next else zero])
        parts = mesh_mod.all_gather(sent, mesh)
        out = g.narrow(dim, lo, n).clone()
        if slab.has_prev:  # the previous slab's appended halo is my first rows
            out.narrow(dim, 0, h).add_(parts[mesh.rank - 1][1])
        if slab.has_next:  # the next slab's prepended halo is my last rows
            out.narrow(dim, n - h, h).add_(parts[mesh.rank + 1][0])
        return out, None, None, None


def exchange(x: torch.Tensor, mesh: Mesh, slab: Slab, dim: int) -> torch.Tensor:
    """``HaloExchange`` of ``x`` along ``dim``."""
    return HaloExchange.apply(x, mesh, slab, dim)


def crop(y: torch.Tensor, slab: Slab, dim: int, rows_per_latent: int) -> torch.Tensor:
    """The slab's own rows of ``y`` (the conv stack's output on the slab
    and its halo): ``halo * rows_per_latent`` rows less at each side that
    received a halo."""
    cut = slab.halo * rows_per_latent
    lo = cut if slab.has_prev else 0
    hi = cut if slab.has_next else 0
    return y.narrow(dim, lo, y.shape[dim] - lo - hi)
