"""Latent-PE -> INR-input mapping and hierarchical latent sampling, a copy of
``recombiner_tpu/models/mappings.py`` for 1-, 2- and 3-D configs.

Row convention (patch configs): posterior row r = datapoint d *
prod(patch_nums) + p, p the row-major index over the patch grid, as the
loader orders them (``data/pipeline.py``).

The stitch, the re-split and ``expand_level`` are ``permute``, ``reshape``
and ``expand`` (a broadcast) only: their gradients are permutes and ordered
sums, with no ``index_add``/``scatter_add`` (atomics on CUDA), so an encode
repeats bit for bit on the card.

When one datapoint's patch rows are split over ranks (``parallel/mesh.py``,
``Partition.slab``), each rank stitches its slab of the canvas, takes a
halo of latent rows from its neighbours (``parallel/halo.py``), runs the
conv stack on slab and halo, crops the halo's pixels and splits its own
patch rows; an upper level kept whole on every rank is broadcast over
every patch and this rank's rows are sliced out.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from recombiner_tpu_torch.config import ModalityConfig
from recombiner_tpu_torch.models.upsample import apply_upsample_phased
from recombiner_tpu_torch.parallel import halo
from recombiner_tpu_torch.parallel.mesh import Partition, is_sharded, local_rows

# The conv stack lpe_to_pe runs: the phase-decomposed one, as in the JAX
# package. On the card (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py, phase
# "conv stacks", PERF.md section 5) an S = 5 CIFAR epoch at R = 500 takes
# 18.2-18.4 ms with it and 23.2-23.4 ms with the plain stack, a decode
# 2.2-2.8 against 2.9-4.2 ms. The plain stack stays beside it, held to it by
# the tests and the smoke.
STACK = apply_upsample_phased


def local_patch_nums(cfg: ModalityConfig, part: Optional[Partition] = None) -> Tuple[int, ...]:
    """The patch grid of the rows one datapoint has on this rank: the
    config's, or with a slab (``part.slab``) its patches along the split
    axis."""
    pn = list(cfg.patch_nums)
    slab = part.slab if is_sharded(part) else None
    if slab is not None:
        pn[slab.axis] = slab.per_rank
    return tuple(pn)


def lpe_to_pe(upsample_params, lpe: torch.Tensor, cfg: ModalityConfig,
              part: Optional[Partition] = None) -> torch.Tensor:
    """(R, S, *lpe_spatial, latent_dim) -> (R, S, n_pixels, upsample_out).

    For a patch config the patch LPEs of one datapoint are stitched into
    one canvas, upsampled together (so the convs see across patch borders)
    and split again into patches (``mappings.py:36-95``). ``part`` is the
    rows' layout: with a slab the canvas is this rank's slab, extended by
    the halo its neighbours send (every rank of the mesh must call)."""
    d = cfg.data_dim
    R, S = lpe.shape[0], lpe.shape[1]
    ls = cfg.lpe_spatial
    args = (cfg.data_dim, cfg.layerwise_scale_factors, cfg.paddings)
    if not cfg.patch:
        pe = STACK(upsample_params, lpe.reshape(R * S, *ls, cfg.latent_dim), *args)
        return pe.reshape(R, S, cfg.n_pixels, cfg.upsample_out)

    pn = local_patch_nums(cfg, part)
    slab = part.slab if is_sharded(part) else None
    n_data = R // int(np.prod(pn))
    # (n_data, *pn, S, *ls, latent) -> (n_data, S, pn0, ls0, pn1, ls1, ..., latent)
    x = lpe.reshape(n_data, *pn, S, *ls, cfg.latent_dim)
    perm = [0, 1 + d]
    for i in range(d):
        perm += [1 + i, 2 + d + i]
    x = x.permute(*perm, 2 + 2 * d)
    x = x.reshape(n_data * S, *[pn[i] * ls[i] for i in range(d)], cfg.latent_dim)

    if slab is None:
        pe = STACK(upsample_params, x, *args)  # (n_data * S, *(pn * ps), out)
    else:
        dim = 1 + slab.axis
        pe = STACK(upsample_params, halo.exchange(x, part.mesh, slab, dim), *args)
        pe = halo.crop(pe, slab, dim, cfg.pixel_sizes[slab.axis] // ls[slab.axis])

    ps = cfg.pixel_sizes
    interleaved = []
    for i in range(d):
        interleaved += [pn[i], ps[i]]
    pe = pe.reshape(n_data, S, *interleaved, cfg.upsample_out)
    # (n_data, S, pn0, ps0, pn1, ps1, ..., out) -> (n_data, pn..., S, ps..., out)
    perm = ([0] + [2 + 2 * i for i in range(d)] + [1] + [3 + 2 * i for i in range(d)]
            + [2 + 2 * d])
    return pe.permute(*perm).reshape(R, S, cfg.n_pixels, cfg.upsample_out)


def expand_level(x: torch.Tensor, patch_nums: Sequence[int],
                 level_patch_nums: Sequence[int]) -> torch.Tensor:
    """Per-group latents (n_groups_total, ...) -> per-patch rows
    (n_rows_total, ...): each group's value repeated over the patches of its
    block (``mappings.py:97-127``). Groups are ordered datapoint-major, then
    row-major over the coarse grid patch_nums // level_patch_nums."""
    pn, lv = tuple(patch_nums), tuple(level_patch_nums)
    d = len(pn)
    ng = [pn[i] // lv[i] for i in range(d)]
    n_data = x.shape[0] // int(np.prod(ng))
    tail = tuple(x.shape[1:])
    split, full = [n_data], [n_data]
    for i in range(d):
        split += [ng[i], 1]
        full += [ng[i], lv[i]]
    y = x.reshape(*split, *tail).expand(*full, *tail)
    return y.reshape(n_data * int(np.prod(pn)), *tail)


Level = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (loc, scale, eps)


def sample_hierarchical_latents(
    loc: torch.Tensor, scale: torch.Tensor, eps: torch.Tensor, cfg: ModalityConfig,
    h: Optional[Level] = None, hh: Optional[Level] = None,
    part: Optional[Partition] = None,
) -> torch.Tensor:
    """Reparameterised sample of the INR weight latents, summed over the
    levels (``mappings.py:130-161``).

    loc/scale: (R, D); eps: (R, S, D) standard-normal noise. For a patch
    config, ``h`` and ``hh`` are each (loc, scale, eps) of levels 2 and 3,
    with R / prod(level{2,3}_patch_nums) rows, broadcast over their patches.
    ``part`` is the rows' layout: a level split with w is broadcast over
    this rank's patches, one kept whole over every patch, and this rank's
    rows are kept. The noise is passed in so that the caller owns the
    generator. Returns (R, S, D)."""
    out = loc[:, None, :] + scale[:, None, :] * eps
    if not cfg.patch:
        return out
    pn = local_patch_nums(cfg, part)
    for name, level, lv in (("h", h, cfg.level2_patch_nums), ("hh", hh, cfg.level3_patch_nums)):
        l_loc, l_scale, l_eps = level
        x = l_loc[:, None, :] + l_scale[:, None, :] * l_eps
        if is_sharded(part) and not is_sharded(part.level(name)):
            out = out + local_rows(expand_level(x, cfg.patch_nums, lv), part)
        else:
            out = out + expand_level(x, pn, lv)
    return out
