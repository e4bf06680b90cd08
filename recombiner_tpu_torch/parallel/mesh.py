"""Data-parallel layout over ``torch.distributed``, the counterpart of
``recombiner_tpu/parallel/mesh.py``.

The JAX package shards the posterior rows over a 1-D ``("data",)`` mesh and
lets GSPMD insert the all-reduces and the halo of the stitched conv canvas.
Torch tensors carry no layout, so here the layout is an object beside them,
one per group of per-datapoint tensors (a state's posteriors with its X and
Y), as a ``NamedSharding`` is one per array:

- a ``Mesh`` is the ranks (world size, this rank, the process group);
- a ``Partition`` says how one group lies over them, level by level. The
  rows of w (and of X and Y) lie in contiguous datapoint-major blocks, one
  per rank (``sharded``), or whole on every rank. Without a config
  (training, CIFAR, protein) the unit is a whole datapoint: its rows are
  split when the datapoint count divides by the world size, else every
  rank holds everything, JAX's ``shard_rows`` rule (``mesh.py:72-85``), so
  no rank is ever empty (a CUDA launch of B = 0 is invalid). A patch
  config's encode (``partition(mesh, n, cfg)``) also splits ONE
  datapoint's patch rows: each rank then holds whole slabs of the
  datapoint's canvas along its first patch axis with more than one patch
  (``Slab``), and the conv stack exchanges a halo of latent rows with the
  neighbouring slabs (``parallel/halo.py``). An upper level (h, hh) is
  split with w where the rank's h rows are exactly those that cover its w
  rows, else whole on every rank (``whole``): each rank broadcasts its
  slice and the level's gradient is the rank-ordered sum of every rank's
  part. A patch config's coded rows mix the physical rows of every
  datapoint (``decoder.patch_permutations``), so the per-coded-row fields
  of w and h (``kl_beta``, ``compressed``, ``indices``) stay whole on every
  rank (``coded_whole``), and the coding steps gather the posteriors;
- the shared tensors (the A matrices, the conv stack, the priors and the
  codec) are whole on every rank.

The layout is decided once, by ``partition``, and never changes in a run.

Collectives: every sum of shared gradients, moments and scalars is an
``all_gather`` and a sum in rank order (``ordered_sum``), never a bare
``all_reduce``, so every rank holds bitwise the same shared weights, a run
repeats bit for bit and no result depends on the backend's algorithm. A
replicated group is never summed. Gloo moves CUDA tensors through host
memory; here that copy is explicit (``all_gather``).
"""

from __future__ import annotations

import dataclasses
import math
from fractions import Fraction
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of a run: ``world`` processes, this one ``rank``;
    ``group`` None is the default group."""

    world: int = 1
    rank: int = 0
    group: Any = None

    def __deepcopy__(self, memo):  # a process group is not copied
        return self


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The 1-D data mesh of this process group (``launch.spawn_if_needed``
    or a launcher started it): every rank, or one rank with no group.
    ``n_devices`` other than the group's size raises."""
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"--n_devices {n_devices} needs {n_devices} processes: start them "
                             "with the CLI, torchrun or RECOMBINER_TPU_MULTIHOST=1")
        return Mesh()
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"--n_devices {n_devices} requested in a group of {world} processes")
    return Mesh(world, dist.get_rank())


@dataclasses.dataclass(frozen=True)
class Slab:
    """One datapoint's patch rows split over ``count`` consecutive ranks:
    each holds ``per_rank`` patches along patch axis ``axis`` (with every
    patch of the later axes; the earlier axes have one patch), this rank the
    ``index``-th slab. ``halo`` latent rows of the canvas are exchanged at
    each internal edge."""

    axis: int
    per_rank: int
    index: int
    count: int
    halo: int

    @property
    def has_prev(self) -> bool:
        return self.index > 0

    @property
    def has_next(self) -> bool:
        return self.index < self.count - 1


@dataclasses.dataclass(frozen=True)
class Partition:
    """How one group of per-datapoint tensors lies over ``mesh``: ``n_data``
    datapoints (global). When ``sharded``, every level's rows lie in
    contiguous datapoint-major blocks of 1 / world of them per rank, rank r
    the rows ``block(n)`` of a level of ``n`` global rows, but the levels in
    ``whole``, which every rank holds whole; else everything is whole on
    every rank. The coded-row fields of the levels in ``coded_whole`` are
    whole on every rank too. ``slab`` is set when one datapoint's rows are
    split over several ranks; ``reason`` says why the layout is what it
    is."""

    mesh: Mesh
    n_data: int
    sharded: bool
    whole: Tuple[str, ...] = ()
    coded_whole: Tuple[str, ...] = ()
    slab: Optional[Slab] = None
    reason: str = dataclasses.field(default="", compare=False)

    def block(self, n_rows: int) -> slice:
        if not self.sharded:
            return slice(0, n_rows)
        per = n_rows // self.mesh.world
        return slice(self.mesh.rank * per, (self.mesh.rank + 1) * per)

    def global_rows(self, n_local: int) -> int:
        return n_local * self.mesh.world if self.sharded else n_local

    def level(self, name: str) -> "Partition":
        """The layout of level ``name``'s physical rows (posteriors, frozen
        cells, noise): this one, or whole on every rank."""
        if self.sharded and name in self.whole:
            return Partition(self.mesh, self.n_data, False)
        return self

    def coded(self, name: str) -> "Partition":
        """The layout of level ``name``'s coded rows (``kl_beta``,
        ``compressed``, ``indices``)."""
        if self.sharded and name in self.coded_whole:
            return Partition(self.mesh, self.n_data, False)
        return self.level(name)

    def __deepcopy__(self, memo):
        return self


def halo_latents(cfg, axis: int) -> int:
    """Latent rows of halo that make a slab's pixels exact along ``axis``:
    the conv stack's reach from an output pixel back into the latent
    canvas, sum over layers of padding_i / (the product of the scale
    factors up to layer i), rounded up. Kodak: 2/4 + 1/8 + 1/16 -> 1."""
    reach, scale = Fraction(0), 1
    for f, p in zip(cfg.layerwise_scale_factors, cfg.paddings):
        scale *= f if isinstance(f, int) else f[axis]
        reach += Fraction(int(p), scale)
    return math.ceil(reach)


def _patch_layout(mesh: Mesh, n_data: int, cfg) -> Partition:
    """``partition`` of a patch config's encode."""
    W, ppd = mesh.world, cfg.patches_per_datapoint
    coded = ("w", "h")  # their coded rows mix the patch rows of every datapoint
    if n_data % W == 0:
        return Partition(mesh, n_data, True, coded_whole=coded,
                         reason=f"{n_data // W} whole datapoint(s) a rank")
    R = n_data * ppd

    def whole(why: str) -> Partition:
        return Partition(mesh, n_data, False, reason=why)

    if R % W:
        return whole(f"{R} patch rows do not divide by {W}")
    rows = R // W
    if ppd % rows:
        return whole(f"{rows} rows a rank split datapoints of {ppd} rows unevenly")
    pn = tuple(cfg.patch_nums)
    axis = next(i for i, n in enumerate(pn) if n > 1)
    unit = int(np.prod(pn[axis + 1:]))  # rows of one patch index along the axis
    if rows % unit:
        return whole(f"{rows} rows a rank are not whole slabs of {unit} rows along patch "
                     f"axis {axis}")
    per = rows // unit
    halo = halo_latents(cfg, axis)
    if per * cfg.lpe_spatial[axis] < halo:
        return whole(f"a slab of {per * cfg.lpe_spatial[axis]} latent rows is thinner than "
                     f"the conv stack's halo of {halo}")
    count = ppd // rows
    slab = Slab(axis=axis, per_rank=per, index=mesh.rank % count, count=count, halo=halo)
    upper = (("h", cfg.level2_patch_nums), ("hh", cfg.level3_patch_nums))
    kept = tuple(name for name, lv in upper if per % lv[axis])
    split = [name for name, _ in upper if name not in kept]
    return Partition(mesh, n_data, True, whole=kept, coded_whole=coded, slab=slab,
                     reason=(f"{per} of {pn[axis]} patches along axis {axis} a rank, "
                             f"a halo of {halo} latent row(s); w"
                             + "".join(f", {n}" for n in split) + " split"
                             + "".join(f", {n}" for n in kept) + (" whole" if kept else "")))


def partition(mesh: Mesh, n_data: int, cfg=None) -> Partition:
    """The layout of ``n_data`` datapoints over ``mesh``, decided once.

    Without ``cfg`` (training; every non-patch config) whole datapoints are
    sharded when their count divides by the world size, else replicated.
    With a patch config (an encode) the rows of w are also split when
    their count divides by the world size and each rank's rows are whole
    slabs of one datapoint's canvas along its first patch axis with more
    than one patch (Kodak's 96 rows at 2 or 4 ranks, not at 3); an upper
    level is split with them where its rows per rank cover whole slabs,
    else kept whole."""
    if mesh.world == 1:
        return Partition(mesh, int(n_data), False, reason="one rank")
    if cfg is not None and cfg.patch:
        return _patch_layout(mesh, int(n_data), cfg)
    ok = n_data % mesh.world == 0
    return Partition(mesh, int(n_data), ok,
                     reason=(f"{n_data // mesh.world} whole datapoint(s) a rank" if ok else
                             f"{n_data} datapoints do not divide by {mesh.world}"))


def is_sharded(part: Optional[Partition]) -> bool:
    return part is not None and part.sharded


def local_rows(t, part: Optional[Partition]):
    """This rank's rows of a global tensor or array (all of them when not
    sharded)."""
    if not is_sharded(part):
        return t
    return t[part.block(t.shape[0])]


def shard_rows(tree, part: Partition):
    """This rank's rows of every per-datapoint leaf: a tensor or array, a
    list or tuple of them, or a state with a ``shard_rows`` method
    (``PriorState``, ``CodecState``, which also records ``part``)."""
    if hasattr(tree, "shard_rows"):
        return tree.shard_rows(part)
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_rows(t, part) for t in tree)
    return local_rows(tree, part)


def replicate(tree, mesh: Mesh, n_data: int = 1):
    """``tree`` whole on every rank, its layout recorded as replicated."""
    return shard_rows(tree, Partition(mesh, n_data, False))


# ------------------------------------------------------------ collectives


def all_gather(t: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """``t`` of every rank of ``mesh`` in rank order (equal shapes). Gloo
    takes CUDA tensors only by staging them in host memory, so on gloo a
    CUDA tensor is copied to the host, gathered and copied back (exact).
    Bool tensors travel as uint8."""
    src = t.detach()
    dtype = src.dtype
    if dtype == torch.bool:
        src = src.to(torch.uint8)
    via_host = src.is_cuda and dist.get_backend(mesh.group) == "gloo"
    if via_host:
        src = src.cpu()
    src = src.contiguous()
    out = [torch.empty_like(src) for _ in range(mesh.world)]
    dist.all_gather(out, src, group=mesh.group)
    return [o.to(t.device).to(dtype) for o in out]


def sum_over(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``t`` over every rank of ``mesh``, in rank order: bitwise
    the same on every rank, whatever the backend's algorithms."""
    if mesh.world == 1:
        return t
    parts = all_gather(t, mesh)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def sum_all_over(ts: List[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """``sum_over`` of several tensors through one flat gather."""
    if mesh.world == 1 or not ts:
        return list(ts)
    flat = sum_over(torch.cat([t.reshape(-1) for t in ts]), mesh)
    out, at = [], 0
    for t in ts:
        out.append(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
    return out


def ordered_sum(t: torch.Tensor, part: Optional[Partition]) -> torch.Tensor:
    """The sum over the ranks of a sharded group (``sum_over``); ``t`` itself
    when the group is not sharded: a replicated tensor is never summed, and
    at world size 1 this is the identity."""
    return sum_over(t, part.mesh) if is_sharded(part) else t


def ordered_sum_all(ts: List[torch.Tensor], part: Optional[Partition]) -> List[torch.Tensor]:
    """``ordered_sum`` of several tensors through one flat gather."""
    return sum_all_over(ts, part.mesh) if is_sharded(part) else list(ts)


def gather_rows(t: torch.Tensor, part: Optional[Partition]) -> torch.Tensor:
    """Every rank's rows of a sharded tensor in rank order, on every rank;
    ``t`` when not sharded. Shards of unequal size are gathered too: the
    sizes first, then the rows padded to the largest."""
    if not is_sharded(part):
        return t
    mesh = part.mesh
    n = torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device)
    sizes = [int(s) for s in torch.cat(all_gather(n, mesh)).tolist()]
    top = max(sizes)
    src = t
    if t.shape[0] < top:
        src = torch.cat([t, t.new_zeros((top - t.shape[0], *t.shape[1:]))])
    return torch.cat([p[:s] for p, s in zip(all_gather(src, mesh), sizes)])


def global_max(x, part: Optional[Partition]):
    """The largest of each rank's ``x`` (a number)."""
    if not is_sharded(part):
        return x
    t = torch.tensor([float(x)], dtype=torch.float64)
    if dist.get_backend(part.mesh.group) == "nccl":
        t = t.cuda()
    return type(x)(max(float(v) for v in torch.cat(all_gather(t, part.mesh)).tolist()))


def global_any(x: bool, part: Optional[Partition]) -> bool:
    return bool(global_max(int(bool(x)), part))


# -------------------------------------------------------- the 2-D mesh


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """A (data, pixels) grid of ``dp x sp`` ranks, rank = d * sp + s: rows
    over ``data`` (the ranks of one pixel index form a data group), the
    coordinate grid over ``pixels`` (the ranks of one row block)."""

    dp: int
    sp: int
    data: Mesh  # this rank within its data group (same pixel index)
    pixels: Mesh  # this rank within its pixel group (same row block)
    world: Mesh  # every rank

    def __deepcopy__(self, memo):
        return self


def grid_groups(d0: int, d1: int):
    """(this rank's group along axis 0, along axis 1, its indices) of a
    ``d0 x d1`` rank grid, rank = i * d1 + j. Every rank creates every
    group, in one order, as ``dist.new_group`` requires."""
    rank = dist.get_rank()
    if dist.get_world_size() != d0 * d1:
        raise ValueError(f"a {d0} x {d1} grid needs {d0 * d1} ranks, the group has "
                         f"{dist.get_world_size()}")
    i, j = divmod(rank, d1)
    along0 = along1 = None
    for jj in range(d1):  # the ranks of one column: axis 0 varies
        g = dist.new_group([ii * d1 + jj for ii in range(d0)])
        if jj == j:
            along0 = g
    for ii in range(d0):  # the ranks of one row: axis 1 varies
        g = dist.new_group([ii * d1 + jj for jj in range(d1)])
        if ii == i:
            along1 = g
    return along0, along1, i, j


def make_mesh_2d(dp: int, sp: int) -> Mesh2D:
    """(data, pixels) mesh: rows over ``dp`` ranks, the coordinate grid (the
    framework's 'sequence' axis) over ``sp``. Each pixel rank computes the
    whole PE canvas of its rows and keeps its pixel slice; the SIREN
    kernels run on that slice (``trainer.sgd_epochs``)."""
    g_data, g_pix, i, j = grid_groups(dp, sp)
    return Mesh2D(dp, sp, data=Mesh(dp, i, g_data), pixels=Mesh(sp, j, g_pix),
                  world=Mesh(dp * sp, dist.get_rank()))


@dataclasses.dataclass(frozen=True)
class PixelPartition(Partition):
    """A ``Partition`` of rows over a 2-D mesh's data axis (``mesh`` is the
    data group) whose pixel axis is split over its pixel group too: this
    rank holds ``pixel_block(P)`` of every row's P pixels."""

    grid: Optional[Mesh2D] = None

    def pixel_block(self, n_pixels: int) -> slice:
        sp, j = self.grid.sp, self.grid.pixels.rank
        per = n_pixels // sp
        return slice(j * per, (j + 1) * per)


def pixel_partition(mesh: Mesh2D, n_data: int, n_pixels: int) -> PixelPartition:
    if n_data % mesh.dp or n_pixels % mesh.sp:
        raise ValueError(f"{n_data} datapoints and {n_pixels} pixels do not split over a "
                         f"{mesh.dp} x {mesh.sp} mesh")
    return PixelPartition(mesh.data, int(n_data), mesh.dp > 1, grid=mesh)


def shard_data_and_pixels(X: torch.Tensor, part: PixelPartition) -> torch.Tensor:
    """(R, P, F) grids with rows over the data axis and pixels over the
    pixel axis: this rank's block of both."""
    return local_rows(X, part)[:, part.pixel_block(X.shape[1])]
