"""Optional tensor parallelism: column-sharded A-transforms, the
counterpart of ``recombiner_tpu/parallel/tp.py`` on ``torch.distributed``.

The only weight matrices worth sharding are the per-layer linear transforms
A_l (1056² x3 and 99² for CIFAR); everything else is per-datapoint state
that shards over the data axis. Each A_l's OUTPUT columns are split over
the ranks of a "model" group: every rank holds the full latent rows of its
data block and a 1/tp column slice of A_l, computes its (rows, d_l / tp)
product, and one tiled all-gather over the model group reassembles the
output. As in the JAX package this is forward only, and a library function
that no CLI runs: at CIFAR's size A is about 3.4 M parameters, so it is a
memory corner, not a speed-up (``tp.py:13-17`` of the JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch

from recombiner_tpu_torch.config import ModalityConfig
from recombiner_tpu_torch.models.inr import latent_to_weights, slice_layer
from recombiner_tpu_torch.parallel.mesh import Mesh, Partition, all_gather, grid_groups


@dataclasses.dataclass(frozen=True)
class TPMesh:
    """A (data, model) grid of ``dp x tp`` ranks, rank = d * tp + m."""

    dp: int
    tp: int
    data: Mesh  # this rank within the ranks of its model index
    model: Mesh  # this rank within the ranks of its data block

    def __deepcopy__(self, memo):
        return self


def make_mesh_tp(dp: int, tp: int) -> TPMesh:
    """(data, model) mesh: posterior rows over ``dp`` ranks, A columns over
    ``tp``. Every rank of the default group must call it."""
    g_data, g_model, d, m = grid_groups(dp, tp)
    return TPMesh(dp, tp, data=Mesh(dp, d, g_data), model=Mesh(tp, m, g_model))


def data_partition(mesh: TPMesh, n_rows: int) -> Partition:
    """The rows' layout over the data axis (one row per datapoint)."""
    return Partition(mesh.data, n_rows, mesh.dp > 1)


def _sharded(a: torch.Tensor, tp: int) -> bool:
    return a.shape[1] * tp == a.shape[0] and tp > 1


def shard_A(A: Sequence[torch.Tensor], mesh: TPMesh) -> List[torch.Tensor]:
    """This rank's column block of each A_l, where its output dim divides by
    the TP degree; the others (the output layer's, three orders of
    magnitude smaller than the hidden layers') whole."""
    tp, m = mesh.tp, mesh.model.rank
    out = []
    for a in A:
        if a.shape[1] % tp == 0:
            c = a.shape[1] // tp
            out.append(a[:, m * c:(m + 1) * c].contiguous())
        else:
            out.append(a)
    return out


def tp_matmul(lat: torch.Tensor, A_l: torch.Tensor, mesh: TPMesh) -> torch.Tensor:
    """(..., d) @ (d, d) with A_l's columns split over the model group: the
    local product, then one all-gather in rank order, concatenated along
    the last axis (tiled), bitwise the same on every model rank."""
    y = lat @ A_l
    return torch.cat(all_gather(y, mesh.model), dim=-1)


def tp_inr_forward(x: torch.Tensor, h_w: torch.Tensor, A: Sequence[torch.Tensor],
                   cfg: ModalityConfig, mesh: TPMesh) -> torch.Tensor:
    """``models/inr.py::inr_forward`` with every sharded latent @ A_l over the
    model group (``shard_A``'s blocks; a whole A_l multiplies locally). The
    per-layer x @ W + b stays local: W is per (row, sample), not shared."""
    dims = cfg.net_dims
    cum = cfg.cum_param_sizes
    for idx in range(cfg.n_layers):
        lat = slice_layer(h_w, idx, cum)
        if _sharded(A[idx], mesh.tp):
            lat = tp_matmul(lat, A[idx], mesh)
        else:
            lat = lat @ A[idx]
        w, b = latent_to_weights(lat, dims[idx], dims[idx + 1])
        x = torch.einsum("rspi,rsio->rspo", x, w) + b[:, :, None, :]
        if idx != cfg.n_layers - 1:
            x = torch.sin(cfg.w0 * x)
    return x
