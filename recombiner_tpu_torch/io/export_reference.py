"""Write a ``PriorArtifact`` as a reference-format prior checkpoint (the
8-dump pickle that the reference's ``main_prior_training.py:283-341``
writes and its ``main_compression.py:37-45`` reads): the inverse of
``io/convert_reference.py``, and the port's copy of
``recombiner_tpu/io/export_reference.py``, which writes the same pickle.

The two module dumps are instances of the reference's own
``prior_model.LinearTransform`` and ``prior_model.Upsample``, so the
reference package must be importable (pass ``reference_path``). Host code
only: every tensor is made on the CPU.

Mapping (the inverse of ``convert_reference``): priors in PARAM order and
natural-scale form; groupings re-emitted as the reference's 8-tuple; the
A matrices unchanged; conv weights from the artifact's (*k, in, out) to
torch's (out, in, *k) (``io/convert.py::conv_weight_to_torch``).
"""

from __future__ import annotations

import pickle
from typing import Optional

import numpy as np
import torch

from recombiner_tpu_torch.io.checkpoint import LevelArtifact, PriorArtifact
from recombiner_tpu_torch.io.convert import conv_weight_to_torch
from recombiner_tpu_torch.io.convert_reference import reference_on_path
from recombiner_tpu_torch.priors.grouping import Grouping


def _grouping_tuple(g: Grouping):
    """A ``Grouping`` -> the reference's 8-tuple (prior_model.py:273-299)."""
    return (np.asarray(g.group_idx), np.asarray(g.group_start), np.asarray(g.group_end),
            np.asarray(g.group2param), np.asarray(g.param2group), int(g.n_groups),
            np.asarray(g.group_kls), np.asarray(g.weights))


def _level_dumps(lv: Optional[LevelArtifact], kl_beta: float):
    """(grouping tuple, (p_loc, p_scale, kl_beta, avg_log_scale)) of one
    level; an absent level is the reference's rows of None."""
    if lv is None:
        return (None,) * 8, (None, None, kl_beta, None)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    return _grouping_tuple(lv.grouping), (f32(lv.p_loc), f32(lv.p_scale), kl_beta,
                                          f32(lv.avg_log_scale))


def export_reference_checkpoint(artifact: PriorArtifact, pickle_path: str,
                                reference_path: Optional[str] = None) -> str:
    """Write ``artifact`` to ``pickle_path`` in the reference's format;
    returns the path."""
    with reference_on_path(reference_path):
        from prior_model import LinearTransform, Upsample

    cfg = artifact.config
    lt = LinearTransform(list(cfg.net_dims))
    # the reference's Upsample(kernel_dim, paddings, layerwise_scale_factors):
    # conv1..conv3, 128 -> 64 (k5), 64 -> 64 (k3), 64 -> 16 (k3)
    up = Upsample(cfg.data_dim, list(cfg.paddings), list(cfg.layerwise_scale_factors))
    with torch.no_grad():
        for i, a in enumerate(artifact.A):
            lt.A[i].data = torch.from_numpy(np.asarray(a, np.float32))
        for i in range(3):
            conv = getattr(up, f"conv{i + 1}")
            w = np.asarray(artifact.up[f"conv{i}"]["w"], np.float32)
            conv.weight.data = torch.from_numpy(np.ascontiguousarray(conv_weight_to_torch(w)))
            conv.bias.data = torch.from_numpy(np.asarray(artifact.up[f"conv{i}"]["b"],
                                                         np.float32))
    beta = float(artifact.kl_beta)
    dumps = [*_level_dumps(artifact.w, beta), *_level_dumps(artifact.h, beta),
             *_level_dumps(artifact.hh, beta), lt, up]
    with open(pickle_path, "wb") as f:  # the dump order of main_prior_training.py:283-341
        for d in dumps:
            pickle.dump(d, f)
    return pickle_path
