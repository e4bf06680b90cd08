"""Read a reference-format prior checkpoint (the 8-dump pickle that the
reference's ``main_prior_training.py:283-341`` writes) into the port's
``PriorArtifact``: the port's copy of ``recombiner_tpu/io/convert_reference.py``,
with the same mapping, so both packages read one pickle to equal artifacts.

Unpickling the two module dumps needs the reference's own ``prior_model``
classes on ``sys.path`` (pass ``reference_path``). Host code only: the
tensors in the pickle are read to numpy.

Mapping:
- the pickle holds the priors in PARAM order and natural-scale form, as
  the artifact does;
- conv weights go from torch's (out, in, *k) to the artifact's channel-last
  (*k, in, out) (``io/convert.py::conv_weight_from_torch``); the
  ``LinearTransform`` matrices carry over unchanged (both apply
  ``latent @ A``);
- the pickle's groupings are taken verbatim.
"""

from __future__ import annotations

import contextlib
import pickle
import sys
from typing import Optional

import numpy as np

from recombiner_tpu_torch.config import ModalityConfig, get_config
from recombiner_tpu_torch.io.checkpoint import LevelArtifact, PriorArtifact
from recombiner_tpu_torch.io.convert import conv_weight_from_torch
from recombiner_tpu_torch.priors.grouping import Grouping


@contextlib.contextmanager
def reference_on_path(reference_path: Optional[str]):
    """``reference_path`` at the front of ``sys.path`` for the duration (its
    ``prior_model`` module resolves the pickled classes)."""
    added = bool(reference_path) and reference_path not in sys.path
    if added:
        sys.path.insert(0, reference_path)
    try:
        yield
    finally:
        if added and reference_path in sys.path:
            sys.path.remove(reference_path)


def _grouping_from_tuple(t) -> Grouping:
    (group_idx, group_start, group_end, group2param, param2group,
     n_groups, group_kls, weights) = t
    return Grouping(
        n_groups=int(n_groups),
        group_start=np.asarray(group_start, np.int32),
        group_end=np.asarray(group_end, np.int32),
        group_idx=np.asarray(group_idx, np.int32),
        param2group=np.asarray(param2group, np.int32),
        group2param=np.asarray(group2param, np.int32),
        group_kls=np.asarray(group_kls, np.float64),
        weights=np.asarray(weights, np.float64),
    )


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _level(grouping, dump) -> LevelArtifact:
    p_loc, p_scale, _, avg_log_scale = dump
    return LevelArtifact(p_loc=_np(p_loc).astype(np.float32),
                         p_scale=_np(p_scale).astype(np.float32),
                         avg_log_scale=_np(avg_log_scale).astype(np.float32),
                         grouping=_grouping_from_tuple(grouping))


def convert_reference_checkpoint(pickle_path: str, dataset: str,
                                 reference_path: Optional[str] = None,
                                 codebook_seed: int = 42) -> PriorArtifact:
    """The artifact of the reference pickle at ``pickle_path``, for the
    config named ``dataset``."""
    cfg: ModalityConfig = get_config(dataset)
    with reference_on_path(reference_path), open(pickle_path, "rb") as f:
        dumps = [pickle.load(f) for _ in range(8)]
    g_w, p_w, g_h, p_h, g_hh, p_hh, linear_transform, upsample_net = dumps
    up = {}
    for i in range(3):
        conv = getattr(upsample_net, f"conv{i + 1}")
        up[f"conv{i}"] = {"w": conv_weight_from_torch(_np(conv.weight)).astype(np.float32),
                          "b": _np(conv.bias).astype(np.float32)}
    return PriorArtifact(
        config=cfg,
        kl_beta=float(p_w[2]),
        w=_level(g_w, p_w),
        h=_level(g_h, p_h) if cfg.patch else None,
        hh=_level(g_hh, p_hh) if cfg.patch else None,
        A=[_np(a).astype(np.float32) for a in linear_transform.A],
        up=up,
        codebook_seed=codebook_seed,
    )
