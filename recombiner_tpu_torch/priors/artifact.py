"""A prior artifact from a trained ``PriorState``, a copy of
``recombiner_tpu/priors/artifact.py``: training-average raw log scales, a
KL grouping per level, the priors in parameter order, the A matrices and
the conv stack's parameters back in the artifact's (*k, I, O) layout, so
that the JAX package loads what the port writes.

The grouping weights are computed on the host from the posteriors moved
there: the scales through the port's ``scale_transform`` on the CPU, then
numpy, wherever the state was trained, so that a probe
(``trainer.realized_bitrate``) and the built artifact count the same
groups. A data-parallel state is gathered first (every rank must call):
the artifact and every probe see all rows, on every rank. torch's
softplus and the JAX package's differ by an ulp on a few percent of f32
inputs; a level whose greedy packing sits within about 1e-7
of a 16-bit boundary could split differently in the two packages
(``ROADMAP.md``, queue 3).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from recombiner_tpu_torch.config import ModalityConfig
from recombiner_tpu_torch.io.checkpoint import LevelArtifact, PriorArtifact
from recombiner_tpu_torch.io.convert import conv_weight_from_torch
from recombiner_tpu_torch.models.gaussian import scale_transform
from recombiner_tpu_torch.priors.grouping import grouping_from_posteriors
from recombiner_tpu_torch.priors.trainer import Priors, PriorState

# per level: (q_loc, q_log_scale_raw, p_loc, p_scale), host numpy, rows
# leading on the q mats
LevelMats = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _level_raw_mats(state: PriorState, priors: Priors,
                    cfg: ModalityConfig) -> Dict[str, LevelMats]:
    """Level 1 ("w") is the INR weight latents and the flattened LPEs,
    grouped jointly (main_prior_training.py:198-212); a patch config adds
    h and hh. The rows of every rank (a collective when they are sharded:
    every rank builds from the same gathered state)."""
    state = state.gathered()
    R = state.w.loc.shape[0]
    out = {"w": (
        np.concatenate([_np(state.w.loc), _np(state.lpe.loc).reshape(R, -1)], -1),
        np.concatenate([_np(state.w.log_scale), _np(state.lpe.log_scale).reshape(R, -1)], -1),
        np.concatenate([_np(priors.w.loc), _np(priors.lpe.loc).reshape(-1)]),
        np.concatenate([_np(priors.w.scale), _np(priors.lpe.scale).reshape(-1)]),
    )}
    if cfg.patch:
        for name in ("h", "hh"):
            g, pg = getattr(state, name), getattr(priors, name)
            out[name] = (_np(g.loc), _np(g.log_scale), _np(pg.loc), _np(pg.scale))
    return out


def _scales(q_raw: np.ndarray) -> np.ndarray:
    return scale_transform(torch.from_numpy(q_raw)).numpy()


def level_posterior_mats(state: PriorState, priors: Priors,
                         cfg: ModalityConfig) -> Dict[str, LevelMats]:
    """Per level (q_loc, q_scale, p_loc, p_scale) as ``grouping_from_posteriors``
    takes them: the shared input of ``build_prior_artifact`` and the rate
    probe."""
    return {name: (ql, _scales(qr), pl, ps)
            for name, (ql, qr, pl, ps) in _level_raw_mats(state, priors, cfg).items()}


def build_prior_artifact(state: PriorState, priors: Priors, kl_beta: float,
                         cfg: ModalityConfig, codebook_seed: int = 42) -> PriorArtifact:
    def level(mats: LevelMats) -> LevelArtifact:
        q_loc, q_raw, p_loc, p_scale = mats
        return LevelArtifact(
            p_loc=p_loc, p_scale=p_scale, avg_log_scale=q_raw.mean(0),
            grouping=grouping_from_posteriors(q_loc, _scales(q_raw), p_loc, p_scale,
                                              max_bits=cfg.bits_per_group))

    raw = _level_raw_mats(state, priors, cfg)
    return PriorArtifact(
        config=cfg,
        kl_beta=float(kl_beta),
        w=level(raw["w"]),
        h=level(raw["h"]) if cfg.patch else None,
        hh=level(raw["hh"]) if cfg.patch else None,
        A=[_np(a) for a in state.A],
        up={c: {"w": conv_weight_from_torch(_np(v["w"])), "b": _np(v["b"])}
            for c, v in state.up.items()},
        codebook_seed=codebook_seed,
    )
