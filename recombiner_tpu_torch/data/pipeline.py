"""Channel-last datum -> (X, Y) point sets, the non-patch half of
``recombiner_tpu/data/pipeline.py``: Fourier-embedded grid coordinates plus
per-point features."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from recombiner_tpu_torch.config import ModalityConfig
from recombiner_tpu_torch.coords import grid_fourier_features


def points_from_datum(datum: np.ndarray, cfg: ModalityConfig) -> Tuple[np.ndarray, np.ndarray]:
    """datum: (*spatial, C) channel-last -> X (1, P, fourier_dim), Y (1, P, C)."""
    if cfg.patch:
        raise NotImplementedError("patch configs are not ported yet (ROADMAP.md, port "
                                  "queue: patch / kodak_mini)")
    feats = grid_fourier_features(cfg.pixel_sizes, cfg.fourier_dim)
    Y = datum.reshape(1, feats.shape[0], cfg.output_dim)
    return feats[None].astype(np.float32), Y.astype(np.float32)


def points_from_data(data: Sequence[np.ndarray],
                     cfg: ModalityConfig) -> Tuple[np.ndarray, np.ndarray]:
    Xs: List[np.ndarray] = []
    Ys: List[np.ndarray] = []
    for datum in data:
        x, y = points_from_datum(np.asarray(datum), cfg)
        Xs.append(x)
        Ys.append(y)
    return np.concatenate(Xs), np.concatenate(Ys)
