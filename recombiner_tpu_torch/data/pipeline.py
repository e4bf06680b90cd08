"""Channel-last datum -> (X, Y) point sets, a copy of
``recombiner_tpu/data/pipeline.py``: Fourier-embedded grid coordinates plus
per-point features, split into non-overlapping patches for patch configs
(one row per patch, row-major over the patch grid)."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from recombiner_tpu_torch.config import ModalityConfig
from recombiner_tpu_torch.coords import grid_fourier_features, patchify


def points_from_datum(datum: np.ndarray, cfg: ModalityConfig) -> Tuple[np.ndarray, np.ndarray]:
    """datum: (*spatial, C) channel-last -> X (rows, P, fourier_dim), Y (rows,
    P, C); rows = 1, or ``patches_per_datapoint`` for a patch config."""
    feats = grid_fourier_features(cfg.pixel_sizes, cfg.fourier_dim)
    P = feats.shape[0]
    if cfg.patch:
        patches = patchify(datum, cfg.pixel_sizes)
        rows = patches.shape[0]
        Y = patches.reshape(rows, P, cfg.output_dim)
        X = np.broadcast_to(feats, (rows, P, cfg.fourier_dim))
    else:
        Y = datum.reshape(1, P, cfg.output_dim)
        X = feats[None]
    return X.astype(np.float32), Y.astype(np.float32)


def points_from_data(data: Sequence[np.ndarray],
                     cfg: ModalityConfig) -> Tuple[np.ndarray, np.ndarray]:
    Xs: List[np.ndarray] = []
    Ys: List[np.ndarray] = []
    for datum in data:
        x, y = points_from_datum(np.asarray(datum), cfg)
        Xs.append(x)
        Ys.append(y)
    return np.concatenate(Xs), np.concatenate(Ys)


def to_numpy_channel_last(t) -> np.ndarray:
    """A torch tensor (channel-first (C, *spatial), as the reference's pickled
    datasets store them) or a numpy array (channel-last, already the
    format) -> numpy channel-last."""
    if hasattr(t, "detach"):
        return np.moveaxis(t.detach().cpu().numpy(), 0, -1)
    return np.asarray(t)
