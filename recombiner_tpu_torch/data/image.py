"""Image loading (CIFAR, Kodak): PNG -> [0, 1] channel-last, landscape layout, a copy
of ``recombiner_tpu/data/image.py``. PIL is imported where an image is read,
so the package imports without it."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from recombiner_tpu_torch.config import ModalityConfig
from recombiner_tpu_torch.data.pipeline import points_from_data


def read_image(path: str) -> np.ndarray:
    """(H, W, C) float32 in [0, 1], rotated to landscape (W >= H)."""
    from PIL import Image

    img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    if img.shape[0] > img.shape[1]:
        img = np.transpose(img, (1, 0, 2))
    return img


def load_images(paths: Sequence[str], cfg: ModalityConfig) -> Tuple[np.ndarray, np.ndarray]:
    data: List[np.ndarray] = [read_image(p) for p in paths]
    return points_from_data(data, cfg)
