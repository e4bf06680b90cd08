"""Test-set loading, the image branch of ``recombiner_tpu/data/load_data.py``:
one ``test_idx`` selects a fixed slice of a sorted directory of images, in
the reference's test batches (cifar: 500 images per ``test_idx``,
kodak: one image, 96 patch rows)."""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from recombiner_tpu_torch.config import ModalityConfig
from recombiner_tpu_torch.data import image

TEST_BATCH = {"cifar": 500, "kodak": 1, "audio": 1, "video": 1, "protein": 1000}


def _image_paths(dir_: str) -> List[str]:
    return [os.path.join(dir_, f) for f in sorted(os.listdir(dir_))]


def load_test_set(test_dir: str, test_idx: int,
                  cfg: ModalityConfig) -> Tuple[np.ndarray, np.ndarray]:
    """(X, Y) of the test batch ``test_idx``."""
    if cfg.name in ("audio", "video", "protein"):
        raise NotImplementedError(f"{cfg.name} data is not ported yet (ROADMAP.md, port "
                                  "queue: audio, video and protein configs)")
    b = TEST_BATCH.get(cfg.name, 1)
    return image.load_images(_image_paths(test_dir)[test_idx * b : test_idx * b + b], cfg)
