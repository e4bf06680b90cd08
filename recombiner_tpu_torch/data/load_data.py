"""Test-set loading, a copy of the test half of
``recombiner_tpu/data/load_data.py``: one ``test_idx`` selects a fixed
slice of the reference's test batches (cifar: 500 images per ``test_idx``;
kodak, audio, video: one datapoint; protein: 1,000 chains) from a sorted
directory of images, or from a ``test_dataset.npz`` (else ``.pkl``) of
clips or chains."""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from recombiner_tpu_torch.config import ModalityConfig
from recombiner_tpu_torch.data import audio, image, protein, video

TEST_BATCH = {"cifar": 500, "kodak": 1, "audio": 1, "video": 1, "protein": 1000}


def _dataset_file(dir_: str, stem: str) -> str:
    for ext in (".npz", ".pkl"):
        p = os.path.join(dir_, stem + ext)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"no {stem}.npz/.pkl in {dir_}")


def _image_paths(dir_: str) -> List[str]:
    return [os.path.join(dir_, f) for f in sorted(os.listdir(dir_))]


def load_test_set(test_dir: str, test_idx: int,
                  cfg: ModalityConfig) -> Tuple[np.ndarray, np.ndarray]:
    """(X, Y) of the test batch ``test_idx``."""
    name = cfg.name
    b = TEST_BATCH.get(name, 1)
    lo, hi = test_idx * b, test_idx * b + b
    if name == "audio":
        clips = audio.load_clip_list(_dataset_file(test_dir, "test_dataset"))[lo:hi]
        return audio.load_audio(clips, cfg)
    if name == "video":
        clips = video.load_clip_list(_dataset_file(test_dir, "test_dataset"))[lo:hi]
        return video.load_video(clips, cfg)
    if name == "protein":
        chains = protein.load_chain_list(_dataset_file(test_dir, "test_dataset"))[lo:hi]
        return protein.load_protein(chains, cfg)
    # image-style datasets (cifar, kodak and the test configs): a directory of files
    return image.load_images(_image_paths(test_dir)[lo:hi], cfg)
