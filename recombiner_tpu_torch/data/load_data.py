"""Dataset loading, a copy of ``recombiner_tpu/data/load_data.py``: a
seeded random subset of whole datapoints for prior training, and fixed test
slices: one ``test_idx`` selects a slice of the reference's test batches
(cifar: 500 images per ``test_idx``; kodak, audio, video: one datapoint;
protein: 1,000 chains). Images come from a sorted directory of files;
audio and video clips and protein chains from a ``train_dataset`` or
``test_dataset`` ``.npz`` (else ``.pkl``)."""

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


def _seeded_subset(items: List, seed: int, n: int) -> List:
    """min(n, len(items)) items drawn without replacement by
    ``RandomState(seed)``: the JAX package's subset for the same seed."""
    rng = np.random.RandomState(seed)
    n = min(len(items), n)
    idx = rng.choice(len(items), n, False)
    return [items[i] for i in idx]


def _image_paths(dir_: str) -> List[str]:
    return [os.path.join(dir_, f) for f in sorted(os.listdir(dir_))]


def load_training_set(train_dir: str, cfg: ModalityConfig, seed: int,
                      n_datapoints: int) -> Tuple[np.ndarray, np.ndarray]:
    """(X, Y) of a seeded random subset of ``n_datapoints`` whole datapoints;
    rows = datapoints x patches_per_datapoint."""
    name = cfg.name
    if name == "audio":
        clips = audio.load_clip_list(_dataset_file(train_dir, "train_dataset"))
        return audio.load_audio(_seeded_subset(clips, seed, n_datapoints), cfg)
    if name == "video":
        clips = video.load_clip_list(_dataset_file(train_dir, "train_dataset"))
        return video.load_video(_seeded_subset(clips, seed, n_datapoints), cfg)
    if name == "protein":
        chains = protein.load_chain_list(_dataset_file(train_dir, "train_dataset"))
        return protein.load_protein(_seeded_subset(chains, seed, n_datapoints), cfg)
    # image-style datasets (cifar, kodak and the test configs): a directory of files
    return image.load_images(_seeded_subset(_image_paths(train_dir), seed, n_datapoints), cfg)


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
