"""Video loading and preprocessing (UCF-101: 24 frames, centre crop 240,
resize to 128, /255), a copy of ``recombiner_tpu/data/video.py``. Clips are
stored channel-last (T, H, W, C); the reference's pickled channel-first
clips load too. torchvision is imported only by
``process_video_datasets``' default decoder."""

from __future__ import annotations

import pickle
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from recombiner_tpu_torch.config import ModalityConfig
from recombiner_tpu_torch.data.pipeline import points_from_data

N_FRAMES = 24
CROP = 240
SIZE = 128


def preprocess_clip(video_thwc: np.ndarray) -> Optional[np.ndarray]:
    """(T, H, W, C) frames -> (24, 128, 128, C) float32 in [0, 1], or None
    when a frame is smaller than the crop: the first 24 frames, a centre
    crop of 240, an antialiased bilinear resize to 128 (as torchvision's
    Resize does on tensors), /255."""
    video = torch.as_tensor(np.asarray(video_thwc)).permute([0, 3, 1, 2])[:N_FRAMES]
    if video.shape[-1] < CROP or video.shape[-2] < CROP:
        return None
    h0 = (video.shape[-2] - CROP) // 2
    w0 = (video.shape[-1] - CROP) // 2
    video = video[..., h0 : h0 + CROP, w0 : w0 + CROP].float()
    video = torch.nn.functional.interpolate(video, size=(SIZE, SIZE), mode="bilinear",
                                            align_corners=False, antialias=True)
    clip = video.numpy().astype(np.float32) / 255.0  # (T, C, H, W)
    return np.moveaxis(clip, 1, -1)


def process_video_datasets(train_paths, test_paths, save_dir: str, decode_fn=None) -> None:
    """Preprocess clips and write ``test_dataset.npz`` and
    ``train_dataset.npz`` under ``save_dir``. ``decode_fn(path)`` returns a
    (T, H, W, C) frame array; the default is torchvision's video reader."""
    if decode_fn is None:

        def decode_fn(p):
            from torchvision import io

            return io.read_video(p)[0].numpy()

    def process(paths):
        out = []
        for p in paths:
            clip = preprocess_clip(decode_fn(p))
            if clip is not None:
                out.append(clip)
        return out

    np.savez(save_dir + "/test_dataset.npz", *process(test_paths))
    np.savez(save_dir + "/train_dataset.npz", *process(train_paths))


def load_clip_list(path: str) -> List[np.ndarray]:
    """Clips (T, H, W, C) from an ``.npz`` dump, or from a ``.pkl`` of
    the reference's (T, C, H, W) tensors."""
    if path.endswith(".npz"):
        z = np.load(path)
        return [z[k] for k in z.files]
    with open(path, "rb") as f:
        tensors = pickle.load(f)
    out = []
    for t in tensors:
        arr = t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)
        if arr.shape[-1] not in (1, 3):
            arr = np.moveaxis(arr, 1, -1)
        out.append(arr.astype(np.float32))
    return out


def load_video(clips: Sequence[np.ndarray], cfg: ModalityConfig) -> Tuple[np.ndarray, np.ndarray]:
    return points_from_data([np.asarray(c, np.float32) for c in clips], cfg)
