"""Distortion metrics: PSNR (with 8-bit rounding) and protein RMSD, a copy of
``recombiner_tpu/metrics.py`` (numpy on the host; they run on final
reconstructions only), with its modality dispatch and de-normalisation
conventions (x25 scale and xyz-sum for protein).
"""

from __future__ import annotations

import numpy as np


def psnr(original: np.ndarray, compressed: np.ndarray, round8: bool, max_value: float = 1.0) -> float:
    """PSNR over the whole array (utils.py:234-242)."""
    if round8:
        compressed = np.round(np.clip(compressed, 0, 1) * 255) / 255
    mse = np.mean((original - compressed) ** 2)
    return float(20 * np.log10(max_value / np.sqrt(mse)))


def batch_psnr(
    original: np.ndarray, compressed: np.ndarray, round8: bool, max_value: float = 1.0
) -> np.ndarray:
    """Per-row PSNR (utils.py:245-254)."""
    n = original.shape[0]
    if round8:
        compressed = np.round(np.clip(compressed, 0, 1) * 255) / 255
    mse = np.mean(
        (original.reshape(n, -1) - compressed.reshape(n, -1)) ** 2, axis=-1
    )
    return 20 * np.log10(max_value / np.sqrt(mse))


def batch_rmsd(original: np.ndarray, compressed: np.ndarray, scale_factor: float = 25.0) -> np.ndarray:
    """Per-row RMSD with de-normalization; mse summed over xyz, i.e. x3
    (utils.py:257-260)."""
    n = original.shape[0]
    sq = ((original * scale_factor - compressed * scale_factor) ** 2).reshape(n, -1)
    return (sq.mean(-1) * 3) ** 0.5


# Modalities whose PSNR is reported WITHOUT 8-bit rounding (utils.py:211):
# their operating points reach 50-70 dB, where reconstruction differences
# of ~1e-4 RMS — e.g. rendering at a different matmul precision than the
# finetunes optimized through — are visible in the reported number instead
# of being masked by the 1/255 quantizer (docs/HEAD_TO_HEAD.md round 5).
UNROUNDED_PSNR = ("audio", "audio_mini", "tiny_audio")


def metric(original: np.ndarray, compressed: np.ndarray, dataset: str):
    """Modality dispatch (utils.py:200-213). cifar/protein return per-row
    arrays; kodak/video/audio a scalar."""
    if dataset in ("cifar", "tiny", "tiny_patch"):
        return batch_psnr(original, compressed, round8=True)
    if dataset in ("kodak", "kodak_mini", "video", "tiny_video"):
        return psnr(original, compressed, round8=True)
    if dataset in UNROUNDED_PSNR:
        return psnr(original, compressed, round8=False)
    if dataset == "protein":
        return batch_rmsd(original, compressed, scale_factor=25.0)
    raise ValueError(dataset)
